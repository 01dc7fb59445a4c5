// mont_mul: elementwise Montgomery product a*b*R^-1 mod p (R = 2^256) of
// limb tensors int32 [L=16, N] (16-bit limbs, limb-major planes).
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/pallas_field.py::
// _mul_kernel (called through mont_mul_pallas), which the reference
// dispatches for every mont_mul of 1024 elements or more: the Gao EEA and
// division steps, inv_mod's square-and-multiply, the scan matmul, the band
// builds of the MXU matmuls and the triple path's extraction band.
//
// What bounds it on an H100: bytes. Each element reads 2 x 64 bytes and
// writes 64; the function needs about 8 x 8 x 2 multiply-adds for the
// product and as many for the reduction on 32-bit words, far below the
// memory time at any size the port uses.
//
// Design: one thread per element. Limb plane j of an operand is a row of N
// int32, so neighbouring threads read and write neighbouring addresses in
// every plane. The 16 limbs become 8 words of 32 bits and go through the
// 32-bit-word CIOS of mont32.cuh (one conditional subtract), then back to
// 16 limbs: the canonical residue is the same word for word as the
// reference's 16-bit carry-save CIOS. Broadcasting is the caller's: the
// wrapper materializes both operands at the broadcast shape.
#include "mont32.cuh"

namespace hb32 {

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, long long N) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= N) return;
  uint32_t la[2 * NW], lb[2 * NW];
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) {
    const size_t at = static_cast<size_t>(j) * N + g;
    la[j] = a[at];
    lb[j] = b[at];
  }
  uint32_t wa[NW], wb[NW], wo[NW], lo[2 * NW];
  words_of_limbs(la, wa);
  words_of_limbs(lb, wb);
  mont_mul_w(wa, wb, wo);
  limbs_of_words(wo, lo);
#pragma unroll
  for (int j = 0; j < 2 * NW; ++j) out[static_cast<size_t>(j) * N + g] = lo[j];
}

}  // namespace hb32

extern "C" int hb_mont_mul(const void* a, const void* b, void* out,
                           long long N, void* stream) {
  const int threads = 128;
  const unsigned grid = static_cast<unsigned>((N + threads - 1) / threads);
  hb32::mont_mul_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), N);
  return static_cast<int>(cudaGetLastError());
}
