// rand_limbs: uniform field elements from a Threefry key.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/pallas_field.py::
// rand_limbs_pallas (_rand_kernel). Same function, bit for bit: element e
// draws Threefry-2x32-20 with counters (s, e), s = 0..5, and takes the
// halfwords w0.lo, w0.hi, w1.lo, w1.hi of each call — 24 halfwords, 384
// bits — through nine 16-bit REDC rounds, a carry normalization and one
// conditional subtract. The canonical limbs are used directly as the
// Montgomery representation.
//
//   out  uint32 [L, numel]
//
// What bounds it on an H100: the kernel reads nothing and writes 64 B per
// element; per element it does roughly 1,300 32-bit integer operations
// (6 x 20 Threefry rounds, 9 x 16 multiply-add REDC steps). Both times are
// of the same order on this card, so the design keeps the arithmetic in
// registers and makes the only memory traffic the output itself.
//
// Design: one thread per element, everything unrolled in registers; the
// counter e is the global element index (the TPU kernel's tile base +
// row*lanes + col is just that). Limb j of element e goes to out[j*numel+e],
// so neighbouring threads write neighbouring addresses.
#include "field_core.cuh"

namespace hb {

__global__ void rand_limbs_kernel(uint32_t k0, uint32_t k1,
                                  uint32_t* __restrict__ out,
                                  long long numel) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= numel) return;
  uint32_t rows[25];
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    uint32_t w0, w1;
    threefry2x32(k0, k1, static_cast<uint32_t>(s), static_cast<uint32_t>(e),
                 w0, w1);
    rows[4 * s + 0] = w0 & MASK;
    rows[4 * s + 1] = w0 >> 16;
    rows[4 * s + 2] = w1 & MASK;
    rows[4 * s + 3] = w1 >> 16;
  }
  rows[24] = 0;
  uint32_t limbs[L];
  redc384(rows, limbs);
#pragma unroll
  for (int j = 0; j < L; ++j) out[static_cast<size_t>(j) * numel + e] = limbs[j];
}

}  // namespace hb

extern "C" int hb_rand_limbs(uint32_t k0, uint32_t k1, void* out,
                             long long numel, void* stream) {
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((numel + threads - 1) / threads);
  hb::rand_limbs_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<uint32_t*>(out), numel);
  return static_cast<int>(cudaGetLastError());
}
