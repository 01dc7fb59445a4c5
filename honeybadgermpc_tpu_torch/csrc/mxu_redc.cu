// mxu_redc: the epilogue of the unfused MXU matmul — 73 int32 base-2^7
// product diagonals per output element -> its canonical Montgomery limbs.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/mxu_matmul.py::_redc_kernel
// (called through fp_matmul_mxu), which runs after an int8 dot of a's 7-bit
// planes against the band of v's (scaled) planes: here the dot is the
// library's int8 matmul outside this kernel, as it was XLA's there. On this
// slice it finishes Gao's erasure interpolation from all 64 shares (k = n =
// 64, where the folded MXU kernel does not fit).
//
// The function, word for word the reference's _redc_diagonals in uint32:
//   * adjacent diagonals pair up, e = d_2i + (d_2i+1 << 7) (mod 2^32, as
//     the reference's uint32), and each pair's value at bit 14i splits
//     into three 16-bit chunks added into 36 carry-save limbs;
//   * 17 Montgomery REDC rounds of 16 bits divide by 2^272 (the operand v
//     was pre-scaled by 2^16 R so the output is the Montgomery form);
//   * a carry chain over 16 limbs and one conditional subtract of p.
// The carry-save limbs stay below 2^31 (ops/mxu_matmul.py, reference
// lines 128-131).
//
// What bounds it on an H100: bytes (73 x 4 read + 64 written per element
// against a few hundred integer instructions).
//
// Design: one thread per output element; the diagonals are laid out
// [73, M], so each of the 73 reads and each of the 16 limb writes is
// coalesced across a warp. Everything else lives in registers, unrolled.
#include <cstdint>
#include <cuda_runtime.h>

namespace hbmxu {

constexpr int L = 16;
constexpr int NOUT = 73;
constexpr int NL = 36;
constexpr int ROUNDS = 17;
constexpr uint32_t MASK = 0xFFFFu;
constexpr uint32_t N0 = 0xFFFFu;

static __device__ __constant__ uint32_t kP[L] = {
    0x0001u, 0x0000u, 0xFFFFu, 0xFFFFu, 0x5BFEu, 0xFFFEu, 0xA402u, 0x53BDu,
    0xD805u, 0x09A1u, 0xD808u, 0x3339u, 0x7D48u, 0x299Du, 0xA753u, 0x73EDu};

// e * 2^bit as three 16-bit chunks added at limbs j, j+1, j+2.
template <int NLIM>
__device__ __forceinline__ void add_at_bit(uint32_t (&t)[NLIM], uint32_t e,
                                           int bit) {
  const int j = bit >> 4, r = bit & 15;
  const uint32_t elo = e & MASK, ehi = e >> 16;
  const uint32_t c0 = (elo << r) & MASK;
  const uint32_t c1 =
      ((r ? (elo >> (16 - r)) : 0u) | ((ehi << r) & MASK)) & MASK;
  const uint32_t c2 = r ? (ehi >> (16 - r)) : 0u;
  t[j] += c0;
  if (j + 1 < NLIM) t[j + 1] += c1;
  if (j + 2 < NLIM) t[j + 2] += c2;
}

__global__ void mxu_redc_kernel(const int32_t* __restrict__ d,
                                uint32_t* __restrict__ out, long long M) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= M) return;
  uint32_t t[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i + 1 < NOUT; i += 2) {
    const uint32_t e =
        static_cast<uint32_t>(d[static_cast<size_t>(i) * M + g]) +
        (static_cast<uint32_t>(d[static_cast<size_t>(i + 1) * M + g]) << 7);
    add_at_bit(t, e, 7 * i);
  }
  add_at_bit(t, static_cast<uint32_t>(d[static_cast<size_t>(NOUT - 1) * M + g]),
             7 * (NOUT - 1));
#pragma unroll
  for (int round = 0; round < ROUNDS; ++round) {
    const uint32_t m = ((t[0] & MASK) * N0) & MASK;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t pr = m * kP[j];       // < 2^32
      t[j] += pr & MASK;
      t[j + 1] += pr >> 16;
    }
    const uint32_t carry0 = t[0] >> 16;
#pragma unroll
    for (int j = 0; j + 1 < NL; ++j) t[j] = t[j + 1];
    t[NL - 1] = 0u;
    t[0] += carry0;
  }
  uint32_t o[L];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = t[j] + c;
    o[j] = v & MASK;
    c = v >> 16;
  }
  uint32_t borrow = 0, d2[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = o[j] - kP[j] - borrow;
    d2[j] = v & MASK;
    borrow = (v >> 16) & 1u;
  }
  const bool take = (c != 0u) | (borrow == 0u);
#pragma unroll
  for (int j = 0; j < L; ++j)
    out[static_cast<size_t>(j) * M + g] = take ? d2[j] : o[j];
}

}  // namespace hbmxu

extern "C" int hb_mxu_redc(const void* diag, void* out, long long M,
                           void* stream) {
  const int threads = 128;
  const unsigned grid = static_cast<unsigned>((M + threads - 1) / threads);
  hbmxu::mxu_redc_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(diag), static_cast<uint32_t*>(out), M);
  return static_cast<int>(cudaGetLastError());
}
