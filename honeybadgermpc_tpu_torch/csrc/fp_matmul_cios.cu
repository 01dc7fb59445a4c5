// fp_matmul_cios: GF(p) matrix product a[L, B, k] @ v[L, k, n] -> [L, B, n]
// on Montgomery limb tensors (int32, 16-bit limbs, limb-major planes), one
// CIOS product per (b, kk, column) term and a modular k-accumulation.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/pallas_field.py::
// _matmul_kernel (called through fp_matmul_pallas), which serves
// fpmatmul.fp_matmul for shapes whose batch is below 1024 elements (the
// MXU kernels take the rest): robust_open_single's decode, small Gao
// segments' interpolation.
//
// What bounds it on an H100: operations. B*k*n Montgomery products of
// about 2 x 8 x 8 multiply-adds each on 32-bit words plus a modular add;
// the bytes, (B*k + k*n + B*n) x 64, are small at the shapes it serves.
//
// Design: one thread per (b, column); a block is 32 columns x 4 rows of b
// (128 threads), so a warp is 32 neighbouring columns of one b and every
// v read and out write is coalesced. The contraction runs in tiles of KT
// rows: v's tile [KT][8 words][32 columns] and a's [4][KT][8 words] are
// packed into shared memory (v's word-major, so the 32 threads of a warp
// read 32 banks; a's read is a broadcast), then each thread runs KT
// products of the 32-bit-word CIOS (mont32.cuh) and adds them mod p into
// its 8-word accumulator. Any order of canonical modular additions gives
// the same canonical sum, so the words equal the reference's.
#include "mont32.cuh"

namespace hb32 {

constexpr int TN = 32;   // columns per block
constexpr int TBR = 4;   // rows of b per block
constexpr int KT = 8;    // contraction rows per shared-memory tile

__global__ void fp_matmul_cios_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ v,
                                      uint32_t* __restrict__ out, int B,
                                      int k, int n) {
  __shared__ uint32_t sv[KT][NW][TN];
  __shared__ uint32_t sa[TBR][KT][NW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TN + tx;
  const int col = blockIdx.x * TN + tx;
  const int b = blockIdx.y * TBR + ty;
  const size_t Bk = static_cast<size_t>(B) * k;
  const size_t kn = static_cast<size_t>(k) * n;
  const size_t Bn = static_cast<size_t>(B) * n;

  uint32_t acc[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0u;

  for (int k0 = 0; k0 < k; k0 += KT) {
    // v tile: KT x TN elements, 2 per thread
    for (int e = tid; e < KT * TN; e += TN * TBR) {
      const int kk = e / TN, c = e % TN;
      const int gk = k0 + kk, gc = blockIdx.x * TN + c;
      uint32_t l[2 * NW], w[NW];
#pragma unroll
      for (int j = 0; j < 2 * NW; ++j)
        l[j] = (gk < k && gc < n) ? v[j * kn + static_cast<size_t>(gk) * n + gc]
                                  : 0u;
      words_of_limbs(l, w);
#pragma unroll
      for (int q = 0; q < NW; ++q) sv[kk][q][c] = w[q];
    }
    // a tile: TBR x KT elements
    if (tid < TBR * KT) {
      const int r = tid / KT, kk = tid % KT;
      const int gb = blockIdx.y * TBR + r, gk = k0 + kk;
      uint32_t l[2 * NW], w[NW];
#pragma unroll
      for (int j = 0; j < 2 * NW; ++j)
        l[j] = (gb < B && gk < k) ? a[j * Bk + static_cast<size_t>(gb) * k + gk]
                                  : 0u;
      words_of_limbs(l, w);
#pragma unroll
      for (int q = 0; q < NW; ++q) sa[r][kk][q] = w[q];
    }
    __syncthreads();
    const int kt = min(KT, k - k0);
    for (int kk = 0; kk < kt; ++kk) {
      uint32_t x[NW], y[NW], pr[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        x[q] = sa[ty][kk][q];
        y[q] = sv[kk][q][tx];
      }
      mont_mul_w(x, y, pr);
      add_mod_w(acc, pr, acc);
    }
    __syncthreads();
  }
  if (b < B && col < n) {
    uint32_t l[2 * NW];
    limbs_of_words(acc, l);
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j)
      out[j * Bn + static_cast<size_t>(b) * n + col] = l[j];
  }
}

}  // namespace hb32

extern "C" int hb_fp_matmul_cios(const void* a, const void* v, void* out,
                                 int B, int k, int n, void* stream) {
  const dim3 block(hb32::TN, hb32::TBR);
  const dim3 grid((n + hb32::TN - 1) / hb32::TN,
                  (B + hb32::TBR - 1) / hb32::TBR);
  hb32::fp_matmul_cios_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(v),
      static_cast<uint32_t*>(out), B, k, n);
  return static_cast<int>(cudaGetLastError());
}
