// mxu_fused: GF(p) matrix product a[L, B, k] @ v[L, k, n] -> [L, B, n]
// (Montgomery limbs) through the full base-2^7 product convolution: a's 37
// unsigned 7-bit digit planes against the band of v's planes on the tensor
// cores give 73 product diagonals, which the 17-round REDC epilogue reduces
// without leaving the chip.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/mxu_matmul.py::
// _fused_kernel (called through fp_matmul_mxu_fused). fp_matmul reaches it
// for a batch >= 1024 where the reference's fused2_fits fails and
// fused_fits holds: k 439-858 at n = 4, 313-422 at n = 8, 196-204 at
// n = 16 (a batch evaluation of many polynomials at a few points, e.g.
// ntl.vandermonde_batch_evaluate).
//
// The function:
//   * v is pre-scaled by 2^16 R (a Montgomery multiply by the wrapper), so
//     17 REDC rounds of 16 bits (dividing by 2^272) leave the Montgomery
//     form of sum_kk a * v;
//   * the band, built by the wrapper: for column col, output diagonal l
//     and digit row kk*37 + d, the int8 digit l - d of the scaled
//     v[kk, col] (0 outside 0..36);
//   * diag[b, col, l] = sum over (kk, d) of digit_d(a[b, kk]) *
//     band[l, (kk, d)]: 73 diagonals, each < 37 k 127^2;
//   * csrc/mxu_core.cuh's Redc73: 36 carry-save limbs, 17 REDC rounds, one
//     conditional subtract — the epilogue of csrc/mxu_redc.cu, here on the
//     diagonals while they are in registers.
//
// What bounds it on an H100: at B = 16,896, n = 4, k = 512 it moves about
// 558 MB (a's limbs, the output) against 2 B n 37^2 k int8 operations of
// the product convolution, so bytes; the dense band doubles the
// multiplies (73 diagonals x 37 digits per operand, in 80 rows). Design:
// band_gemm.cuh's MXU geometry (mxu_gemm_body): one column of 73
// diagonals per 80-row tile, its rows over the four threads of a quad
// (H = 4); at these k the planes stream through two chunk buffers, built
// by a plane warpgroup under the dot, one tile per consumer warpgroup
// and two blocks per 128 lanes at n = 4 (their limb reads meet in L2).
#include "band_gemm.cuh"
#include "mxu_core.cuh"

namespace hb {

template <class Epi>
__global__ void __launch_bounds__(gemm::MXU_THREADS, 1)
    mxu_fused_kernel(const uint32_t* __restrict__ a,
                     const unsigned char* __restrict__ band,
                     uint32_t* __restrict__ out, uint16_t* __restrict__ tmp,
                     long long B, int k, int n, int tgroups, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::mxu_gemm_body<2, 4, Epi>(smem, a, band, out, tmp, B, k, n, tgroups,
                                   nbuf);
}

template <class Epi>
int launch_fused(const void* a, const void* band, void* out, void* tmp,
                 long long B, int k, int n, int tgroups, int nbuf,
                 void* stream) {
  auto kern = mxu_fused_kernel<Epi>;
  const size_t smem = gemm::mxu_smem_bytes(k, 2, nbuf);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + 127) / 128 * tgroups);
  kern<<<grid, gemm::MXU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a),
      static_cast<const unsigned char*>(band), static_cast<uint32_t*>(out),
      static_cast<uint16_t*>(tmp), B, k, n, tgroups, nbuf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hb

// band: int8 [n, mxu_ksteps(k), 2560] tiles (ops/mxu_matmul.py::
// _fused_tiles); tgroups, nbuf: ops/mxu_matmul.py::_mxu_plan; tmp: the
// blocks' 16-bit results [block][16][n][128] on their way to out
// (_mxu_out_plan), or null (direct stores).
extern "C" int hb_mxu_fused(const void* a, const void* band, void* out,
                            void* tmp, long long B, int k, int n, int tgroups,
                            int nbuf, int pair, void* stream) {
  using hbmxu::Redc73;
  return pair ? hb::launch_fused<Redc73<true>>(a, band, out, tmp, B, k, n,
                                               tgroups, nbuf, stream)
              : hb::launch_fused<Redc73<false>>(a, band, out, tmp, B, k, n,
                                                tgroups, nbuf, stream);
}
