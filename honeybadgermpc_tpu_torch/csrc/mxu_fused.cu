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
//     and digit row q = kk*37 + d, the int8 digit l - d of the scaled
//     v[kk, col] (0 outside 0..36);
//   * diag[b, col, l] = sum over q of digit_d(a[b, kk]) * band[l, q]: 73
//     diagonals, each < 37 k 127^2;
//   * csrc/mxu_core.cuh's Redc73: 36 carry-save limbs, 17 REDC rounds, one
//     conditional subtract — the epilogue of csrc/mxu_redc.cu, here on the
//     diagonals while they are in registers.
//
// What bounds it on an H100: at B = 16,896, n = 4, k = 512 it moves about
// 558 MB (a's limbs, the output) against 2 B n 37^2 k int8 operations of
// the product convolution, so bytes; the kernel does twice those
// multiplies (the dense band: 73 diagonals x 37 digits per operand, padded
// to 80). Design: mxu_core.cuh's k-streamed kernel with 5 m-tiles of 16
// diagonals, 256 threads (the 80 accumulators and 10 fragment registers
// per thread need more than the 128 registers a 512-thread block allows),
// 64 lanes and 4 column slots per block.
#include "mxu_core.cuh"

extern "C" int hb_mxu_fused(const void* a, const void* band, void* out,
                            long long B, int k, int n, int tl, int ksteps,
                            int smem, int pair, void* stream) {
  using namespace hbmxu;
  return pair ? launch_stream<5, 256, Redc73<true>>(a, band, out, B, k, n,
                                                    tl, ksteps, smem, stream)
              : launch_stream<5, 256, Redc73<false>>(a, band, out, B, k, n,
                                                     tl, ksteps, smem, stream);
}
