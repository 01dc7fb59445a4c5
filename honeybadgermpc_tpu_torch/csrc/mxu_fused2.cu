// mxu_fused2: GF(p) matrix product a[L, B, k] @ v[L, k, n] -> [L, B, n]
// (Montgomery limbs, int32 16-bit limb planes) through unsigned 7-bit
// digit planes and an int8 dot on the tensor cores against a band folded
// from v, then a short fold/REDC epilogue.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/mxu_matmul.py::
// _fused2_kernel (called through fp_matmul_mxu2). It runs
// decode_validate_matmul in the batch open's two rounds (k = 22 shares of
// each of B = 49,152 decodes against n = 43 and n = 64 columns) and every
// fp_matmul of a batch >= 1024 that the reference's fused2_fits admits:
// up to k = 438 at n = 4, 52 at n = 64.
//
// The function (the reference's "folded-constant" scheme):
//   * the band, built on the device by the wrapper: for column col, digit
//     d of the data and output diagonal s, the int8 digit s of
//     w[kk, col, d] = v[kk, col] * 2^(7d + 16 rounds) * R^-1 mod p;
//   * diag[b, col, s] = sum over (kk, d) of digit_d(a[b, kk]) *
//     digit_s(w[kk, col, d]): 37 diagonals, each < 37 k 127^2;
//   * csrc/mxu_core.cuh's Fold37: 19 carry-save limbs, `rounds` REDC
//     rounds (1 for k <= 27, else 2), two conditional subtracts.
//
// What bounds it on an H100: operations, the int8 dot (2 x 37 x 37 k n MAC
// per batch row, padded here to 48 diagonals and k*37 -> a multiple of
// 32). Design: mxu_core.cuh's k-streamed kernel with 3 m-tiles of 16
// diagonals, 512 threads, 64 lanes and 8 column slots per block.
#include "mxu_core.cuh"

extern "C" int hb_mxu_fused2(const void* a, const void* band, void* out,
                             long long B, int k, int n, int rounds, int tl,
                             int ksteps, int smem, int pair, void* stream) {
  using namespace hbmxu;
  if (rounds == 1 && pair)
    return launch_stream<3, 512, Fold37<1, true>>(a, band, out, B, k, n, tl,
                                                  ksteps, smem, stream);
  if (rounds == 1)
    return launch_stream<3, 512, Fold37<1, false>>(a, band, out, B, k, n, tl,
                                                   ksteps, smem, stream);
  if (pair)
    return launch_stream<3, 512, Fold37<2, true>>(a, band, out, B, k, n, tl,
                                                  ksteps, smem, stream);
  return launch_stream<3, 512, Fold37<2, false>>(a, band, out, B, k, n, tl,
                                                 ksteps, smem, stream);
}
