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
//     rounds (1 for k <= 27, else 2), two conditional subtracts; adjacent
//     diagonals paired only where that cannot wrap (k <= 55).
//
// What bounds it on an H100: operations, the int8 dot (2 x 37 x 37 k n MAC
// per batch row) at B = 49,152, k = 22 (n = 43 and 64); bytes (a's limbs)
// at n = 4, k = 438. Design: band_gemm.cuh's MXU geometry (mxu_gemm_body):
// wgmma.m64n80k32 on 128-lane blocks, band tiles of 2 columns x 40
// diagonal rows (37 used) streamed by bulk copies, the planes built by a
// plane warpgroup (resident, or two chunk buffers under the dot where
// the planes of k operands do not fit), the epilogue from the
// accumulators after one shuffle exchange per lane slot.
#include "band_gemm.cuh"
#include "mxu_core.cuh"

namespace hb {

template <class Epi>
__global__ void __launch_bounds__(gemm::MXU_THREADS, 1)
    mxu_fused2_kernel(const uint32_t* __restrict__ a,
                      const unsigned char* __restrict__ band,
                      uint32_t* __restrict__ out, uint16_t* __restrict__ tmp,
                      long long B, int k, int n, int tgroups, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::mxu_gemm_body<2, 2, Epi>(smem, a, band, out, tmp, B, k, n, tgroups,
                                   nbuf);
}

template <class Epi>
int launch_fused2(const void* a, const void* band, void* out, void* tmp,
                  long long B, int k, int n, int tgroups, int nbuf,
                  void* stream) {
  auto kern = mxu_fused2_kernel<Epi>;
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

// band: int8 [ceil(n/2), mxu_ksteps(k), 2560] tiles (ops/mxu_matmul.py::
// _fused2_tiles); tgroups, nbuf: ops/mxu_matmul.py::_mxu_plan; tmp: the
// blocks' 16-bit results [block][16][2 ceil(n/2)][128] on their way to
// out (_mxu_out_plan), or null (direct stores). rounds 1 comes with pair
// (k <= 27).
extern "C" int hb_mxu_fused2(const void* a, const void* band, void* out,
                             void* tmp, long long B, int k, int n, int rounds,
                             int tgroups, int nbuf, int pair,
                             void* stream) {
  using hbmxu::Fold37;
  if (rounds == 1 && pair)
    return hb::launch_fused2<Fold37<1, true>>(a, band, out, tmp, B, k, n,
                                              tgroups, nbuf, stream);
  if (rounds == 2 && pair)
    return hb::launch_fused2<Fold37<2, true>>(a, band, out, tmp, B, k, n,
                                              tgroups, nbuf, stream);
  if (rounds == 2)
    return hb::launch_fused2<Fold37<2, false>>(a, band, out, tmp, B, k, n,
                                               tgroups, nbuf, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
