// open_fused: the faithful n-party batch open as three kernels.
//
// Replaces the TPU kernels honeybadgermpc_tpu/ops/fused_open.py::_k1_kernel,
// _k2_kernel and _k3_kernel (called through _open_calls). Same functions,
// for packed shares [PL, n, k*C] (party p's chunk c holds the k coefficients
// at b = i*C + c):
//
//   K1  encode   lane (p, c): the k coefficients of party p's chunk c,
//                contracted with the encode band at all n points
//                -> cols [PL, n_src, n_dst, C]
//   K2  R1       lane (j, c): the first k sources' columns received by
//                destination j, contracted with [lam(points[k:]) | lam0]:
//                column nv (lam0) is psi_j(0) -> vals [PL, n, C]; columns
//                0..nv-1 predict the other n-k sources' columns, compared
//                with the received ones; mismatches go to errs[j], the
//                DESTINATION (the direct open charges the source)
//   K3  R2       lane c: the first k psi values, contracted with
//                [lam(points[k:]) | Minv]: columns 0..nv-1 predict the
//                other psi values; mismatches go to errs[0]; columns
//                nv..n-1 are the k secret coefficients -> sec [PL, k, C]
//
// A fourth kernel serves the fused RanDouSha pipeline's per-column check
// and replaces honeybadgermpc_tpu/ops/fused_randousha.py::_kc_kernel
// (called through kc_call):
//
//   KC  check    lane (col, s) of the check tensor chk [PL, n, ncheckp, sp]
//                (the 2t discarded columns every party extracted): K2's
//                function with n_dst -> ncheckp and C -> sp. The first k
//                parties' shares decode the column's value at 0 -> vals
//                [PL, ncheckp, sp]; the other n-k are validated, and the
//                lane's mismatch count goes to errs[lane] as it is, not to
//                a destination
//
// In the simulation every destination's R2 input is the same gathered
// vector, so K3 decodes it once (lanes = chunks, not destinations x
// chunks); the caller broadcasts the secrets and charges errs[0] to every
// destination. That is the function the reference computes with n
// identical decodes.
//
// What bounds them on an H100: operations. Per lane the int8 dot is
// ncol columns x 32 diagonals x 32k digits (K1 at n=64, k=22: 1.4 M MAC
// against 32k bytes read and 32n written), far above the card's int8
// ridge; the fold/REDC epilogue (CUDA cores, about 450 instructions per
// lane and column) comes on top of the dot.
//
// K1, K2, K3 and KC run on band_gemm.cuh's core (wgmma, the band streamed
// through shared memory, the epilogue straight from the accumulators),
// lane g = grp * C + c with the chunk index c contiguous. K1's epilogue is
// a plain store. K2's, KC's and K3's are band_gemm.cuh's CompareEpi:
// columns 0..nv-1 compared with the received words, loaded ahead of the
// fold, each lane's mismatch count kept in a register and added to
// errs[destination] (K2) or errs[lane] (KC) with one atomicAdd when it is
// not 0, or (K3) summed over the warp and added to errs[0] with one
// atomicAdd per warp when not 0 (honest shares: no atomics); the stored
// columns go out lane-contiguous: column nv (K2, KC: the value at 0) or
// the k columns nv..n-1 (K3: the coefficients). K2 and KC run K2's R1
// band. KC's lanes are the check tensor's (col, slot) pairs as one group
// (C = lanes). K3's lanes are the C chunks, one group; its band is the
// reference's R2 band with the compare columns moved first
// (ops/fused_open.py::_k3_columns); at C = 7,820 or 4,001 its 64-lane
// blocks alone leave SMs idle, so its 32 column tiles are split into
// groups over blocks (ops/band_gemm.py::_gemm_split).
#include "band_gemm.cuh"

namespace hb {

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    open_fused_k1_kernel(const uint32_t* __restrict__ src,
                         const unsigned char* __restrict__ band,
                         gemm::EncodeMap mp, gemm::WordFold wf,
                         gemm::StoreEpi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{src}, band, mp, wf, epi);
}

// K2's and KC's epilogue on the core: compare and count, charged to the
// destination (K2: lane g = j * C + c, errs[g / C]) or to the lane (KC).
using K2Epi = gemm::CompareEpi<gemm::Charge::Group>;
using CheckEpi = gemm::CompareEpi<gemm::Charge::Lane>;
// K3's: compare and count charged to errs[0], the k coefficients stored.
using K3Epi = gemm::CompareEpi<gemm::Charge::Total>;

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    open_fused_k2_kernel(const uint32_t* __restrict__ src,
                         const unsigned char* __restrict__ band,
                         gemm::EncodeMap mp, gemm::WordFold wf, K2Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{src}, band, mp, wf, epi);
}

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    open_fused_k3_core_kernel(const uint32_t* __restrict__ src,
                              const unsigned char* __restrict__ band,
                              gemm::EncodeMap mp, gemm::WordFold wf,
                              K3Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB, gemm::LoadSrc, K3Epi, true>(
      smem, gemm::LoadSrc{src}, band, mp, wf, epi);
}

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    randousha_check_kernel(const uint32_t* __restrict__ chk,
                           const unsigned char* __restrict__ band,
                           gemm::EncodeMap mp, gemm::WordFold wf,
                           CheckEpi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{chk}, band, mp, wf, epi);
}

}  // namespace hb

// src [PL, n, k, C], band: the encode band in band_gemm tiles, out: cols
// [PL, n_src, n_dst, C]; C: chunks; mb: 64-lane blocks per thread block
// (ops/band_gemm.py::_gemm_plan); fold: _word_fold_consts(k).
extern "C" int hb_open_fused_k1(const void* src, const void* band, void* out,
                                int n, int k, long long C, int mb,
                                const uint32_t* fold, void* stream) {
  const long long nl = static_cast<long long>(n);
  const hb::gemm::EncodeMap mp{nl * C, C, nl * k * C, k * C, 1, C, k, n};
  const hb::gemm::StoreEpi epi{
      {static_cast<uint32_t*>(out), nl * nl * C, nl * C, 1, C, 0, n}};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::open_fused_k1_kernel<4>, src, band, mp,
                                 epi, fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::open_fused_k1_kernel<2>, src, band, mp,
                                 epi, fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::open_fused_k1_kernel<1>, src, band, mp,
                                 epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// src: cols [PL, n_src, n_dst, C]; band: K2's band in band_gemm tiles
// (nv + 1 columns); out: vals [PL, n, C]; errs: int32 [n], zeroed by the
// caller; mb, fold as for K1.
extern "C" int hb_open_fused_k2(const void* src, const void* band, void* out,
                                void* errs, int n, int k, long long C, int mb,
                                const uint32_t* fold, void* stream) {
  const long long nl = static_cast<long long>(n);
  const int nv = n - k;
  // lane j * C + c: operand i at src[w*n*n*C + i*n*C + j*C + c]
  const hb::gemm::EncodeMap mp{nl * C, C, nl * nl * C, C, 1, nl * C, k,
                               nv + 1};
  const hb::K2Epi epi{static_cast<uint32_t*>(out), static_cast<int*>(errs),
                      static_cast<const uint32_t*>(src), nv};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::open_fused_k2_kernel<4>, src, band, mp,
                                 epi, fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::open_fused_k2_kernel<2>, src, band, mp,
                                 epi, fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::open_fused_k2_kernel<1>, src, band, mp,
                                 epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// src: vals [PL, n, C]; band: K3's band in band_gemm tiles (n columns:
// the nv compare columns, then the k coefficients); out: sec [PL, k, C];
// errs: int32 [1], zeroed by the caller; mb, groups: 64-lane blocks per
// thread block and column groups (ops/band_gemm.py::_gemm_split); fold:
// _word_fold_consts(k).
extern "C" int hb_open_fused_k3(const void* src, const void* band, void* out,
                                void* errs, int n, int k, long long C, int mb,
                                int groups, const uint32_t* fold,
                                void* stream) {
  // lane c, one group: operand i at src[w*n*C + i*C + c]
  const hb::gemm::EncodeMap mp{C, C, static_cast<long long>(n) * C, 0, 1, C,
                               k, n, groups};
  const hb::K3Epi epi{static_cast<uint32_t*>(out), static_cast<int*>(errs),
                      static_cast<const uint32_t*>(src), n - k, k};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::open_fused_k3_core_kernel<4>, src, band,
                                 mp, epi, fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::open_fused_k3_core_kernel<2>, src, band,
                                 mp, epi, fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::open_fused_k3_core_kernel<1>, src, band,
                                 mp, epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// src: the check tensor [PL, n, ncheckp, sp]; band: K2's band at k in
// band_gemm tiles (nv + 1 columns); out: vals [PL, ncheckp, sp]; errs:
// int32 [ncheckp, sp], zeroed by the caller; mb, fold as for K1.
extern "C" int hb_randousha_check(const void* src, const void* band,
                                  void* out, void* errs, int n, int k,
                                  long long sp, long long ncheckp, int mb,
                                  const uint32_t* fold, void* stream) {
  const long long lanes = ncheckp * sp;     // lane = col * sp + slot
  // one group of all lanes: operand i at src[w*n*lanes + i*lanes + g]
  const hb::gemm::EncodeMap mp{lanes, lanes, n * lanes, 0, 1, lanes, k,
                               n - k + 1};
  const hb::CheckEpi epi{static_cast<uint32_t*>(out),
                         static_cast<int*>(errs),
                         static_cast<const uint32_t*>(src), n - k};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::randousha_check_kernel<4>, src, band,
                                 mp, epi, fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::randousha_check_kernel<2>, src, band,
                                 mp, epi, fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::randousha_check_kernel<1>, src, band,
                                 mp, epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
