// band_matmul: GF(p) matmul of packed data against a host-constant int
// matrix, through a folded int8 band.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/band_matmul.py::_band_call
// (its inner `kernel`). Same function: out[b, col] = sum_i a[b, i] *
// mat[i][col] over GF(p), operands and results in Montgomery form, packed.
// The dealer's Vandermonde encode (coefficients -> shares at the n party
// points) is this matmul.
//
//   a     uint32 [PL, B, k]      packed operand rows
//   band  int8   [ceil(m/2), k, 2048]   the folded band in 2 KB wgmma
//                                B tiles (ops/band_gemm.py::_gemm_band)
//   out   uint32 [PL, m, B]      packed results, lanes contiguous; the
//                                wrapper returns its [PL, B, m] view
//
// The TPU version re-tiled the operand to [nblk, PL, k, TBW] blocks with a
// transpose pass each way; here the kernel indexes [PL, B, k] directly: a
// lane is a batch row b (one group of B lanes), its operand i at
// a[w*B*k + b*k + i], its column col at out[w*m*B + col*B + b]. Written
// with the lanes contiguous, a warp's stores fill whole sectors; in the
// [PL, B, m] order they touched 16 sectors for 8 bytes each, and cost
// more than the dot at B = 262,144.
//
// What bounds it on an H100: operations. Per batch row the int8 dot is
// m columns x 32 diagonals x 32k digits (1.44 M MAC at k=22, m=64) against
// 32(k+m) bytes of traffic; the fold epilogue on the CUDA cores comes on
// top of the dot. Design: band_gemm.cuh (wgmma on the tensor cores, the
// band streamed through shared memory by bulk copies, the epilogue under
// the other warpgroup's dot).
#include "band_gemm.cuh"

namespace hb {

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    band_matmul_kernel(const uint32_t* __restrict__ a,
                       const unsigned char* __restrict__ band,
                       gemm::EncodeMap mp, gemm::WordFold wf,
                       gemm::StoreEpi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{a}, band, mp, wf, epi);
}

}  // namespace hb

// mb: 64-lane blocks per thread block (4, 2 or 1; ops/band_gemm.py::
// _gemm_plan); fold: the 10 words of _word_fold_consts(k).
extern "C" int hb_band_matmul(const void* a, const void* band, void* out,
                              long long B, int k, int m, int mb,
                              const uint32_t* fold, void* stream) {
  const long long bk = B * k, bm = B * m;
  const hb::gemm::EncodeMap mp{B, B, bk, 0, k, 1, k, m};
  const hb::gemm::StoreEpi epi{
      {static_cast<uint32_t*>(out), bm, 0, 1, B, 0, m}};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::band_matmul_kernel<4>, a, band, mp, epi,
                                 fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::band_matmul_kernel<2>, a, band, mp, epi,
                                 fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::band_matmul_kernel<1>, a, band, mp, epi,
                                 fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
