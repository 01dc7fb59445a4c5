// randousha_deal: draw and deal one degree of every party's random
// sharings, in one kernel.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/fused_randousha.py::
// _kd_kernel (called through kd_call). Same function: a lane is one
// (source party, slot) pair. The lane draws its polynomial's k uniform
// coefficients with Threefry-2x32-20 and the 384-bit REDC, never writing
// them to device memory, evaluates the polynomial at the n party points
// (the folded encode band) and scatters share j to destination party j.
//
// Counters. Coefficient i of a polynomial has a GLOBAL row id: row 0 is the
// secret, rows 1..t the degree-t high part, rows t+1..3t the degree-2t high
// part. The draw for (row, lane) uses counters c0 = 0x10000 + 8*row + s,
// s = 0..5, and c1 = src*sp + slot, which is the flat lane index. A degree
// is therefore the pair (k, row1): coefficient 0 is row 0, coefficient
// i >= 1 is row row1 + i - 1 (row1 = 1 with k = t+1, row1 = t+1 with
// k = 2t+1). Row 0 comes out identical in both degrees, which is what makes
// the double sharing consistent. (The TPU kernel generated rows in groups
// of eight because of its register tiles; the groups are not part of the
// function and are not reproduced.)
//
//   band  int8   [n/2, k, 2048]  the encode band in band_gemm tiles (ops/
//                                band_gemm.py::_gemm_band), n columns
//   out   uint32 [PL, n, B]      the receive tensor: B = n*sp flat lanes, so
//                                this is [PL, dst, src, sp]; the extraction
//                                reads one destination's n sources as n
//                                contiguous rows of sp words
//
// What bounds it on an H100: operations. Per lane the int8 dot is n
// columns x 32 diagonals x 32k digits against 32n bytes written (nothing is
// read but the band); the sampler (about 535 32-bit integer instructions
// per coefficient at the least) and the fold epilogue run on the CUDA cores
// on top of the dot.
//
// Design: band_matmul's GEMM on band_gemm.cuh's core (wgmma, the band
// streamed through shared memory, the fold straight from the accumulators)
// with the operand source DrawSrc: the plane build draws each (lane,
// coefficient) item in registers (Threefry, then four 32-bit Montgomery
// rounds and one 16-bit one) where band_matmul loads it, and StoreEpi
// writes every column lane-contiguous. The draw runs in the plane phase,
// before the block's first wgmma; the producer warps' first band loads fly
// under it. The lane tile is ops/band_gemm.py::_gemm_plan's.
#include "band_gemm.cuh"

namespace hb {

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    randousha_deal_kernel(gemm::DrawSrc src,
                          const unsigned char* __restrict__ band,
                          gemm::EncodeMap mp, gemm::WordFold wf,
                          gemm::StoreEpi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, src, band, mp, wf, epi);
}

template <int MB>
int launch_deal(const gemm::DrawSrc& src, const void* band,
                const gemm::EncodeMap& mp, const gemm::StoreEpi& epi,
                const uint32_t* fold, void* stream) {
  return gemm::launch_with<MB>(randousha_deal_kernel<MB>, src, band, mp, epi,
                               fold, stream);
}

}  // namespace hb

// key0, key1: the run key; band: _gemm_band tiles of the k-coefficient
// encode band at the n points; out [PL, n, n*sp]; row1: the global row of
// coefficient 1; mb: 64-lane blocks per thread block; fold:
// _word_fold_consts(k).
extern "C" int hb_randousha_deal(uint32_t key0, uint32_t key1,
                                 const void* band, void* out, int n, int sp,
                                 int k, int row1, int mb,
                                 const uint32_t* fold, void* stream) {
  const long long B = static_cast<long long>(n) * sp;
  // one group of B lanes: lane g = src * sp + slot, its column (the
  // destination) col at out[w*n*B + col*B + g]
  const hb::gemm::EncodeMap mp{B, B, 0, 0, 0, 0, k, n};
  const hb::gemm::DrawSrc src{key0, key1, row1};
  const hb::gemm::StoreEpi epi{
      {static_cast<uint32_t*>(out), n * B, 0, 1, B, 0, n}};
  switch (mb) {
    case 4:
      return hb::launch_deal<4>(src, band, mp, epi, fold, stream);
    case 2:
      return hb::launch_deal<2>(src, band, mp, epi, fold, stream);
    case 1:
      return hb::launch_deal<1>(src, band, mp, epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
