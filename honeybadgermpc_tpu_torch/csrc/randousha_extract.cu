// randousha_extract: hyperinvertible extraction, in the two verification
// modes of the fused RanDouSha pipeline.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/fused_randousha.py::
// _ke_kernel (called through ke_call), both modes. Same function: a lane is
// one (destination party, slot) pair. The n values the party received in
// that slot, one from every dealer, are the coefficients of a polynomial,
// and the band re-evaluates it at a set of columns:
//
//   randousha_extract_kernel     (agg=True) the first n_out party points
//       (the extracted random sharings, "keep") and ONE more column that
//       carries the run-random rho-weighted sum of the 2t discarded
//       evaluations (the aggregated check sharing z). The band is built on
//       the device for every run (ops/fused_randousha.py::folded_band).
//   randousha_extract_pc_kernel  (agg=False) all n party points: the full
//       re-encode. Columns below n_outp go to keep (so keep rows n_out ..
//       n_outp-1 are the first check columns, as in the reference), columns
//       n_out .. n-1 go to the check tensor at col - n_out, and check
//       columns ncheck .. ncheckp-1 are written as zero.
//
//   cols  uint32 [PL, n, n, sp]        receive tensor [word, dst, src, slot]
//   band  int8 [ceil(m/2), n, 2048]    band_gemm tiles (ops/band_gemm.py::
//                                      _gemm_band) of m = n_out + 1 (agg:
//                                      the rho-folded band) or n columns
//                                      (per-column: the n-point encode
//                                      band), re-laid on the device
//   keep  uint32 [PL, n, n_outp, sp]   agg: rows < n_out extracted sharings,
//                                      row n_out the check sharing, rows
//                                      above it zero sharings
//   z     uint32 [PL, n, sp]           agg: the check sharing alone
//   chk   uint32 [PL, n, ncheckp, sp]  per-column: the 2t check columns
//
// What bounds it on an H100: operations. Per lane the int8 dot is
// (n_out + 1) columns (agg) or n columns (per-column) x 32 diagonals x 32n
// digits against 32n bytes read and 32 (n_outp + 1) or 32 (n_outp +
// ncheckp) written; the fold epilogue on the CUDA cores comes on top of
// the dot.
//
// Both modes run on band_gemm.cuh's core (wgmma, the band in 2 KB tiles
// streamed through shared memory, the epilogue straight from the
// accumulators): lane g = dst * sp + sl, its n operands the sources' words
// of that slot (LoadSrc). The epilogue policies below store each column to
// its outputs, lane-contiguous in sl, and write the rows that are no
// column of the dot as zero. At n = 64 the planes leave room for 64-lane
// blocks only.
#include "band_gemm.cuh"

namespace hb {

// The aggregated extraction's epilogue on the core: the dot has m =
// n_out + 1 columns (the last tile half empty when m is odd). Column col
// goes to keep [PL, n, n_outp, sp] at row col when col < n_outp, and
// column n_out, the check sharing, also to z [PL, n, sp]. Keep rows n_out+1
// .. n_outp-1 are no column of the dot: the threads of a lane write them
// zero between them in finish().
struct ExtractAggEpi {
  gemm::Store keep, z;
  int n_out, n_outp;
  struct Lane {
    long long kat, zat;   // the lane's offsets in keep and z
    bool valid;
  };
  using Fetch = gemm::NoFetch;

  __device__ __forceinline__ Lane lane(const gemm::EncodeMap&, long long,
                                       bool valid, long long grp,
                                       long long c) const {
    return {keep.base(grp, c), z.base(grp, c), valid};
  }
  __device__ __forceinline__ void fetch(const gemm::EncodeMap&, const Lane&,
                                        int, Fetch&) const {}
  __device__ __forceinline__ void apply(const gemm::EncodeMap&, Lane& ln,
                                        int col, const uint32_t (&words)[PL],
                                        const Fetch&) const {
    if (!ln.valid) return;
    keep.put(ln.kat, col, words);
    z.put(ln.zat, col, words);
  }
  __device__ __forceinline__ void finish(const gemm::EncodeMap&,
                                         const Lane& ln, int part,
                                         int parts) const {
    if (!ln.valid) return;
    for (int r = n_out + 1 + part; r < n_outp; r += parts) {
      uint32_t* o = keep.out + ln.kat + static_cast<long long>(r) * keep.ocol;
#pragma unroll
      for (int w = 0; w < PL; ++w) o[w * keep.ow] = 0u;
    }
  }
};

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    randousha_extract_kernel(const uint32_t* __restrict__ cols,
                             const unsigned char* __restrict__ band,
                             gemm::EncodeMap mp, gemm::WordFold wf,
                             ExtractAggEpi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{cols}, band, mp, wf, epi);
}

// The per-column extraction's epilogue on the core: column col goes to
// keep [PL, n, n_outp, sp] when col < n_outp and to chk [PL, n, ncheckp,
// sp] at row col - n_out when n_out <= col < n (columns n_out..n_outp-1
// go to both). Check rows ncheck..ncheckp-1 are no column of the dot (a
// zero band column would leave the fold constant, not 0): the threads of a
// lane write them zero between them in finish().
struct ExtractPcEpi {
  gemm::Store keep, chk;
  int ncheck, ncheckp;
  struct Lane {
    long long kat, cat;   // the lane's offsets in keep and chk
    bool valid;
  };
  using Fetch = gemm::NoFetch;

  __device__ __forceinline__ Lane lane(const gemm::EncodeMap&, long long,
                                       bool valid, long long grp,
                                       long long c) const {
    return {keep.base(grp, c), chk.base(grp, c), valid};
  }
  __device__ __forceinline__ void fetch(const gemm::EncodeMap&, const Lane&,
                                        int, Fetch&) const {}
  __device__ __forceinline__ void apply(const gemm::EncodeMap&, Lane& ln,
                                        int col, const uint32_t (&words)[PL],
                                        const Fetch&) const {
    if (!ln.valid) return;
    keep.put(ln.kat, col, words);
    chk.put(ln.cat, col, words);
  }
  __device__ __forceinline__ void finish(const gemm::EncodeMap&,
                                         const Lane& ln, int part,
                                         int parts) const {
    if (!ln.valid) return;
    for (int r = ncheck + part; r < ncheckp; r += parts) {
      uint32_t* o = chk.out + ln.cat + static_cast<long long>(r) * chk.ocol;
#pragma unroll
      for (int w = 0; w < PL; ++w) o[w * chk.ow] = 0u;
    }
  }
};

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    randousha_extract_pc_kernel(const uint32_t* __restrict__ cols,
                                const unsigned char* __restrict__ band,
                                gemm::EncodeMap mp, gemm::WordFold wf,
                                ExtractPcEpi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{cols}, band, mp, wf, epi);
}

}  // namespace hb

// The lane map of both modes: lane dst * sp + sl, operand (source) i at
// cols[((w*n + dst)*n + i)*sp + sl]; m columns.
static hb::gemm::EncodeMap extract_map(int n, int sp, int m) {
  const long long nl = static_cast<long long>(n), s = sp;
  return {nl * s, s, nl * nl * s, nl * s, 1, s, n, m};
}

// cols [PL, n, n, sp]; band: the rho-folded band in band_gemm tiles
// (n_out + 1 columns); keep [PL, n, n_outp, sp]; z [PL, n, sp]; mb: 64-lane
// blocks per thread block (ops/band_gemm.py::_gemm_plan); fold:
// _word_fold_consts(n).
extern "C" int hb_randousha_extract(const void* cols, const void* band,
                                    void* keep, void* z, int n, int sp,
                                    int n_out, int n_outp, int mb,
                                    const uint32_t* fold, void* stream) {
  const long long nl = static_cast<long long>(n), s = sp;
  const hb::gemm::EncodeMap mp = extract_map(n, sp, n_out + 1);
  const hb::ExtractAggEpi epi{
      {static_cast<uint32_t*>(keep), nl * n_outp * s, n_outp * s, 1, s, 0,
       n_out + 1 < n_outp ? n_out + 1 : n_outp},
      {static_cast<uint32_t*>(z), nl * s, s, 1, 0, n_out, n_out + 1},
      n_out, n_outp};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::randousha_extract_kernel<4>, cols, band,
                                 mp, epi, fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::randousha_extract_kernel<2>, cols, band,
                                 mp, epi, fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::randousha_extract_kernel<1>, cols, band,
                                 mp, epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cols [PL, n, n, sp]; band: the n-point encode band in band_gemm tiles
// (n columns); keep [PL, n, n_outp, sp]; chk [PL, n, ncheckp, sp]; mb:
// 64-lane blocks per thread block (ops/band_gemm.py::_gemm_plan); fold:
// _word_fold_consts(n).
extern "C" int hb_randousha_extract_pc(const void* cols, const void* band,
                                       void* keep, void* chk, int n, int sp,
                                       int n_out, int n_outp, int ncheckp,
                                       int mb, const uint32_t* fold,
                                       void* stream) {
  const long long nl = static_cast<long long>(n), s = sp;
  const hb::gemm::EncodeMap mp = extract_map(n, sp, n);
  const hb::ExtractPcEpi epi{
      {static_cast<uint32_t*>(keep), nl * n_outp * s, n_outp * s, 1, s, 0,
       n_outp},
      {static_cast<uint32_t*>(chk), nl * ncheckp * s, ncheckp * s, 1, s,
       n_out, n},
      n - n_out, ncheckp};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::randousha_extract_pc_kernel<4>, cols,
                                 band, mp, epi, fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::randousha_extract_pc_kernel<2>, cols,
                                 band, mp, epi, fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::randousha_extract_pc_kernel<1>, cols,
                                 band, mp, epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
