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
//   band  agg: int4 [ncp, n, 2, 32]    column, k-step (= source), m-tile,
//                                      thread (ops/fused_open.py::
//                                      _kernel_band), built on the device;
//         per-column: int8 [n/2, n, 2048]  band_gemm tiles (ops/
//                                      band_gemm.py::_gemm_band), re-laid
//                                      on the device
//   keep  uint32 [PL, n, n_outp, sp]   agg: rows < n_out extracted sharings,
//                                      row n_out the check sharing, rows
//                                      above it zero sharings (zero band
//                                      columns: no dot is run)
//   z     uint32 [PL, n, sp]           agg: the check sharing alone
//   chk   uint32 [PL, n, ncheckp, sp]  per-column: the 2t check columns
//
// What bounds it on an H100: operations. Per lane the int8 dot is
// (n_out + 1) columns (agg) or n columns (per-column) x 32 diagonals x 32n
// digits against 32n bytes read and 32 (n_outp + 1) or 32 (n_outp +
// ncheckp) written; the fold/REDC epilogue on the CUDA cores comes on top
// of the dot.
//
// The per-column mode runs on band_gemm.cuh's core (wgmma, the band in
// 2 KB tiles streamed through shared memory, the epilogue straight from
// the accumulators): lane g = dst * sp + sl, its n operands the sources'
// words of that slot; ExtractPcEpi below stores each column to keep
// and/or chk, both lane-contiguous in sl, and writes the zero check rows.
// At n = 64 the planes leave room for 64-lane blocks only.
//
// The aggregate mode keeps the shape of open_direct.cu on field_core.cuh's
// mma.sync core, at contraction length n. The digit planes of a lane take
// 32n bytes (2 KB at n = 64), so a block holds 32 or 64 lanes and 16 or 8
// column slots. Thread (slot, lane) builds the planes of sources slot,
// slot+WG, ... (a warp reads 32 neighbouring slots of one source row);
// after one barrier every warp walks its slot's columns on its own and
// stores 8 words per lane and column, neighbouring lanes to neighbouring
// addresses. Offsets pass 2^31 bytes: size_t throughout.
#include "band_gemm.cuh"

namespace hb {

__device__ __forceinline__ void extract_body(
    unsigned char* smem, const uint32_t* __restrict__ cols,
    const int4* __restrict__ band, uint32_t* __restrict__ keep,
    uint32_t* __restrict__ z, int n, int sp, int n_out, int n_outp, int tl,
    const FoldConst& fc) {
  const int wg = blockDim.x / tl;
  const int tid = threadIdx.x;
  const int laneid = tid & 31;
  const int slot = tid / tl;               // column slot of this warp
  const int lane = tid - slot * tl;        // lane within the block
  const long long B = static_cast<long long>(n) * sp;
  const long long b = static_cast<long long>(blockIdx.x) * tl + lane;
  const bool valid = b < B;
  const int dst = valid ? static_cast<int>(b / sp) : 0;
  const int sl = valid ? static_cast<int>(b - static_cast<long long>(dst) * sp)
                       : 0;
  const int stride = tl + 8;
  const BandSmem s = band_smem_carve(smem, n, tl, wg);
  int* s_d = s.stage + (tid >> 5) * 32 * D_STRIDE;

  // digit planes of the n received values; slot j takes sources j, j+wg, ...
  for (int i = slot; i < n; i += wg) {
    uint32_t carry = 0;
#pragma unroll
    for (int w = 0; w < PL; ++w) {
      const uint32_t word =
          valid ? cols[((static_cast<size_t>(w) * n + dst) * n + i) * sp + sl]
                : 0u;
      s.planes[(i * PL + w) * stride + lane] = balance_word(word, carry);
    }
  }

  __syncthreads();                         // planes are ready

  // no block barrier below: each warp walks its slot's columns on its own.
  // Columns 0..n_out have a dot; the keep rows above are zero sharings.
  const int ndot = n_out + 1;
  const int ncols = n_outp > ndot ? n_outp : ndot;
  for (int col = slot; col < ncols; col += wg) {
    uint32_t words[PL];
    if (col < ndot) {                      // warp-uniform
      int acc[2][4][4];
      band_mma_column(acc, s.planes, stride, lane - laneid,
                      band + static_cast<size_t>(col) * n * 64, n, laneid);
      int32_t ds[NBAL];
      uint32_t limbs[L];
      band_mma_diagonals(acc, s_d, laneid, ds);
      fold_reduce_bal(ds, fc, limbs);
      pack16(limbs, words);
    } else {                               // zero column: zero sharing
#pragma unroll
      for (int w = 0; w < PL; ++w) words[w] = 0u;
    }
    if (!valid) continue;
    if (col < n_outp) {
#pragma unroll
      for (int w = 0; w < PL; ++w)
        keep[((static_cast<size_t>(w) * n + dst) * n_outp + col) * sp + sl] =
            words[w];
    }
    if (col == n_out) {
#pragma unroll
      for (int w = 0; w < PL; ++w)
        z[(static_cast<size_t>(w) * n + dst) * sp + sl] = words[w];
    }
  }
}

__global__ void randousha_extract_kernel(const uint32_t* __restrict__ cols,
                                         const int4* __restrict__ band,
                                         uint32_t* __restrict__ keep,
                                         uint32_t* __restrict__ z, int n,
                                         int sp, int n_out, int n_outp,
                                         int tl, FoldConst fc) {
  extern __shared__ __align__(16) unsigned char smem[];
  extract_body(smem, cols, band, keep, z, n, sp, n_out, n_outp, tl, fc);
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
  gemm::band_gemm_body<MB>(smem, cols, band, mp, wf, epi);
}

// Dynamic shared memory of a launch, allowed above 48 KB for `kernel`.
template <typename Kernel>
int prepare_extract(Kernel kernel, int n, int tl, int wg, size_t* smem) {
  *smem = band_smem_bytes(n, tl, wg, 0);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

FoldConst extract_fold_const(const uint32_t* init, int bias) {
  FoldConst fc;
  for (int j = 0; j < NL; ++j) fc.init[j] = init[j];
  fc.bias = bias;
  return fc;
}

}  // namespace hb

extern "C" int hb_randousha_extract(const void* cols, const void* band,
                                    void* keep, void* z, int n, int sp,
                                    int n_out, int n_outp, int tl, int wg,
                                    const uint32_t* init, int bias,
                                    void* stream) {
  size_t smem = 0;
  const int rc =
      hb::prepare_extract(hb::randousha_extract_kernel, n, tl, wg, &smem);
  if (rc != 0) return rc;
  const long long B = static_cast<long long>(n) * sp;
  const unsigned grid = static_cast<unsigned>((B + tl - 1) / tl);
  hb::randousha_extract_kernel<<<grid, tl * wg, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cols), static_cast<const int4*>(band),
      static_cast<uint32_t*>(keep), static_cast<uint32_t*>(z), n, sp, n_out,
      n_outp, tl, hb::extract_fold_const(init, bias));
  return static_cast<int>(cudaGetLastError());
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
  // lane dst * sp + sl: operand (source) i at cols[((w*n + dst)*n + i)*sp
  // + sl]
  const hb::gemm::EncodeMap mp{nl * s, s, nl * nl * s, nl * s, 1, s, n, n};
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
