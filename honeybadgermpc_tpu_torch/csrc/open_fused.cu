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
//                [Minv | lam(points[k:])]: columns 0..k-1 are the k secret
//                coefficients -> sec [PL, k, C]; columns k..n-1 predict
//                the other psi values; mismatches go to errs[0]
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
// K1, K2 and KC run on band_gemm.cuh's core (wgmma, the band streamed
// through shared memory, the epilogue straight from the accumulators),
// lane g = grp * C + c with the chunk index c contiguous. K1's epilogue is
// a plain store. K2's and KC's are band_gemm.cuh's CompareEpi on the same
// band (K2's R1 band): columns 0..nv-1 compared with the received words,
// loaded ahead of the fold, each lane's mismatch count kept in a register
// and added to errs[destination] (K2) or errs[lane] (KC) with one
// atomicAdd when it is not 0 (honest shares: no atomics); column nv
// stored. KC's lanes are the check tensor's (col, slot) pairs as one group
// (C = lanes).
//
// K3 keeps the mma.sync design of field_core.cuh: a block owns TL lanes
// and WG column slots; it builds its lanes' balanced digit planes once in
// shared memory; every warp then walks its slot's columns with no block
// barrier: band fragments from device memory one k-step ahead,
// mma.sync.m16n8k32.s8, a per-warp transpose to one lane per thread, the
// fold/REDC epilogue in registers, then a store (columns 0..k-1, the
// secret coefficients) or a compare (columns k..n-1). Lane c's operand i,
// word w is src[w*sw + i*C + c]. Each thread keeps its mismatch count in a
// register and adds it to errs[0] with one atomicAdd at the end, when it
// is not 0. Integer adds: order-free.
#include "band_gemm.cuh"

namespace hb {

// K3: lane c of C; operand i, word w at src[w*n*C + i*C + c]; columns
// 0..k-1 go to sec [PL, k, C], columns k..n-1 are compared with operand col.
__global__ void open_fused_k3_kernel(const uint32_t* __restrict__ src,
                                     const int4* __restrict__ band,
                                     uint32_t* __restrict__ sec,
                                     int* __restrict__ errs, int n, int k,
                                     long long C, int tl, FoldConst fc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wg = blockDim.x / tl;
  const int tid = threadIdx.x;
  const int laneid = tid & 31;
  const int slot = tid / tl;               // column slot of this warp
  const int lane = tid - slot * tl;        // lane within the block
  const long long c = static_cast<long long>(blockIdx.x) * tl + lane;
  const bool valid = c < C;
  const size_t sw = static_cast<size_t>(n) * C;
  const int stride = tl + 8;
  const BandSmem s = band_smem_carve(smem, k, tl, wg);
  int* s_d = s.stage + (tid >> 5) * 32 * D_STRIDE;

  // digit planes of the lane's k operands; slot j takes operands
  // j, j+wg, ...
  for (int i = slot; i < k; i += wg) {
    uint32_t carry = 0;
#pragma unroll
    for (int w = 0; w < PL; ++w) {
      const uint32_t word =
          valid ? src[w * sw + static_cast<size_t>(i) * C + c] : 0u;
      s.planes[(i * PL + w) * stride + lane] = balance_word(word, carry);
    }
  }

  __syncthreads();                         // planes are ready

  int bad = 0;
  for (int col = slot; col < n; col += wg) {
    // the operand this column's prediction is checked against, if any
    const bool cmp = col >= k;
    uint32_t recv[PL];
#pragma unroll
    for (int w = 0; w < PL; ++w)
      recv[w] = (valid && cmp)
                    ? src[w * sw + static_cast<size_t>(col) * C + c]
                    : 0u;

    int acc[2][4][4];
    band_mma_column(acc, s.planes, stride, lane - laneid,
                    band + static_cast<size_t>(col) * k * 64, k, laneid);
    int32_t ds[NBAL];
    uint32_t limbs[L], words[PL];
    band_mma_diagonals(acc, s_d, laneid, ds);
    fold_reduce_bal(ds, fc, limbs);
    pack16(limbs, words);

    if (!valid) continue;
    if (cmp) {
      bad += mismatch(words, recv) ? 1 : 0;
      continue;
    }
    const size_t at = static_cast<size_t>(col) * C + c;
    const size_t plane = static_cast<size_t>(k) * C;
#pragma unroll
    for (int w = 0; w < PL; ++w) sec[w * plane + at] = words[w];
  }
  // the column slots of a lane add into one count: integer adds, order-free
  if (bad) atomicAdd(&errs[0], bad);
}

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
    randousha_check_kernel(const uint32_t* __restrict__ chk,
                           const unsigned char* __restrict__ band,
                           gemm::EncodeMap mp, gemm::WordFold wf,
                           CheckEpi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{chk}, band, mp, wf, epi);
}

// Dynamic shared memory of a launch, allowed above 48 KB for `kernel`.
template <typename Kernel>
int prepare(Kernel kernel, int k, int tl, int wg, size_t* smem) {
  *smem = band_smem_bytes(k, tl, wg, 0);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

FoldConst fold_const(const uint32_t* init, int bias) {
  FoldConst fc;
  for (int j = 0; j < NL; ++j) fc.init[j] = init[j];
  fc.bias = bias;
  return fc;
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

// src: vals [PL, n, C]; band: K3's band in mma.sync fragments; out: sec
// [PL, k, C]; errs: int32 [1], zeroed by the caller; tl, wg: _smem_plan(k).
extern "C" int hb_open_fused_k3(const void* src, const void* band, void* out,
                                void* errs, int n, int k, long long C,
                                int tl, int wg, const uint32_t* init,
                                int bias, void* stream) {
  size_t smem = 0;
  const int rc = hb::prepare(hb::open_fused_k3_kernel, k, tl, wg, &smem);
  if (rc != 0) return rc;
  const unsigned grid = static_cast<unsigned>((C + tl - 1) / tl);
  hb::open_fused_k3_kernel<<<grid, tl * wg, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const int4*>(band),
      static_cast<uint32_t*>(out), static_cast<int*>(errs), n, k, C, tl,
      hb::fold_const(init, bias));
  return static_cast<int>(cudaGetLastError());
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
