// open_direct: the whole n-party batch open as one kernel.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/fused_open_direct.py::
// _direct_kernel (called through _direct_call). Same function: for every
// opened share b (a "lane"), contract the first k parties' packed shares
// with the Lagrange band; the lam0 column is the secret, the lam_z columns
// predict the shares of parties k..n-1, which are XOR-compared with the
// received ones; mismatches are counted per offending source party.
//
//   packed  uint32 [PL, n, B]   shares, at-rest packed format
//   band    int8   [ceil((nv+1)/2), k, 2048]  band_gemm tiles of the nv+1
//                               columns [lam(points[k:]) | lam0]; on the
//                               large-k route int4 [nv+1, k, 2, 32]
//                               mma.sync fragments
//   sec     uint32 [PL, B]      opened secrets (written directly, ragged
//                               edge masked; no lane-major staging)
//   errs    int32  [nv]         zeroed by the caller; += mismatches
//
// What bounds it on an H100: operations. Per opened share the int8 dot is
// (n-k+1) columns x 32 diagonals x 32k digits (0.97 M MAC at n=64, k=22)
// against 32n + 32 bytes of traffic, far above the card's int8 ridge; the
// fold/REDC epilogue (CUDA cores, about 450 instructions per lane and
// column) comes on top of the dot.
//
// Design. open_direct_kernel runs on band_gemm.cuh's core: lane g = b, one
// group of B lanes (C = B), operand i (party i's share) at packed[w, i, b];
// the band is the direct band's nv+1 columns in band_gemm tiles
// (ops/fused_open_direct.py::_direct_tiles, the same tiles as K2's R1
// band). The planes of a block's 64 MB lanes stay in shared memory while
// the tiles stream through it; wgmma on the tensor cores; the fold
// straight from the accumulators. The epilogue is CompareEpi with the
// SOURCE charge: column col < nv compares the prediction with party
// k + col's share (fetched ahead of the fold), and the 16 lanes of a
// column half of a warp reduce their mismatches with one ballot and popc
// into one atomicAdd per warp, column and 64-lane block when not 0 (honest
// shares: none); column nv (lam0) stores the secrets at lane b,
// lane-contiguous. The TPU kernel carried its mismatch accumulator across
// a sequential grid; here blocks run in no order and integer adds are
// order-free.
//
// The core holds a 64-lane block's planes (2 KB per operand) beside its
// band rings only for k <= 81 (ops/band_gemm.py::smem_bytes). Above that,
// up to KMAX_DIRECT = 128, the wrapper routes to open_direct_mma_kernel
// (ops/fused_open_direct.py::_direct_route) on field_core.cuh's mma.sync
// core: a block owns TL lanes and WG column slots (TL*WG threads; a warp
// is 32 lanes of one slot), builds its lanes' balanced digit planes once
// (8k words per lane), and after one barrier every warp walks its slot's
// columns on its own: band fragments from device memory
// (ops/fused_open.py::_kernel_band), mma.sync.m16n8k32.s8, a per-warp
// transpose to one lane per thread, the fold/REDC epilogue in registers.
// Its counts are reduced per block in shared memory (warp ballot ->
// shared atomicAdd) and added to the global vector with one atomicAdd per
// column and block.
// k <= 128 keeps every int32 diagonal below 2^26 (the wrapper asserts it).
#include "band_gemm.cuh"

namespace hb {

template <int MB>
__global__ void __launch_bounds__(gemm::threads(MB), 1)
    open_direct_kernel(const uint32_t* __restrict__ packed,
                       const unsigned char* __restrict__ band,
                       gemm::EncodeMap mp, gemm::WordFold wf,
                       gemm::CompareEpi<gemm::Charge::Source> epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm::band_gemm_body<MB>(smem, gemm::LoadSrc{packed}, band, mp, wf, epi);
}

__global__ void open_direct_mma_kernel(const uint32_t* __restrict__ packed,
                                       const int4* __restrict__ band,
                                       uint32_t* __restrict__ sec,
                                       int* __restrict__ errs, int n, int k,
                                       long long B, int tl, FoldConst fc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wg = blockDim.x / tl;
  const int tid = threadIdx.x;
  const int laneid = tid & 31;
  const int slot = tid / tl;               // column slot of this warp
  const int lane = tid - slot * tl;        // lane within the block
  const long long b = static_cast<long long>(blockIdx.x) * tl + lane;
  const bool valid = b < B;
  const int nv = n - k;
  const int stride = tl + 8;
  const BandSmem s = band_smem_carve(smem, k, tl, wg);
  int* s_err = s.tail;                     // nv ints
  int* s_d = s.stage + (tid >> 5) * 32 * D_STRIDE;

  for (int i = tid; i < nv; i += blockDim.x) s_err[i] = 0;

  // digit planes of the first k parties' shares; slot j takes parties
  // j, j+wg, ... of its lane
  for (int i = slot; i < k; i += wg) {
    uint32_t carry = 0;
#pragma unroll
    for (int w = 0; w < PL; ++w) {
      const uint32_t word =
          valid ? packed[(static_cast<size_t>(w) * n + i) * B + b] : 0u;
      s.planes[(i * PL + w) * stride + lane] = balance_word(word, carry);
    }
  }

  __syncthreads();                         // planes and counters are ready

  // no block barrier below: each warp walks its slot's columns on its own
  for (int col = slot; col <= nv; col += wg) {
    // received share of party k+col, in flight while the dot runs
    uint32_t recv[PL];
#pragma unroll
    for (int w = 0; w < PL; ++w)
      recv[w] = (valid && col < nv)
                    ? packed[(static_cast<size_t>(w) * n + (k + col)) * B + b]
                    : 0u;

    int acc[2][4][4];
    band_mma_column(acc, s.planes, stride, lane - laneid,
                    band + static_cast<size_t>(col) * k * 64, k, laneid);
    int32_t ds[NBAL];
    uint32_t limbs[L], words[PL];
    band_mma_diagonals(acc, s_d, laneid, ds);
    fold_reduce_bal(ds, fc, limbs);
    pack16(limbs, words);

    if (col < nv) {                        // predicted share of party k+col
      uint32_t diff = 0;
      if (valid) {
#pragma unroll
        for (int w = 0; w < PL; ++w) diff |= words[w] ^ recv[w];
      }
      const unsigned bad = __ballot_sync(0xFFFFFFFFu, diff != 0u);
      if (laneid == 0 && bad) atomicAdd(&s_err[col], __popc(bad));
    } else if (valid) {                    // lam0 column: the secrets
#pragma unroll
      for (int w = 0; w < PL; ++w)
        sec[static_cast<size_t>(w) * B + b] = words[w];
    }
  }

  __syncthreads();
  for (int i = tid; i < nv; i += blockDim.x)
    if (s_err[i]) atomicAdd(&errs[i], s_err[i]);
}

}  // namespace hb

// packed [PL, n, B]; band: the direct band in band_gemm tiles (nv + 1
// columns); sec [PL, B]; errs: nerr + k, int32 [nv] zeroed by the caller;
// mb: 64-lane blocks per thread block (ops/band_gemm.py::_gemm_plan); fold:
// _word_fold_consts(k). For k <= 81.
extern "C" int hb_open_direct(const void* packed, const void* band, void* sec,
                              void* errs, int n, int k, long long B, int mb,
                              const uint32_t* fold, void* stream) {
  const hb::gemm::EncodeMap mp{B, B, static_cast<long long>(n) * B, 0, 1, B,
                               k, n - k + 1};
  const hb::gemm::CompareEpi<hb::gemm::Charge::Source> epi{
      static_cast<uint32_t*>(sec), static_cast<int*>(errs),
      static_cast<const uint32_t*>(packed), n - k};
  switch (mb) {
    case 4:
      return hb::gemm::launch<4>(hb::open_direct_kernel<4>, packed, band, mp,
                                 epi, fold, stream);
    case 2:
      return hb::gemm::launch<2>(hb::open_direct_kernel<2>, packed, band, mp,
                                 epi, fold, stream);
    case 1:
      return hb::gemm::launch<1>(hb::open_direct_kernel<1>, packed, band, mp,
                                 epi, fold, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The large-k route: packed [PL, n, B]; band: the direct band in mma.sync
// fragments [nv+1, k, 2, 32, 4]; tl, wg: ops/fused_open.py::_smem_plan(k);
// init, bias: the fold constants.
extern "C" int hb_open_direct_mma(const void* packed, const void* band,
                                  void* sec, void* errs, int n, int k,
                                  long long B, int tl, int wg,
                                  const uint32_t* init, int bias,
                                  void* stream) {
  hb::FoldConst fc;
  for (int j = 0; j < hb::NL; ++j) fc.init[j] = init[j];
  fc.bias = bias;
  const size_t smem = hb::band_smem_bytes(k, tl, wg, n - k);
  cudaError_t err = cudaFuncSetAttribute(
      hb::open_direct_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + tl - 1) / tl);
  hb::open_direct_mma_kernel<<<grid, tl * wg, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int4*>(band),
      static_cast<uint32_t*>(sec), static_cast<int*>(errs), n, k, B, tl, fc);
  return static_cast<int>(cudaGetLastError());
}
