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
//   band  int4   [m, k, 2, 32]  column, k-step (= coefficient), m-tile,
//                               thread: the A fragments of mma.m16n8k32
//                               (ops/fused_open.py::_kernel_band)
//   out   uint32 [PL, m, B]     the receive tensor: B = n*sp flat lanes, so
//                               this is [PL, dst, src, sp]; the extraction
//                               reads one destination's n sources as n
//                               contiguous rows of sp words
//
// What bounds it on an H100: operations. Per lane the int8 dot is m columns
// x 32 diagonals x 32k digits against 32m bytes written (nothing is read
// but the band); the sampler (about 1200 integer instructions per
// coefficient) and the fold/REDC epilogue (about 450 per column) run on the
// CUDA cores on top of the dot.
//
// Design: the shape of band_matmul.cu with the operand load replaced by the
// sampler. A block owns TL lanes and WG column slots; thread (slot, lane)
// draws coefficients slot, slot+WG, ... of its lane in registers and writes
// their balanced digit words to shared memory. After one barrier every warp
// walks its slot's columns on its own (band fragments from device memory,
// the dot on the tensor cores, per-warp transpose, fold/REDC in registers)
// and stores 8 words per lane; a warp's 32 lanes are 32 neighbouring
// addresses of each output row.
#include "field_core.cuh"

namespace hb {

constexpr uint32_t DEAL_CTR_TAG = 0x10000u;

__global__ void randousha_deal_kernel(uint32_t key0, uint32_t key1,
                                      const int4* __restrict__ band,
                                      uint32_t* __restrict__ out,
                                      long long B, int k, int row1, int m,
                                      int tl, FoldConst fc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wg = blockDim.x / tl;
  const int tid = threadIdx.x;
  const int laneid = tid & 31;
  const int slot = tid / tl;               // column slot of this warp
  const int lane = tid - slot * tl;        // lane within the block
  const long long b = static_cast<long long>(blockIdx.x) * tl + lane;
  const bool valid = b < B;
  const int stride = tl + 8;
  const BandSmem s = band_smem_carve(smem, k, tl, wg);
  int* s_d = s.stage + (tid >> 5) * 32 * D_STRIDE;

  // draw coefficients slot, slot+wg, ... of this lane; digits to shared
  const uint32_t c1 = static_cast<uint32_t>(b);
  for (int i = slot; i < k; i += wg) {
    const uint32_t row = (i == 0) ? 0u : static_cast<uint32_t>(row1 + i - 1);
    const uint32_t c0 = DEAL_CTR_TAG + 8u * row;
    uint32_t rows[25];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      uint32_t w0, w1;
      threefry2x32(key0, key1, c0 + static_cast<uint32_t>(c), c1, w0, w1);
      rows[4 * c + 0] = w0 & MASK;
      rows[4 * c + 1] = w0 >> 16;
      rows[4 * c + 2] = w1 & MASK;
      rows[4 * c + 3] = w1 >> 16;
    }
    rows[24] = 0u;
    uint32_t limbs[L], words[PL];
    redc384(rows, limbs);
    pack16(limbs, words);
    uint32_t carry = 0;
#pragma unroll
    for (int w = 0; w < PL; ++w) {
      const uint32_t word = valid ? words[w] : 0u;
      s.planes[(i * PL + w) * stride + lane] = balance_word(word, carry);
    }
  }

  __syncthreads();                         // planes are ready

  // no block barrier below: each warp walks its slot's columns on its own
  for (int col = slot; col < m; col += wg) {
    int acc[2][4][4];
    band_mma_column(acc, s.planes, stride, lane - laneid,
                    band + static_cast<size_t>(col) * k * 64, k, laneid);
    int32_t ds[NBAL];
    uint32_t limbs[L], words[PL];
    band_mma_diagonals(acc, s_d, laneid, ds);
    fold_reduce_bal(ds, fc, limbs);
    pack16(limbs, words);
    if (valid) {
#pragma unroll
      for (int w = 0; w < PL; ++w)
        out[(static_cast<size_t>(w) * m + col) * B + b] = words[w];
    }
  }
}

}  // namespace hb

extern "C" int hb_randousha_deal(uint32_t key0, uint32_t key1,
                                 const void* band, void* out, long long B,
                                 int k, int row1, int m, int tl, int wg,
                                 const uint32_t* init, int bias,
                                 void* stream) {
  hb::FoldConst fc;
  for (int j = 0; j < hb::NL; ++j) fc.init[j] = init[j];
  fc.bias = bias;
  const size_t smem = hb::band_smem_bytes(k, tl, wg, 0);
  cudaError_t err = cudaFuncSetAttribute(
      hb::randousha_deal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + tl - 1) / tl);
  hb::randousha_deal_kernel<<<grid, tl * wg, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      key0, key1, static_cast<const int4*>(band), static_cast<uint32_t*>(out),
      B, k, row1, m, tl, fc);
  return static_cast<int>(cudaGetLastError());
}
