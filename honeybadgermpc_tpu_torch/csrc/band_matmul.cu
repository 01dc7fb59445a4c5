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
//   band  int4   [m, k, 2, 32]   column, k-step (= operand), m-tile, thread:
//                                the A fragments of mma.m16n8k32 in the
//                                order the threads load them
//                                (ops/fused_open.py::_kernel_band)
//   out   uint32 [PL, B, m]      packed results
//
// The TPU version re-tiled the operand to [nblk, PL, k, TBW] blocks with a
// transpose pass each way; here the kernel indexes [PL, B, k] directly.
//
// What bounds it on an H100: operations. Per batch row the int8 dot is
// m columns x 32 diagonals x 32k digits (1.44 M MAC at k=22, m=64) against
// 32(k+m) bytes of traffic; the fold/REDC epilogue on the CUDA cores comes
// on top of the dot.
//
// Design: the same shape as open_direct.cu. A block owns TL batch rows
// (lanes) and WG column slots. The block's operand words [w][TL*k] are
// contiguous in memory, so the threads read them coalesced, one (row, i)
// item each with its carry chain over w, and scatter the balanced digit
// words into shared memory. After one barrier every warp walks its slot's
// columns on its own: band fragments read straight from device memory
// (L1/L2 hits), the dot on the tensor cores (mma.sync.m16n8k32.s8), the
// per-warp transpose to one lane per thread, the fold/REDC epilogue in
// registers, and 8 packed words written to out[w, b, col].
#include "field_core.cuh"

namespace hb {

__global__ void band_matmul_kernel(const uint32_t* __restrict__ a,
                                   const int4* __restrict__ band,
                                   uint32_t* __restrict__ out, long long B,
                                   int k, int m, int tl, FoldConst fc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wg = blockDim.x / tl;
  const int tid = threadIdx.x;
  const int laneid = tid & 31;
  const int slot = tid / tl;               // column slot of this warp
  const int lane = tid - slot * tl;        // lane within the block
  const long long b0 = static_cast<long long>(blockIdx.x) * tl;
  const long long b = b0 + lane;
  const bool valid = b < B;
  const int stride = tl + 8;
  const BandSmem s = band_smem_carve(smem, k, tl, wg);
  int* s_d = s.stage + (tid >> 5) * 32 * D_STRIDE;

  // digit planes of the block's rows: item idx = (row bl, operand i)
  for (int idx = tid; idx < tl * k; idx += blockDim.x) {
    const int bl = idx / k;
    const int i = idx - bl * k;
    const bool in = b0 + bl < B;
    uint32_t carry = 0;
#pragma unroll
    for (int w = 0; w < PL; ++w) {
      const uint32_t word =
          in ? a[(static_cast<size_t>(w) * B + b0) * k + idx] : 0u;
      s.planes[(i * PL + w) * stride + bl] = balance_word(word, carry);
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
        out[(static_cast<size_t>(w) * B + b) * m + col] = words[w];
    }
  }
}

}  // namespace hb

extern "C" int hb_band_matmul(const void* a, const void* band, void* out,
                              long long B, int k, int m, int tl, int wg,
                              const uint32_t* init, int bias,
                              void* stream) {
  hb::FoldConst fc;
  for (int j = 0; j < hb::NL; ++j) fc.init[j] = init[j];
  fc.bias = bias;
  const size_t smem = hb::band_smem_bytes(k, tl, wg, 0);
  cudaError_t err = cudaFuncSetAttribute(
      hb::band_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + tl - 1) / tl);
  hb::band_matmul_kernel<<<grid, tl * wg, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const int4*>(band),
      static_cast<uint32_t*>(out), B, k, m, tl, fc);
  return static_cast<int>(cudaGetLastError());
}
