// mxu_redc: the epilogue of the unfused MXU matmul — 73 int32 base-2^7
// product diagonals per output element -> its canonical Montgomery limbs.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/mxu_matmul.py::_redc_kernel
// (called through fp_matmul_mxu), which runs after an int8 dot of a's 7-bit
// planes against the band of v's (scaled) planes: here the dot is the
// library's int8 matmul outside this kernel, as it was XLA's there. It
// finishes Gao's erasure interpolation from all 64 shares (k = n = 64,
// where the folded MXU kernel does not fit) and every fp_matmul of a batch
// >= 1024 that neither fused kernel takes.
//
// The function is csrc/mxu_core.cuh's Redc73: the diagonals fold into 36
// carry-save limbs (in adjacent pairs where `pair`, k <= 55), 17
// Montgomery REDC rounds of 16 bits divide by 2^272 (the operand v was
// pre-scaled by 2^16 R so the output is the Montgomery form), a carry
// chain over 16 limbs and one conditional subtract of p.
//
// What bounds it on an H100: bytes (73 x 4 read + 64 written per element
// against a few hundred integer instructions).
//
// Design: one thread per output element; the diagonals are laid out
// [73, M], so each of the 73 reads and each of the 16 limb writes is
// coalesced across a warp. Everything else lives in registers, unrolled.
#include "mxu_core.cuh"

namespace hbmxu {

template <bool PAIR>
__global__ void mxu_redc_kernel(const int32_t* __restrict__ d,
                                uint32_t* __restrict__ out, long long M) {
  using Epi = Redc73<PAIR>;
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= M) return;
  int32_t ds[Epi::NDIAG];
#pragma unroll
  for (int i = 0; i < Epi::NDIAG; ++i) ds[i] = d[static_cast<size_t>(i) * M + g];
  uint32_t o[L];
  Epi::run(ds, o);
#pragma unroll
  for (int j = 0; j < L; ++j) out[static_cast<size_t>(j) * M + g] = o[j];
}

}  // namespace hbmxu

extern "C" int hb_mxu_redc(const void* diag, void* out, long long M,
                           int pair, void* stream) {
  const int threads = 128;
  const unsigned grid = static_cast<unsigned>((M + threads - 1) / threads);
  auto kern = pair ? hbmxu::mxu_redc_kernel<true>
                   : hbmxu::mxu_redc_kernel<false>;
  kern<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(diag), static_cast<uint32_t*>(out), M);
  return static_cast<int>(cudaGetLastError());
}
