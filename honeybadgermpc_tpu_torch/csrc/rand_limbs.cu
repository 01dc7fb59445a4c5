// rand_limbs: uniform field elements from a Threefry key.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/pallas_field.py::
// rand_limbs_pallas (_rand_kernel). Same function, bit for bit: element e
// draws Threefry-2x32-20 with counters (s, e), s = 0..5, and takes the
// words w0, w1 of each call — 12 words, 384 bits T — to T * 2^-144 mod p.
// The canonical limbs are used directly as the Montgomery representation.
//
//   out  uint32 [L, numel]   limb j of element e at out[j*numel + e]
//
// What bounds it on an H100: the kernel reads nothing and writes 64 B per
// element (0.0068 ms at the open path's 354,816 elements); the function
// needs about 570 32-bit integer instructions per element (6 x 20 Threefry
// rounds, the 384-bit REDC on 32-bit words), 0.0060 ms at the card's
// instruction rate. The two are of one order, so the arithmetic must stay
// in registers and run under the stores.
//
// Design:
//   reduction  field_core.cuh's redc384_words, shared with the deal's draw
//              (band_gemm.cuh's DrawSrc): four 32-bit Montgomery rounds and
//              one 16-bit round, the quotient of the reference's nine
//              16-bit rounds (its 16-bit limbs spent about 1,300
//              instructions per element). The 8 result words split into
//              the 16 limbs of the output.
//   grid       as many blocks as are resident on the card at once (the
//              occupancy of the compiled kernel on this device), each
//              thread walking the elements with a grid stride: no partly
//              filled second wave. A thread takes RAND_EPT elements per
//              pass, stride apart, so that their Threefry chains overlap.
//   stores     element e is the counter; limb j of neighbouring threads'
//              elements lies at neighbouring addresses (128 B per warp
//              store).
#include "field_core.cuh"

namespace hb {

constexpr int RAND_THREADS = 256;
constexpr int RAND_EPT = 2;     // elements per thread and pass

__global__ void __launch_bounds__(RAND_THREADS)
    rand_limbs_kernel(uint32_t k0, uint32_t k1, uint32_t* __restrict__ out,
                      long long numel) {
  const long long stride = static_cast<long long>(gridDim.x) * RAND_THREADS;
  for (long long e0 = static_cast<long long>(blockIdx.x) * RAND_THREADS +
                      threadIdx.x;
       e0 < numel; e0 += RAND_EPT * stride) {
    uint32_t x[RAND_EPT][12];
#pragma unroll
    for (int u = 0; u < RAND_EPT; ++u) {
      // an element past the end is drawn and not stored
      const uint32_t c1 = static_cast<uint32_t>(e0 + u * stride);
#pragma unroll
      for (uint32_t s = 0; s < 6; ++s)
        threefry2x32(k0, k1, s, c1, x[u][2 * s], x[u][2 * s + 1]);
    }
    uint32_t words[RAND_EPT][PL];
#pragma unroll
    for (int u = 0; u < RAND_EPT; ++u)
      redc384_words(x[u], words[u]);
#pragma unroll
    for (int u = 0; u < RAND_EPT; ++u) {
      const long long e = e0 + u * stride;
      if (e < numel) {
#pragma unroll
        for (int w = 0; w < PL; ++w) {
          out[static_cast<size_t>(2 * w) * numel + e] = words[u][w] & MASK;
          out[static_cast<size_t>(2 * w + 1) * numel + e] = words[u][w] >> 16;
        }
      }
    }
  }
}

// Elements one pass of the resident grid draws on the current device
// (blocks resident on all SMs x threads x RAND_EPT), or a negative CUDA
// error. Found once per process.
long long rand_wave() {
  static long long per_wave = 0;
  if (per_wave > 0) return per_wave;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rand_limbs_kernel, RAND_THREADS, 0);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  per_wave = static_cast<long long>(nsm) * per_sm * RAND_THREADS * RAND_EPT;
  return per_wave;
}

}  // namespace hb

extern "C" long long hb_rand_limbs_wave() { return hb::rand_wave(); }

extern "C" int hb_rand_limbs(uint32_t k0, uint32_t k1, void* out,
                             long long numel, void* stream) {
  const long long per_wave = hb::rand_wave();
  if (per_wave <= 0) return static_cast<int>(-per_wave);
  // passes of the resident grid the launch is sized for; the grid-stride
  // loop takes the rest
  const long long waves = 1;
  const long long per_block = hb::RAND_THREADS * hb::RAND_EPT;
  long long blocks = (numel + per_block - 1) / per_block;
  const long long cap = waves * per_wave / per_block;
  if (blocks > cap) blocks = cap;
  hb::rand_limbs_kernel<<<static_cast<unsigned>(blocks), hb::RAND_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<uint32_t*>(out), numel);
  return static_cast<int>(cudaGetLastError());
}
