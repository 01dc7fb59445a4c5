// mxu_core.cuh: the shared core of the GF(p) matmuls through unsigned 7-bit
// digit planes (csrc/mxu_fused2.cu, csrc/mxu_fused.cu, csrc/mxu_redc.cu).
//
// A GF(p) product sum_kk a[b, kk] * v[kk, col] in Montgomery form becomes an
// integer convolution of base-2^7 digits: digit d (0..36) of a 256-bit
// value covers bits [7d, 7d+7), so every digit is 0..127 and fits int8 as
// it is. An int8 dot on the tensor cores gives "diagonals" (int32, each
// below 37 k 127^2 < 2^31), and an integer epilogue folds them into 16-bit
// carry-save limbs and reduces:
//   * fold37: 37 diagonals of the folded-constant scheme, `ROUNDS` REDC
//     rounds of 16 bits, two conditional subtracts (the reference's
//     _fold_reduce, mxu_matmul.py);
//   * redc73: 73 product diagonals, 17 REDC rounds, one conditional
//     subtract (the reference's _redc_diagonals).
// Both fold adjacent diagonals in pairs, e = d_2i + (d_2i+1 << 7), only
// where that sum cannot pass 2^32 (PAIR: 129 * 37 k 127^2 < 2^32, k <= 55);
// otherwise each diagonal is added on its own. (The reference always pairs
// and so wraps once a diagonal reaches 2^25, which uniform inputs do from
// about k = 230; the port keeps the true product.)
//
// mxu_stream_kernel is the k-streamed int8 dot with a fused epilogue: a
// block of NTHREADS threads owns `tl` batch rows (lanes) and NTHREADS / tl
// column slots. Per chunk of up to KC = 32 operands (32 x 37 = 1184 digit
// rows = 37 k-steps of 32), the block reads its rows' limbs coalesced, cuts
// them into digits and stores them as bytes of the digit-plane words
// [rows/4][tl + 8] in shared memory, digit row q = kk*37 + d. Each warp
// then runs the chunk's k-steps for one column: band fragments (the A
// operand, MT m-tiles of 16 diagonals) read from device memory one k-step
// ahead, MT x 4 n-tiles of mma.sync.m16n8k32.s8 per k-step, accumulators
// in registers across the chunks. After the last chunk a per-warp
// transpose through shared memory leaves each thread the diagonals of one
// lane, and the epilogue writes its 16 limbs. When k fits one chunk the
// digits are built once and every warp walks its columns without a block
// barrier; otherwise the block rebuilds the chunks once per pass over its
// column slots.
//
//   a     int32 [L, B, k]                 limbs
//   band  int4  [n][ksteps][MT][32]       column, k-step of 32 digit rows,
//                                         m-tile of 16 diagonals, thread:
//                                         the A fragments of m16n8k32 in
//                                         the order the threads load them
//   out   int32 [L, B, n]                 limbs
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace hbmxu {

constexpr int L = 16;
constexpr int KC = 32;               // operands per streamed chunk
constexpr int NPLANES = 37;
constexpr int CHUNK_STEPS = KC * NPLANES / 32;   // 37 k-steps per chunk
constexpr int D_STRIDE = 40;         // staging row stride (ints) per warp
constexpr uint32_t MASK = 0xFFFFu;
constexpr uint32_t N0 = 0xFFFFu;

static __device__ __constant__ uint32_t kP[L] = {
    0x0001u, 0x0000u, 0xFFFFu, 0xFFFFu, 0x5BFEu, 0xFFFEu, 0xA402u, 0x53BDu,
    0xD805u, 0x09A1u, 0xD808u, 0x3339u, 0x7D48u, 0x299Du, 0xA753u, 0x73EDu};

__device__ __forceinline__ void mma_s8(int (&c)[4], const int4& a, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// t (carry-save 16-bit limbs) += e * 2^bit, as three 16-bit chunks added
// at limbs j, j+1, j+2.
template <int NL>
__device__ __forceinline__ void add_at_bit(uint32_t (&t)[NL], uint32_t e,
                                           int bit) {
  const int j = bit >> 4, r = bit & 15;
  const uint32_t elo = e & MASK, ehi = e >> 16;
  t[j] += (elo << r) & MASK;
  if (j + 1 < NL)
    t[j + 1] += ((r ? (elo >> (16 - r)) : 0u) | ((ehi << r) & MASK)) & MASK;
  if (j + 2 < NL) t[j + 2] += r ? (ehi >> (16 - r)) : 0u;
}

// ND diagonals at 7-bit spacing -> NL carry-save limbs.
template <int NL, int ND, bool PAIR>
__device__ __forceinline__ void fold_diagonals(const int32_t (&ds)[ND],
                                               uint32_t (&t)[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) t[j] = 0u;
  if (PAIR) {
#pragma unroll
    for (int i = 0; i + 1 < ND; i += 2)
      add_at_bit(t, static_cast<uint32_t>(ds[i]) +
                        (static_cast<uint32_t>(ds[i + 1]) << 7), 7 * i);
    if (ND % 2)
      add_at_bit(t, static_cast<uint32_t>(ds[ND - 1]), 7 * (ND - 1));
  } else {
#pragma unroll
    for (int i = 0; i < ND; ++i)
      add_at_bit(t, static_cast<uint32_t>(ds[i]), 7 * i);
  }
}

// One 16-bit Montgomery REDC round: t <- (t + m p) >> 16.
template <int NL>
__device__ __forceinline__ void redc_round(uint32_t (&t)[NL]) {
  const uint32_t m = ((t[0] & MASK) * N0) & MASK;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t pr = m * kP[j];
    t[j] += pr & MASK;
    t[j + 1] += pr >> 16;
  }
  const uint32_t carry0 = t[0] >> 16;
#pragma unroll
  for (int j = 0; j + 1 < NL; ++j) t[j] = t[j + 1];
  t[NL - 1] = 0u;
  t[0] += carry0;
}

// t[0..L) -> canonical limbs and the carry out.
template <int NL>
__device__ __forceinline__ uint32_t carry_chain(const uint32_t (&t)[NL],
                                                uint32_t (&out)[L]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = t[j] + c;
    out[j] = v & MASK;
    c = v >> 16;
  }
  return c;
}

// value hi*2^256 + x (< 3p) -> one conditional subtract of p.
__device__ __forceinline__ void cond_sub_wide(uint32_t (&x)[L],
                                              uint32_t& hi) {
  uint32_t d[L], borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = x[j] - kP[j] - borrow;
    d[j] = v & MASK;
    borrow = (v >> 16) & 1u;
  }
  const bool take = (hi != 0u) | (borrow == 0u);
  hi = take ? hi - borrow : hi;
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = take ? d[j] : x[j];
}

// 37 diagonals of the folded scheme -> canonical limbs of V / 2^(16 ROUNDS)
// mod p (V < 3p 2^(16 ROUNDS)).
template <int ROUNDS, bool PAIR>
struct Fold37 {
  static constexpr int NDIAG = NPLANES;
  __device__ __forceinline__ static void run(const int32_t (&ds)[NDIAG],
                                             uint32_t (&out)[L]) {
    constexpr int NL = 19;
    uint32_t t[NL];
    fold_diagonals<NL, NDIAG, PAIR>(ds, t);
#pragma unroll
    for (int round = 0; round < ROUNDS; ++round) redc_round(t);
    uint32_t hi = carry_chain(t, out) + t[L];
    cond_sub_wide(out, hi);
    cond_sub_wide(out, hi);
  }
};

// 73 product diagonals (v pre-scaled by 2^16 R) -> canonical Montgomery
// limbs: 36 carry-save limbs, 17 REDC rounds (divide by 2^272), one
// conditional subtract.
template <bool PAIR>
struct Redc73 {
  static constexpr int NDIAG = 2 * NPLANES - 1;
  __device__ __forceinline__ static void run(const int32_t (&ds)[NDIAG],
                                             uint32_t (&out)[L]) {
    constexpr int NL = 36;
    uint32_t t[NL];
    fold_diagonals<NL, NDIAG, PAIR>(ds, t);
#pragma unroll
    for (int round = 0; round < 17; ++round) redc_round(t);
    uint32_t hi = carry_chain(t, out);
    cond_sub_wide(out, hi);
  }
};

template <int MT, int NTHREADS, class Epi>
__global__ void __launch_bounds__(NTHREADS, 1)
    mxu_stream_kernel(const uint32_t* __restrict__ a,
                      const int4* __restrict__ band,
                      uint32_t* __restrict__ out, long long B, int k, int n,
                      int tl, int ksteps) {
  constexpr int ND = Epi::NDIAG;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nslots = NTHREADS / tl;
  const int tid = threadIdx.x;
  const int laneid = tid & 31;
  const int slot = tid / tl;
  const int lane = tid - slot * tl;
  const long long b0 = static_cast<long long>(blockIdx.x) * tl;
  const int stride = tl + 8;
  const int rows_max = min(ksteps, CHUNK_STEPS) * 32;
  const int nchunks = (k + KC - 1) / KC;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  int* s_d = reinterpret_cast<int*>(planes + (rows_max / 4) * stride) +
             (tid >> 5) * ND * D_STRIDE;
  const size_t Bk = static_cast<size_t>(B) * k;

  // digits of the block's rows for operands [32c, 32c + kc): item = (row
  // bl, operand kq), neighbouring threads on neighbouring operands. Rows
  // past the chunk's last digit are left as they are: the band is zero
  // there, and so is their product.
  auto build = [&](int c) {
    const int kk0 = c * KC;
    const int kc = min(KC, k - kk0);
    for (int idx = tid; idx < tl * kc; idx += NTHREADS) {
      const int bl = idx / kc;
      const int kq = idx - bl * kc;
      if (b0 + bl >= B) continue;
      const size_t off = static_cast<size_t>(b0 + bl) * k + kk0 + kq;
      uint32_t l[L];
#pragma unroll
      for (int j = 0; j < L; ++j) l[j] = a[j * Bk + off];
#pragma unroll
      for (int d = 0; d < NPLANES; ++d) {
        const int j = (7 * d) >> 4, r = (7 * d) & 15;
        uint32_t v = l[j] >> r;
        if (r > 9 && j + 1 < L) v |= l[j + 1] << (16 - r);
        const int q = kq * NPLANES + d;
        smem[((q >> 2) * stride + bl) * 4 + (q & 3)] =
            static_cast<unsigned char>(v & 0x7Fu);
      }
    }
  };

  const int g = laneid >> 2, tg = laneid & 3;
  const int lane0 = lane - laneid;
  const long long b = b0 + lane;
  const size_t Bn = static_cast<size_t>(B) * n;
  const bool stream = nchunks > 1;
  if (!stream) {
    build(0);
    __syncthreads();                     // planes are ready
  }
  // passes over the column slots; every thread takes the same number, so
  // the block barriers of the streamed case are reached by all
  for (int col0 = 0; col0 < n; col0 += nslots) {
    const int col = col0 + slot;
    int acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;
    for (int c = 0; c < nchunks; ++c) {
      if (stream) {
        __syncthreads();                 // the previous chunk's reads are done
        build(c);
        __syncthreads();
      }
      if (col >= n) continue;
      const int ks0 = c * CHUNK_STEPS;
      const int ks1 = min(ksteps, ks0 + CHUNK_STEPS);
      const int4* ap = band + static_cast<size_t>(col) * ksteps * MT * 32 +
                       laneid;
      int4 af[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) af[mt] = __ldg(ap + (ks0 * MT + mt) * 32);
      for (int ks = ks0; ks < ks1; ++ks) {
        int4 nf[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)   // next k-step's fragments, in flight
          nf[mt] = (ks + 1 < ks1) ? __ldg(ap + ((ks + 1) * MT + mt) * 32)
                                  : af[mt];
        const uint32_t* p0 =
            planes + ((ks - ks0) * 8 + tg) * stride + lane0 + g;
        const uint32_t* p1 = p0 + 4 * stride;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int b0w = static_cast<int>(p0[nt * 8]);
          const int b1w = static_cast<int>(p1[nt * 8]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_s8(acc[mt][nt], af[mt], b0w, b1w);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) af[mt] = nf[mt];
      }
    }
    if (col >= n) continue;
    // transpose: thread laneid takes the diagonals of lane lane0 + laneid
    __syncwarp();                        // the previous column's reads are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + h * 8;
          if (r < ND)
            *reinterpret_cast<int2*>(s_d + r * D_STRIDE + nt * 8 + 2 * tg) =
                make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
    __syncwarp();
    int32_t ds[ND];
#pragma unroll
    for (int r = 0; r < ND; ++r) ds[r] = s_d[r * D_STRIDE + laneid];
    uint32_t limbs[L];
    Epi::run(ds, limbs);
    if (b < B) {
#pragma unroll
      for (int j = 0; j < L; ++j)
        out[j * Bn + static_cast<size_t>(b) * n + col] = limbs[j];
    }
  }
}

// Launch one instance, one block per `tl` rows. `smem` is the wrapper's
// plan (ops/mxu_matmul.py _stream_plan): the digit planes of one chunk,
// min(ksteps, 37) * 32 rows x (tl + 8) bytes, and ND x D_STRIDE ints of
// staging per warp.
template <int MT, int NTHREADS, class Epi>
int launch_stream(const void* a, const void* band, void* out, long long B,
                  int k, int n, int tl, int ksteps, int smem, void* stream) {
  auto kern = mxu_stream_kernel<MT, NTHREADS, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + tl - 1) / tl);
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const int4*>(band),
      static_cast<uint32_t*>(out), B, k, n, tl, ksteps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hbmxu
