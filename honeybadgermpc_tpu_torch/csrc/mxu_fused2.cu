// mxu_fused2: GF(p) matrix product a[L, B, k] @ v[L, k, n] -> [L, B, n]
// (Montgomery limbs, int32 16-bit limb planes) through unsigned 7-bit
// digit planes and an int8 dot on the tensor cores against a band folded
// from v, then a short fold/REDC epilogue.
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/mxu_matmul.py::
// _fused2_kernel (called through fp_matmul_mxu2). On this slice it runs
// decode_validate_matmul in the batch open's two rounds: k = 22 shares of
// each of B = 49,152 decodes against n = 43 (round 1) and n = 64 (round 2)
// columns.
//
// The function (the reference's "folded-constant" scheme):
//   * a's digits: digit d (0..36) of a[b, kk] covers bits [7d, 7d+7), so
//     each is 0..127 and fits int8 as it is;
//   * the band, built on the device by the wrapper: for column col, digit
//     d of the data and output diagonal s, the int8 digit s of
//     w[kk, col, d] = v[kk, col] * 2^(7d + 16 rounds) * R^-1 mod p;
//   * diag[b, col, s] = sum over (kk, d) of digit_d(a[b, kk]) *
//     digit_s(w[kk, col, d]), 37 diagonals, each < 37 k 127^2;
//   * the 37 diagonals (7-bit spacing) fold into 19 carry-save 16-bit
//     limbs, `rounds` REDC rounds of 16 bits (1 for k <= 27, else 2), a
//     carry chain and two conditional subtracts give the canonical
//     Montgomery limbs of sum_kk a*v. All of it in uint32 as the
//     reference's _fold_reduce, so the words are the same.
// This is not the balanced base-256 scheme of field_core.cuh: the digits
// are unsigned 7-bit, the diagonals 37, the fold and its constants differ.
//
// What bounds it on an H100: operations, the int8 dot (2 x 37 x 37 k n MAC
// per batch row, padded here to 48 diagonals and k*37 -> a multiple of 32).
//
//   a     int32 [L, B, k]                limbs
//   band  int4  [n][ksteps][3][32]       column, k-step of 32 digit rows,
//                                        m-tile of 16 diagonals, thread:
//                                        the A fragments of mma.m16n8k32 in
//                                        the order the threads load them
//   out   int32 [L, B, n]                limbs
//
// Design, after band_matmul.cu: a block of 512 threads owns TL batch rows
// (lanes) and 512/TL column slots. The block's limbs are read coalesced
// (item = (row, kk), neighbouring threads on neighbouring kk), cut into
// 37 digits each and stored as bytes of the digit-plane words
// [kcols/4][TL + 8] in shared memory, digit row q = kk*37 + d. After one
// barrier each warp walks its slot's columns on its own: band fragments
// read from device memory one k-step ahead (L1/L2 hits), 3 m-tiles x 4
// n-tiles of mma.sync per k-step, a per-warp transpose through shared
// memory that leaves each thread the 37 diagonals of one lane, the fold in
// registers, 16 limbs written to out[j, b, col].
#include <cstdint>
#include <cuda_runtime.h>

namespace hbmxu2 {

constexpr int L = 16;
constexpr int NPLANES = 37;
constexpr int NL = 19;
constexpr int MT = 3;                // m-tiles of 16 diagonals (37 -> 48)
constexpr int THREADS = 512;
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

// e * 2^bit as three 16-bit chunks added at limbs j, j+1, j+2.
__device__ __forceinline__ void add_at_bit(uint32_t (&t)[NL], uint32_t e,
                                           int bit) {
  const int j = bit >> 4, r = bit & 15;
  const uint32_t elo = e & MASK, ehi = e >> 16;
  t[j] += (elo << r) & MASK;
  if (j + 1 < NL)
    t[j + 1] += ((r ? (elo >> (16 - r)) : 0u) | ((ehi << r) & MASK)) & MASK;
  if (j + 2 < NL) t[j + 2] += r ? (ehi >> (16 - r)) : 0u;
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

// 37 diagonals -> canonical limbs of V / 2^(16 ROUNDS) mod p.
template <int ROUNDS>
__device__ __forceinline__ void fold_reduce7(const int32_t (&ds)[NPLANES],
                                             uint32_t (&out)[L]) {
  uint32_t t[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i + 1 < NPLANES; i += 2)
    add_at_bit(t, static_cast<uint32_t>(ds[i]) +
                      (static_cast<uint32_t>(ds[i + 1]) << 7), 7 * i);
  add_at_bit(t, static_cast<uint32_t>(ds[NPLANES - 1]), 7 * (NPLANES - 1));
#pragma unroll
  for (int round = 0; round < ROUNDS; ++round) {
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
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = t[j] + c;
    out[j] = v & MASK;
    c = v >> 16;
  }
  uint32_t hi = c + t[L];
  cond_sub_wide(out, hi);
  cond_sub_wide(out, hi);
}

template <int ROUNDS>
__global__ void __launch_bounds__(THREADS, 1)
    mxu_fused2_kernel(const uint32_t* __restrict__ a,
                      const int4* __restrict__ band,
                      uint32_t* __restrict__ out, long long B, int k, int n,
                      int tl, int kcols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nslots = THREADS / tl;
  const int tid = threadIdx.x;
  const int laneid = tid & 31;
  const int slot = tid / tl;
  const int lane = tid - slot * tl;
  const long long b0 = static_cast<long long>(blockIdx.x) * tl;
  const int stride = tl + 8;
  const int ksteps = kcols / 32;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  int* s_d = reinterpret_cast<int*>(planes + (kcols / 4) * stride) +
             (tid >> 5) * NPLANES * D_STRIDE;

  for (int w = tid; w < (kcols / 4) * stride; w += THREADS) planes[w] = 0u;
  __syncthreads();
  // digits of the block's rows: item = (row bl, operand kk)
  unsigned char* pbytes = smem;
  const size_t Bk = static_cast<size_t>(B) * k;
  for (int idx = tid; idx < tl * k; idx += THREADS) {
    const int bl = idx / k;
    const int kk = idx - bl * k;
    if (b0 + bl >= B) continue;
    uint32_t l[L];
#pragma unroll
    for (int j = 0; j < L; ++j)
      l[j] = a[j * Bk + static_cast<size_t>(b0) * k + idx];
#pragma unroll
    for (int d = 0; d < NPLANES; ++d) {
      const int j = (7 * d) >> 4, r = (7 * d) & 15;
      uint32_t v = l[j] >> r;
      if (r > 9 && j + 1 < L) v |= l[j + 1] << (16 - r);
      const int q = kk * NPLANES + d;
      pbytes[((q >> 2) * stride + bl) * 4 + (q & 3)] =
          static_cast<unsigned char>(v & 0x7Fu);
    }
  }
  __syncthreads();                       // planes are ready

  const int g = laneid >> 2, tg = laneid & 3;
  const int lane0 = lane - laneid;
  const long long b = b0 + lane;
  const size_t Bn = static_cast<size_t>(B) * n;
  // no block barrier below: each warp walks its slot's columns on its own
  for (int col = slot; col < n; col += nslots) {
    int acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;
    const int4* ap = band + static_cast<size_t>(col) * ksteps * MT * 32 +
                     laneid;
    int4 af[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) af[mt] = __ldg(ap + mt * 32);
    for (int ks = 0; ks < ksteps; ++ks) {
      int4 nf[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)   // next k-step's fragments, in flight
        nf[mt] = (ks + 1 < ksteps) ? __ldg(ap + ((ks + 1) * MT + mt) * 32)
                                   : af[mt];
      const uint32_t* p0 = planes + (ks * 8 + tg) * stride + lane0 + g;
      const uint32_t* p1 = p0 + 4 * stride;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int b0w = static_cast<int>(p0[nt * 8]);
        const int b1w = static_cast<int>(p1[nt * 8]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], af[mt], b0w, b1w);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) af[mt] = nf[mt];
    }
    // transpose: thread laneid takes the 37 diagonals of lane lane0+laneid
    __syncwarp();                        // the previous column's reads are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + h * 8;
          if (r < NPLANES)
            *reinterpret_cast<int2*>(s_d + r * D_STRIDE + nt * 8 + 2 * tg) =
                make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
    __syncwarp();
    int32_t ds[NPLANES];
#pragma unroll
    for (int r = 0; r < NPLANES; ++r) ds[r] = s_d[r * D_STRIDE + laneid];
    uint32_t limbs[L];
    fold_reduce7<ROUNDS>(ds, limbs);
    if (b < B) {
#pragma unroll
      for (int j = 0; j < L; ++j)
        out[j * Bn + static_cast<size_t>(b) * n + col] = limbs[j];
    }
  }
}

}  // namespace hbmxu2

extern "C" int hb_mxu_fused2(const void* a, const void* band, void* out,
                             long long B, int k, int n, int rounds, int tl,
                             int kcols, void* stream) {
  using namespace hbmxu2;
  const size_t smem = static_cast<size_t>(kcols / 4) * (tl + 8) * 4 +
                      static_cast<size_t>(THREADS / 32) * NPLANES *
                          D_STRIDE * 4;
  auto kern = rounds == 1 ? mxu_fused2_kernel<1> : mxu_fused2_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((B + tl - 1) / tl);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const int4*>(band),
      static_cast<uint32_t*>(out), B, k, n, tl, kcols);
  return static_cast<int>(cudaGetLastError());
}
