// Shared GF(p) device core of the port's CUDA kernels (BLS12-381 scalar
// field, 16 x 16-bit limbs, Montgomery R = 2^256, packed at-rest format of
// two limbs per 32-bit word).
//
// CUDA twin of the plain-tensor core in ops/fused_open.py and
// ops/montgomery.py, which in turn mirror the reference's device helpers
// (honeybadgermpc_tpu/ops/fused_open.py: _planes_of_packed/_balance_bytes,
// _band_dot_fold, _fold_reduce_bal, _pack16, _mismatch; ops/mxu_matmul.py:
// _redc_step; ops/pallas_field.py: _threefry2x32, _redc384_reg). Every
// function here gives that arithmetic's words bit for bit in uint32
// registers (redc384_words by the same quotient on 32-bit words):
//
//   balance_word     4 bytes of a packed word -> 4 balanced int8 digits,
//                    threading the carry of the base-256 balancing chain
//   band_mma_*       int8 x int8 -> int32 dot of 32 lanes' digit planes with
//                    one output column's band: 32 diagonals per lane via
//                    mma.sync.m16n8k32 on the tensor cores
//   fold_reduce_bal  32 biased diagonals -> 19 carry-save limbs -> two
//                    16-bit REDC rounds -> conditional subtract -> 16 limbs
//   pack16           16 limbs -> 8 packed words
//   mismatch         predicted vs received share, any word differs
//   threefry2x32     Threefry-2x32, 20 rounds
//   redc384_words    12 words (384 bits) -> four 32-bit REDC rounds and one
//                    16-bit round -> 8 packed words (the sampler and the
//                    deal's draw, band_gemm.cuh's DrawSrc)
//
// All loops over limbs are fully unrolled so the limb arrays live in
// registers.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hb {

constexpr int L = 16;        // limbs per element
constexpr int PL = 8;        // packed words per element
constexpr int NBAL = 32;     // balanced base-256 digits per element
constexpr int NL = 19;       // carry-save limbs of the fold accumulator
constexpr int BAL_ROUNDS = 2;
constexpr uint32_t MASK = 0xFFFFu;
constexpr uint32_t N0 = 0xFFFFu;   // -p^{-1} mod 2^16

// 16-bit limbs of p, little-endian.
static __device__ __constant__ uint32_t kP[L] = {
    0x0001u, 0x0000u, 0xFFFFu, 0xFFFFu, 0x5BFEu, 0xFFFEu, 0xA402u, 0x53BDu,
    0xD805u, 0x09A1u, 0xD808u, 0x3339u, 0x7D48u, 0x299Du, 0xA753u, 0x73EDu};

constexpr uint32_t PINV = 0xFFFFFFFFu;      // -p^-1 mod 2^32 (p = 1 mod 2^32)

// p in 32-bit words, little-endian: the packed form of kP.
static __device__ __constant__ uint32_t kP32[PL] = {
    0x00000001u, 0xFFFFFFFFu, 0xFFFE5BFEu, 0x53BDA402u,
    0x09A1D805u, 0x3339D808u, 0x299D7D48u, 0x73EDA753u};

// Per-contraction-length constants of the balanced scheme, built on the host
// (ops/fused_open.py::_bal_fold_init, _bal_bias) and passed by value.
struct FoldConst {
  uint32_t init[NL];
  int32_t bias;
};

// ---------------------------------------------------------------------------
// Balanced digits
// ---------------------------------------------------------------------------

// d_s = byte_s + carry, minus 256 when >= 128; the low byte of d_s equals
// (byte_s + carry) & 0xFF in two's complement, so the four digits pack back
// into one word: four consecutive int8 of a B fragment. `carry` runs on into
// the next word.
__device__ __forceinline__ uint32_t balance_word(uint32_t word,
                                                 uint32_t& carry) {
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t u = ((word >> (8 * e)) & 0xFFu) + carry;
    carry = (u >= 128u) ? 1u : 0u;
    out |= (u & 0xFFu) << (8 * e);
  }
  return out;
}

// ---------------------------------------------------------------------------
// Band dot on the tensor cores.
//
// For one output column the dot is D[32 diagonals, lanes] =
// A[32, 32k] x B[32k, lanes]: A is the column's band, B the lanes' digit
// planes, contracted one operand (32 int8 digits, one "k-step") per
// mma.sync.m16n8k32. A warp owns 32 lanes (four n-tiles of 8) and one
// column (two m-tiles of 16 diagonals): eight accumulator tiles.
//
//   band_col  one column's band in FRAGMENT ORDER [k-step][m-tile][32]
//             int4 in device memory: thread `laneid` loads its four A
//             registers with one 16-byte read-only load, one k-step ahead
//             of the mma that uses them. The whole band is about 1 MB and
//             every block walks it in the same order, so these loads hit
//             L1/L2; no block barrier is needed in the column loop.
//             (ops/fused_open.py::_kernel_band builds the layout.)
//   s_planes  digit words [q][stride], q = 8*operand + word, this block's
//             lane l at q*stride + l; stride = lanes + 8 keeps the
//             B-fragment loads (4 words x 8 lanes per warp) conflict-free
// ---------------------------------------------------------------------------
constexpr int D_STRIDE = 40;   // staging row stride (words) of one warp

// Shared-memory layout of a band kernel's block: `tl` lanes x `wg` column
// slots (tl*wg threads).
struct BandSmem {
  uint32_t* planes;   // [8k][tl + 8] words
  int* stage;         // [warps][32*D_STRIDE] ints
  int* tail;          // whatever the kernel appends (error counters)
};

__host__ __device__ inline size_t band_smem_bytes(int k, int tl, int wg,
                                                  int tail_ints) {
  return static_cast<size_t>(PL) * k * (tl + 8) * 4 +
         static_cast<size_t>(tl * wg / 32) * 32 * D_STRIDE * 4 +
         static_cast<size_t>(tail_ints) * 4;
}

__device__ __forceinline__ BandSmem band_smem_carve(unsigned char* smem, int k,
                                                    int tl, int wg) {
  BandSmem s;
  s.planes = reinterpret_cast<uint32_t*>(smem);
  s.stage = reinterpret_cast<int*>(s.planes + PL * k * (tl + 8));
  s.tail = s.stage + (tl * wg / 32) * 32 * D_STRIDE;
  return s;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int4& a, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// acc[m-tile][n-tile][4] = band column x planes over all k k-steps; lane0 is
// the warp's first lane within the block.
__device__ __forceinline__ void band_mma_column(
    int (&acc)[2][4][4], const uint32_t* s_planes, int stride, int lane0,
    const int4* __restrict__ band_col, int k, int laneid) {
  const int g = laneid >> 2, tg = laneid & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;
  const int4* a = band_col + laneid;
  int4 a_lo = __ldg(a), a_hi = __ldg(a + 32);
  for (int ks = 0; ks < k; ++ks) {
    int4 n_lo = a_lo, n_hi = a_hi;
    if (ks + 1 < k) {                  // next k-step's fragments, in flight
      n_lo = __ldg(a + (ks + 1) * 64);
      n_hi = __ldg(a + (ks + 1) * 64 + 32);
    }
    const uint32_t* p0 = s_planes + (ks * PL + tg) * stride + lane0 + g;
    const uint32_t* p1 = p0 + 4 * stride;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int b0 = static_cast<int>(p0[nt * 8]);
      const int b1 = static_cast<int>(p1[nt * 8]);
      mma_s8(acc[0][nt], a_lo, b0, b1);
      mma_s8(acc[1][nt], a_hi, b0, b1);
    }
    a_lo = n_lo;
    a_hi = n_hi;
  }
}

// The accumulator tiles spread a lane's 32 diagonals over eight threads;
// the fold needs them in one. Each warp transposes through its own staging
// area s_d [32][D_STRIDE]: thread `laneid` ends with the 32 diagonals of
// the warp's lane `laneid`. Accumulator pairs go out as 8-byte stores; with
// a row stride of 40 words both the stores and the reads are conflict-free.
__device__ __forceinline__ void band_mma_diagonals(const int (&acc)[2][4][4],
                                                   int* s_d, int laneid,
                                                   int32_t (&ds)[NBAL]) {
  const int g = laneid >> 2, tg = laneid & 3;
  __syncwarp();                       // the previous column's reads are done
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + h * 8;
        const int n = nt * 8 + 2 * tg;
        *reinterpret_cast<int2*>(s_d + r * D_STRIDE + n) =
            make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < NBAL; ++r) ds[r] = s_d[r * D_STRIDE + laneid];
}

// ---------------------------------------------------------------------------
// REDC, fold, pack
// ---------------------------------------------------------------------------

// Carry-normalize 16 redundant limbs (value hi*2^256 + limbs < 2p) and
// subtract p at most once.
__device__ __forceinline__ void normalize_cond_sub(const uint32_t* t,
                                                   uint32_t t_hi,
                                                   uint32_t (&out)[L]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = t[j] + c;
    out[j] = v & MASK;
    c = v >> 16;
  }
  const uint32_t hi = c + t_hi;
  uint32_t borrow = 0;
  uint32_t d2[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = out[j] - kP[j] - borrow;
    d2[j] = v & MASK;
    borrow = (v >> 16) & 1u;
  }
  const bool take = (hi != 0u) | (borrow == 0u);
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = take ? d2[j] : out[j];
}

// NBAL signed diagonals (8-bit spacing, |d| <= bias) -> L canonical limbs.
// (d + bias) is formed in int32 and then reinterpreted unsigned; the odd
// diagonals split into three 16-bit chunks.
__device__ __forceinline__ void fold_reduce_bal(const int32_t (&ds)[NBAL],
                                                const FoldConst& fc,
                                                uint32_t (&out)[L]) {
  uint32_t t[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) t[j] = fc.init[j];
#pragma unroll
  for (int r = 0; r < NBAL; ++r) {
    const uint32_t d = static_cast<uint32_t>(ds[r] + fc.bias);
    const int j = r >> 1;
    if ((r & 1) == 0) {
      t[j] += d & MASK;
      t[j + 1] += d >> 16;
    } else {
      t[j] += (d << 8) & MASK;
      t[j + 1] += (d >> 8) & MASK;
      if (j + 2 < NL) t[j + 2] += d >> 24;
    }
  }
#pragma unroll
  for (int round = 0; round < BAL_ROUNDS; ++round) {
    // one 16-bit Montgomery REDC round: t <- (t + m*p) >> 16
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
    t[NL - 1] = 0;
    t[0] += carry0;
  }
  normalize_cond_sub(t, t[L], out);
}

__device__ __forceinline__ void pack16(const uint32_t (&limbs)[L],
                                       uint32_t (&words)[PL]) {
#pragma unroll
  for (int j = 0; j < PL; ++j)
    words[j] = limbs[2 * j] | (limbs[2 * j + 1] << 16);
}

// One validation point of the reference's _mismatch: does the predicted
// share differ from the received one in any packed word?
__device__ __forceinline__ bool mismatch(const uint32_t (&pred)[PL],
                                         const uint32_t (&recv)[PL]) {
  uint32_t diff = 0;
#pragma unroll
  for (int w = 0; w < PL; ++w) diff |= pred[w] ^ recv[w];
  return diff != 0u;
}

// ---------------------------------------------------------------------------
// Sampler core
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: key (k0, k1), counter (c0, c1) -> (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot_a[4] = {13, 15, 26, 6};
  constexpr int rot_b[4] = {17, 29, 16, 24};
  x0 = c0 + ks[0];
  x1 = c1 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (g % 2 == 0) ? rot_a[i] : rot_b[i];
      x0 += x1;
      x1 = rotl32(x1, r) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

// 12 Threefry words (little-endian, 384 bits T) -> T * 2^-144 mod p as 8
// packed words: four 32-bit Montgomery rounds and one 16-bit round (the
// quotient of nine 16-bit rounds, ops/montgomery.py::_redc384_rows, so the
// same value < 2p and, after one conditional subtract, the same words;
// plain twin ops/band_gemm.py::_redc384_words).
__device__ __forceinline__ void redc384_words(const uint32_t (&x)[12],
                                              uint32_t (&out)[PL]) {
  uint32_t t[13];
#pragma unroll
  for (int j = 0; j < 12; ++j) t[j] = x[j];
  t[12] = 0u;
#pragma unroll
  for (int r = 0; r < 4; ++r) {            // t <- t + m p, m p = -t_r
    const uint32_t m = t[r] * PINV;        // mod 2^32
    unsigned long long c = 0;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const unsigned long long s =
          static_cast<unsigned long long>(m) * kP32[j] + t[r + j] + c;
      t[r + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
#pragma unroll
    for (int j = r + PL; j < 13; ++j) {
      const unsigned long long s = static_cast<unsigned long long>(t[j]) + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
  }
  // V = t[4..12] < 2^256 + p; one 16-bit round: V + m16 p = 0 mod 2^16
  const uint32_t m16 = (0u - t[4]) & 0xFFFFu;
  unsigned long long c = 0;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const unsigned long long s =
        static_cast<unsigned long long>(m16) * kP32[j] + t[4 + j] + c;
    t[4 + j] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  t[12] += static_cast<uint32_t>(c);
  uint32_t v[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) v[j] = (t[4 + j] >> 16) | (t[5 + j] << 16);
  const uint32_t hi = t[12] >> 16;         // V / 2^16 < 2p
  uint32_t dif[PL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const unsigned long long s = static_cast<unsigned long long>(v[j]) -
                                 kP32[j] - borrow;
    dif[j] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  const bool take = (hi != 0u) | (borrow == 0u);
#pragma unroll
  for (int j = 0; j < PL; ++j) out[j] = take ? dif[j] : v[j];
}

}  // namespace hb
