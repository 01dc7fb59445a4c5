// mxu_core.cuh: the shared epilogues of the GF(p) matmuls through unsigned
// 7-bit digit planes (csrc/mxu_fused2.cu, csrc/mxu_fused.cu,
// csrc/mxu_redc.cu).
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
// The int8 dots that produce the diagonals run elsewhere: rows 13 and 14
// (mxu_fused2.cu, mxu_fused.cu) on band_gemm.cuh's wgmma core, which hands
// each (lane, column)'s diagonals to Fold37 or Redc73 below; row 15
// (mxu_redc.cu) after the library's int8 matmul.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace hbmxu {

constexpr int L = 16;
constexpr int NPLANES = 37;
constexpr uint32_t MASK = 0xFFFFu;
constexpr uint32_t N0 = 0xFFFFu;

static __device__ __constant__ uint32_t kP[L] = {
    0x0001u, 0x0000u, 0xFFFFu, 0xFFFFu, 0x5BFEu, 0xFFFEu, 0xA402u, 0x53BDu,
    0xD805u, 0x09A1u, 0xD808u, 0x3339u, 0x7D48u, 0x299Du, 0xA753u, 0x73EDu};

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

}  // namespace hbmxu
