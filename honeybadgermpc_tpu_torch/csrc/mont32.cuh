// 32-bit-word Montgomery arithmetic for the port's elementwise and CIOS
// matmul kernels (csrc/mont_mul.cu, csrc/fp_matmul_cios.cu,
// csrc/packed_arith.cu).
//
// An element is 8 little-endian words of 32 bits (two 16-bit limbs of the
// reference's layout per word). The multiplier is CIOS over 32-bit words
// with 64-bit products: 8 outer steps, each adding a_i * b and m * p and
// dropping one word, so it divides by 2^256 = R exactly as the reference's
// 16 steps over 16-bit limbs do. Both return the canonical residue
// a*b*R^-1 mod p (< p), hence the same words: any correct Montgomery
// product with the same R has one canonical result.
//
// Bounds: inputs < p < 2^255. After each outer step t < 2p (the CIOS
// invariant for p < R/4), so one conditional subtract at the end
// canonicalizes and the ninth accumulator word is 0 then.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hb32 {

constexpr int NW = 8;                     // 32-bit words per element
constexpr uint32_t N0W = 0xFFFFFFFFu;     // -p^-1 mod 2^32 (p = 1 mod 2^32)

static __device__ __constant__ uint32_t kPW[NW] = {
    0x00000001u, 0xFFFFFFFFu, 0xFFFE5BFEu, 0x53BDA402u,
    0x09A1D805u, 0x3339D808u, 0x299D7D48u, 0x73EDA753u};

// 16 limbs (< 2^16 each, int32 planes) -> 8 words.
__device__ __forceinline__ void words_of_limbs(const uint32_t (&l)[2 * NW],
                                               uint32_t (&w)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = l[2 * i] | (l[2 * i + 1] << 16);
}

__device__ __forceinline__ void limbs_of_words(const uint32_t (&w)[NW],
                                               uint32_t (&l)[2 * NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    l[2 * i] = w[i] & 0xFFFFu;
    l[2 * i + 1] = w[i] >> 16;
  }
}

// x (< 2p, with a ninth word `hi`) -> x mod p.
__device__ __forceinline__ void cond_sub_p(uint32_t (&x)[NW], uint32_t hi) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(x[i]) - kPW[i] - borrow;
    d[i] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
  const bool take = (hi != 0u) | (borrow == 0u);
#pragma unroll
  for (int i = 0; i < NW; ++i) x[i] = take ? d[i] : x[i];
}

// out = a*b*2^-256 mod p, canonical. a, b canonical.
__device__ __forceinline__ void mont_mul_w(const uint32_t (&a)[NW],
                                           const uint32_t (&b)[NW],
                                           uint32_t (&out)[NW]) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {              // t += a_i * b
      const uint64_t s = static_cast<uint64_t>(a[i]) * b[j] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[NW]) + c;
    t[NW] = static_cast<uint32_t>(s);
    t[NW + 1] = static_cast<uint32_t>(s >> 32);
    const uint32_t m = t[0] * N0W;              // t + m*p = 0 mod 2^32
    c = (static_cast<uint64_t>(m) * kPW[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {              // (t + m*p) / 2^32
      s = static_cast<uint64_t>(m) * kPW[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[NW]) + c;
    t[NW - 1] = static_cast<uint32_t>(s);
    t[NW] = t[NW + 1] + static_cast<uint32_t>(s >> 32);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) out[j] = t[j];
  cond_sub_p(out, t[NW]);
}

// out = (a + b) mod p, a, b canonical.
__device__ __forceinline__ void add_mod_w(const uint32_t (&a)[NW],
                                          const uint32_t (&b)[NW],
                                          uint32_t (&out)[NW]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = static_cast<uint64_t>(a[i]) + b[i] + c;
    out[i] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  cond_sub_p(out, static_cast<uint32_t>(c));
}

// out = (a - b) mod p: the borrow chain on the 8 words, then p added back
// (carry dropped) when a < b. For any inputs it gives the words of the
// reference's chains on 16-bit limbs (ops/pallas_field.py::_sub_mod_reg):
// both compute a - b + [a < b] * p mod 2^256.
__device__ __forceinline__ void sub_mod_w(const uint32_t (&a)[NW],
                                          const uint32_t (&b)[NW],
                                          uint32_t (&out)[NW]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(a[i]) - b[i] - borrow;
    out[i] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = static_cast<uint64_t>(out[i]) + (kPW[i] & mask) + c;
    out[i] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
}

}  // namespace hb32
