// fp_matmul_cios: GF(p) matrix product a[L, B, k] @ v[L, k, n] -> [L, B, n]
// on Montgomery limb tensors (int32, 16-bit limbs, limb-major planes).
//
// Replaces the TPU kernel honeybadgermpc_tpu/ops/pallas_field.py::
// _matmul_kernel (called through fp_matmul_pallas), which serves
// fpmatmul.fp_matmul for shapes whose batch is below 1024 elements (the
// MXU kernels take the rest): robust_open_single's decode, small Gao
// segments' interpolation, the NTL API's small interpolations.
//
// What bounds it on an H100: at the shapes it serves, neither bytes nor
// operations but latency. B*n outputs of k terms each are few (2,752 x 22
// at robust_open_single's B=64, k=22, n=43), so one thread per output, each
// running its k terms as one chain of dependent instructions, leaves the
// card nearly idle.
//
// Design: S lanes of a warp per output (the split, S = 1, 2, ..., 32,
// chosen by field_kernels._cios_plan from (B, k, n) so that the grid puts
// several warps on every SM). Lane s of a group takes the terms s, s + S,
// s + 2S, ... of its output, reads each term's operands straight from the
// limb planes (a's 16 limbs as they are, v's joined into 8 words; at the
// shapes this kernel serves they sit in L1 and L2) and sums the terms'
// full products UNREDUCED:
//
//   * mac_cols adds the 16 x 8 partial products a_i * v_j (16 by 32 bits,
//     below 2^48) of a term into 30 independent 64-bit column sums, column
//     i + 2j at bit 16(i + 2j): 128 multiply-adds (IMAD.WIDE) with no carry
//     between columns, so a lane has 30 chains in flight instead of one.
//     A column takes at most 8 products per term, so 64 terms keep it
//     below 2^57.
//   * After every run of CIOS_CHUNK = 64 of a lane's terms and after its
//     last, redc_cols folds the columns into 17 words (one carry pass) and
//     redc_wide runs one Montgomery reduction of that wide sum T: per word
//     i, m = -T_i and two carry chains (mad.lo / madc.lo, then mad.hi /
//     madc.hi) add m*p at word i, leaving words 0-7 zero; the chains' carry
//     outs go to carry words (cc[c - 8] for word c = 8..16) instead of
//     rippling up. Then V = (T + M*p) / 2^256 < T / 2^256 + p. With at most
//     64 terms of canonical operands, T <= 64 (p-1)^2 < 2^516 and
//     V < 29.99 p, so the conditional subtracts of 16p, 8p, 4p, 2p and p
//     leave V mod p. V is congruent to T * 2^-256, the sum of the terms'
//     Montgomery products.
//   * The lane adds its runs' canonical sums mod p (add_mod_w), then the
//     S lanes of the group combine theirs in an xor butterfly of shuffles
//     and modular adds, so every lane ends with the output's canonical
//     value, and lane s stores the limbs s, s + S, ... of it.
//
// Any order of canonical modular additions gives the same canonical sum,
// so the words equal the reference's scan of mont_mul and add_mod.
#include "mont32.cuh"

namespace hb32 {

constexpr int CIOS_THREADS = 128;   // threads per block
constexpr int CIOS_CHUNK = 64;      // terms a lane sums per reduction
constexpr int NCOL = 4 * NW;       // 30 columns of 16 bits, and 2 zeros

// 2^s * p, s = 0..4, as 9 little-endian words: the conditional subtracts
// that canonicalize a reduced sum below 32p.
static __device__ __constant__ uint32_t kPS[5][NW + 1] = {
    {0x00000001u, 0xFFFFFFFFu, 0xFFFE5BFEu, 0x53BDA402u, 0x09A1D805u,
     0x3339D808u, 0x299D7D48u, 0x73EDA753u, 0x00000000u},
    {0x00000002u, 0xFFFFFFFEu, 0xFFFCB7FDu, 0xA77B4805u, 0x1343B00Au,
     0x6673B010u, 0x533AFA90u, 0xE7DB4EA6u, 0x00000000u},
    {0x00000004u, 0xFFFFFFFCu, 0xFFF96FFBu, 0x4EF6900Bu, 0x26876015u,
     0xCCE76020u, 0xA675F520u, 0xCFB69D4Cu, 0x00000001u},
    {0x00000008u, 0xFFFFFFF8u, 0xFFF2DFF7u, 0x9DED2017u, 0x4D0EC02Au,
     0x99CEC040u, 0x4CEBEA41u, 0x9F6D3A99u, 0x00000003u},
    {0x00000010u, 0xFFFFFFF0u, 0xFFE5BFEFu, 0x3BDA402Fu, 0x9A1D8055u,
     0x339D8080u, 0x99D7D483u, 0x3EDA7532u, 0x00000007u}};

// t[0..7] += lo(x * y[0..7]) as one carry chain; its carry out into c.
__device__ __forceinline__ void chain_lo(uint32_t* t, uint32_t& c, uint32_t x,
                                         const uint32_t (&y)[NW]) {
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(c)
      : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]),
        "r"(y[5]), "r"(y[6]), "r"(y[7]));
}

// t[0..7] += hi(x * y[0..7]) as one carry chain; its carry out into c.
__device__ __forceinline__ void chain_hi(uint32_t* t, uint32_t& c, uint32_t x,
                                         const uint32_t (&y)[NW]) {
  asm("mad.hi.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(c)
      : "r"(x), "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]),
        "r"(y[5]), "r"(y[6]), "r"(y[7]));
}

// u[i + 2j] += x_i * y_j: a term's 16 x 8 partial products in columns
// 0..29 (30 and 31 stay 0).
__device__ __forceinline__ void mac_cols(uint64_t (&u)[NCOL],
                                         const uint32_t (&x)[2 * NW],
                                         const uint32_t (&y)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int i = 0; i < 2 * NW; ++i)
      u[i + 2 * j] += static_cast<uint64_t>(x[i]) * y[j];
}

// x (9 words) -= d when x >= d.
__device__ __forceinline__ void cond_sub9(uint32_t (&x)[NW + 1],
                                          const uint32_t (&d)[NW + 1]) {
  uint32_t r[NW + 1];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i <= NW; ++i) {
    const uint64_t v = static_cast<uint64_t>(x[i]) - d[i] - borrow;
    r[i] = static_cast<uint32_t>(v);
    borrow = static_cast<uint32_t>(v >> 63);
  }
#pragma unroll
  for (int i = 0; i <= NW; ++i) x[i] = borrow ? x[i] : r[i];
}

// The wide sum T = (acc, cc) of at most CIOS_CHUNK terms -> T * 2^-256
// mod p, canonical; acc and cc are spent.
__device__ __forceinline__ void redc_wide(uint32_t (&acc)[2 * NW],
                                          uint32_t (&cc)[NW + 1],
                                          uint32_t (&out)[NW]) {
  uint32_t p[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) p[j] = kPW[j];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = acc[i] * N0W;        // word i of T + m*p*2^(32i) is 0
    chain_lo(acc + i, cc[i], m, p);
    chain_hi(acc + i + 1, cc[i + 1], m, p);
  }
  uint32_t v[NW + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s = static_cast<uint64_t>(acc[NW + j]) + cc[j] + c;
    v[j] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  v[NW] = cc[NW] + static_cast<uint32_t>(c);
#pragma unroll
  for (int s = 4; s >= 0; --s) {            // V < 32p -> V mod p
    uint32_t d[NW + 1];
#pragma unroll
    for (int j = 0; j <= NW; ++j) d[j] = kPS[s][j];
    cond_sub9(v, d);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) out[j] = v[j];
}

// The column sums of at most CIOS_CHUNK terms -> (the sum) * 2^-256 mod p,
// canonical: word w of T takes column 2w and the low half of column 2w+1,
// the carry the rest.
__device__ __forceinline__ void redc_cols(const uint64_t (&u)[NCOL],
                                          uint32_t (&out)[NW]) {
  uint32_t acc[2 * NW], cc[NW + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int w = 0; w < 2 * NW; ++w) {
    const uint64_t hi = u[2 * w + 1];
    const uint64_t s = u[2 * w] + ((hi & 0xFFFFu) << 16) + carry;
    acc[w] = static_cast<uint32_t>(s);
    carry = (s >> 32) + (hi >> 16);
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) cc[w] = 0u;
  cc[NW] = static_cast<uint32_t>(carry);     // word 16: T < 2^516
  redc_wide(acc, cc, out);
}

// Term kk of an output: a's 16 limbs at ap + kk (planes Bk apart) and v's
// 8 words at vp + kk*n (limb planes kn apart).
__device__ __forceinline__ void load_term(const uint32_t* __restrict__ ap,
                                          const uint32_t* __restrict__ vp,
                                          size_t Bk, size_t kn, int n, int kk,
                                          uint32_t (&x)[2 * NW],
                                          uint32_t (&y)[NW]) {
  const size_t at = static_cast<size_t>(kk) * n;
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) x[i] = __ldg(ap + i * Bk + kk);
#pragma unroll
  for (int j = 0; j < NW; ++j)
    y[j] = __ldg(vp + 2 * j * kn + at) |
           (__ldg(vp + (2 * j + 1) * kn + at) << 16);
}

// x[i] for a lane-dependent i, without indexing a register array.
__device__ __forceinline__ uint32_t word_at(const uint32_t (&x)[NW], int i) {
  uint32_t r = x[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = (i == w) ? x[w] : r;
  return r;
}

template <int S>
__global__ void __launch_bounds__(CIOS_THREADS)
fp_matmul_cios_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ v,
                      uint32_t* __restrict__ out, int B, int k, int n) {
  const int s = threadIdx.x % S;
  const long long outputs = static_cast<long long>(B) * n;
  const long long o0 =
      static_cast<long long>(blockIdx.x) * (CIOS_THREADS / S) +
      threadIdx.x / S;
  // a group past the end recomputes the last output (its lanes take part
  // in the shuffles) and stores nothing
  const int o = static_cast<int>(o0 < outputs ? o0 : outputs - 1);
  const int b = o / n, col = o - b * n;
  const size_t Bk = static_cast<size_t>(B) * k;
  const size_t kn = static_cast<size_t>(k) * n;
  const uint32_t* ap = a + static_cast<size_t>(b) * k;
  const uint32_t* vp = v + col;

  uint32_t sum[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) sum[w] = 0u;
  for (int k0 = s; k0 < k; k0 += S * CIOS_CHUNK) {
    uint64_t cols[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) cols[c] = 0u;
    const int k1 = min(k, k0 + S * CIOS_CHUNK);
    uint32_t x[2 * NW], y[NW];
    load_term(ap, vp, Bk, kn, n, k0, x, y);
#pragma unroll 1
    for (int kk = k0; kk < k1; kk += S) {     // the next term's loads fly
      uint32_t xn[2 * NW], yn[NW];            // during this term's products
      if (kk + S < k1) load_term(ap, vp, Bk, kn, n, kk + S, xn, yn);
      mac_cols(cols, x, y);
#pragma unroll
      for (int i = 0; i < 2 * NW; ++i) x[i] = xn[i];
#pragma unroll
      for (int j = 0; j < NW; ++j) y[j] = yn[j];
    }
    uint32_t part[NW];
    redc_cols(cols, part);
    if (k0 == s) {                            // the lane's first run
#pragma unroll
      for (int w = 0; w < NW; ++w) sum[w] = part[w];
    } else {
      add_mod_w(sum, part, sum);
    }
  }
#pragma unroll
  for (int off = S / 2; off > 0; off /= 2) {  // the group's butterfly
    uint32_t other[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w)
      other[w] = __shfl_xor_sync(0xFFFFFFFFu, sum[w], off);
    add_mod_w(sum, other, sum);
  }
  if (o0 >= outputs) return;
  const size_t Bn = static_cast<size_t>(outputs);
#pragma unroll
  for (int j0 = 0; j0 < 2 * NW; j0 += S) {    // lane s: limbs s, s + S, ...
    const int j = j0 + s;
    if (j < 2 * NW) {
      const uint32_t w = word_at(sum, j >> 1);
      out[static_cast<size_t>(j) * Bn + o] = (j & 1) ? w >> 16 : w & 0xFFFFu;
    }
  }
}

template <int S>
int launch(const void* a, const void* v, void* out, int B, int k, int n,
           cudaStream_t stream) {
  const long long threads = static_cast<long long>(B) * n * S;
  const unsigned grid =
      static_cast<unsigned>((threads + CIOS_THREADS - 1) / CIOS_THREADS);
  fp_matmul_cios_kernel<S><<<grid, CIOS_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(v),
      static_cast<uint32_t*>(out), B, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hb32

// split: lanes per output, a power of two up to 32 (field_kernels.
// _cios_plan); B*n < 2^31 - 128 (the wrapper checks).
extern "C" int hb_fp_matmul_cios(const void* a, const void* v, void* out,
                                 int B, int k, int n, int split,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (split) {
    case 1: return hb32::launch<1>(a, v, out, B, k, n, st);
    case 2: return hb32::launch<2>(a, v, out, B, k, n, st);
    case 4: return hb32::launch<4>(a, v, out, B, k, n, st);
    case 8: return hb32::launch<8>(a, v, out, B, k, n, st);
    case 16: return hb32::launch<16>(a, v, out, B, k, n, st);
    case 32: return hb32::launch<32>(a, v, out, B, k, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
