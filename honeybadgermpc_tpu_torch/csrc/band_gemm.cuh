// band_gemm: the Vandermonde band encode as one int8 GEMM per block, on
// Hopper's wgmma and bulk async copies. Runs band_matmul_kernel
// (band_matmul.cu), the direct open (open_direct.cu), K1 and K2 of the
// three-kernel open and the per-column check (open_fused.cu), the deal
// (randousha_deal.cu) and both extractions (randousha_extract.cu); each
// brings its own operand source and epilogue policy (below). The other
// band kernels (K3, and the direct open above k = 81, where the planes of
// a 64-lane block no longer fit shared memory) keep field_core.cuh's
// mma.sync core.
//
// The function (ops/fused_open.py's plain core): for each lane, k packed
// operands -> 32 balanced int8 digits each (the planes), dotted with every
// output column's folded band into 32 int32 diagonals, folded and reduced
// to one GF(p) element per (lane, column). Written as a GEMM:
//
//   D[lanes, 32 cols] = P[lanes, 32k] . Band^T[32k, 32 cols]
//
// contracted one operand (32 digits, one "k-step") per wgmma.
//
// What bounds it on an H100: the int8 dot (2 x lanes x cols x 32 x 32k
// operations at 1,979 TOP/s), then the band's reads from L2: every block
// streams the whole band once, so a block of TM lanes needs 1/TM of a band
// byte per lane. Design:
//
//   block      consumer warpgroups (4, 3 or 2 for MB = 1, 2, 4) and one
//              producer warp each. The block owns TM = 64 MB lanes (MB = 4, 2 or 1:
//              as many as the planes of k operands leave room for, and no
//              more than fill the card); its planes stay in shared memory
//              for all its columns.
//   planes     built once per block by all threads: the operand source
//              policy gives the 8 packed words of a (lane, operand) item
//              (LoadSrc: loaded through the EncodeMap; DrawSrc: drawn in
//              registers) -> balance_word's carry chain -> 32 digit bytes,
//              stored K-major in wgmma's no-swizzle canonical
//              layout: core matrices of 8 lanes x 16 bytes, [operand][16-
//              byte half][lane octet][lane % 8][16]. A fence.proxy.async
//              makes the ordinary stores visible to wgmma.
//   band       re-laid on the host (ops/band_gemm.py::_gemm_band) into
//              2 KB tiles, one per (column pair, k-step), each the B
//              operand of one wgmma in the same canonical layout. Each
//              consumer warpgroup has its own ring of SLOTS slots of KS
//              k-steps behind mbarriers (full: the copy landed; empty: its
//              consumer is done) and its own producer warp, which streams
//              the k-steps of that warpgroup's tiles in order with
//              cp.async.bulk, KS steps per copy. One consumer per ring
//              keeps each mbarrier's phases in the order its waiter walks
//              them.
//   dot        wgmma.mma_async.m64n64k32.s32.s8.s8, A (planes) and B (band
//              tile) from shared memory, accumulators in registers: per
//              k-step MB wgmmas, one per 64-lane block, all on one tile.
//              Tiles go round the consumer warpgroups, so one's epilogue
//              runs on the CUDA cores while another's dot runs on the
//              tensor cores (ping-pong through the rings).
//   epilogue   straight from the accumulators. The band tile's 64 rows
//              are permuted so that thread tg of a quad holds 16 of the 32
//              diagonals of one column (tg >> 1) for the quad's two lanes:
//              it folds them, for both lanes, into a 5-word partial; one
//              __shfl_xor_sync swaps the partial of the lane the partner
//              owns; each thread then adds its two halves and the fold
//              constant in 32-bit words and reduces with one 32-bit
//              Montgomery step, which is the fold's two 16-bit REDC rounds
//              (fold_words below; plain twin ops/band_gemm.py::
//              _fold_reduce_words). The result words are the packed
//              words: no pack step. What a (lane, column) then does with
//              them is the kernel's epilogue policy: a store (StoreEpi),
//              a compare and count (CompareEpi: K2, the per-column check,
//              the direct open, each with its own charge), stores to two
//              outputs (the extractions).
#pragma once

#include "field_core.cuh"

namespace hb {
namespace gemm {

constexpr int NT = 2;                       // output columns per tile
constexpr int TILE_N = NBAL * NT;           // band rows per tile (wgmma N)
constexpr int STEP_BYTES = TILE_N * NBAL;   // one k-step of one tile
constexpr int KS = 4;                       // k-steps per ring slot
constexpr int SLOT_BYTES = KS * STEP_BYTES;
constexpr int SLOTS = 2;                    // slots of each consumer's ring

// Consumer warpgroups of a block of 64*MB lanes: the epilogue is
// latency-bound and wants as many warps as the accumulators' registers
// leave room for: 4 for 64 lanes, 3 for 128, 2 for 256. One producer warp
// per consumer warpgroup, after the consumers.
__host__ __device__ constexpr int consumers(int mb) {
  return mb == 1 ? 4 : (mb == 2 ? 3 : 2);
}
__host__ __device__ constexpr int threads(int mb) {
  return consumers(mb) * (128 + 32);
}
constexpr int NW = 10;                      // 32-bit words of the fold value
constexpr uint32_t PINV = 0xFFFFFFFFu;      // -p^-1 mod 2^32 (p = 1 mod 2^32)

// p in 32-bit words, little-endian: the packed form of kP.
static __device__ __constant__ uint32_t kP32[PL] = {
    0x00000001u, 0xFFFFFFFFu, 0xFFFE5BFEu, 0x53BDA402u,
    0x09A1D805u, 0x3339D808u, 0x299D7D48u, 0x73EDA753u};

// Where a lane's operands live. Lane g = grp * C + c:
//   operand i, word w   src[w*sw + grp*sp + c*sc + i*si]
// The m result columns of a lane go to the kernel's epilogue policy.
struct EncodeMap {
  long long nlanes, C;
  long long sw, sp, sc, si;
  int k, m;
};

// The fold constant I + bias * sum_r 256^r in 32-bit words
// (ops/band_gemm.py::_word_fold_consts).
struct WordFold {
  uint32_t w[NW];
};

__host__ __device__ inline size_t smem_bytes(int k, int mb) {
  return static_cast<size_t>(NBAL) * k * 64 * mb +
         static_cast<size_t>(consumers(mb)) * SLOTS * (SLOT_BYTES + 16);
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, bulk copies, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0u;
}

// Waits for the phase of `bar` with this parity to complete. A pipeline
// that never completes it is a bug: trap (a launch error) after some
// seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins == (1LL << 26)) __trap();
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two 16-byte halves of a row's 32 K bytes), stride
// byte offset (between 8-row core matrices), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
__device__ __forceinline__ void acc_fence(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 32] . B[64 x 32]^T, int8 -> int32; scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Epilogue arithmetic
// ---------------------------------------------------------------------------

// 16 signed diagonals (8-bit spacing) of one lane and column half -> their
// exact sum sum_r d_r 256^r as 4 words and a signed fifth. Accumulator
// register 4i + 2h + e holds the diagonal 2i + e of row h's half.
__device__ __forceinline__ void half_partial(const int (&d)[32], int h,
                                             uint32_t (&pw)[5]) {
  long long carry = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const long long x = carry + static_cast<long long>(d[8 * w + 2 * h]) +
                        static_cast<long long>(d[8 * w + 2 * h + 1]) * 256 +
                        static_cast<long long>(d[8 * w + 4 + 2 * h]) * 65536 +
                        static_cast<long long>(d[8 * w + 5 + 2 * h]) *
                            16777216;
    pw[w] = static_cast<uint32_t>(x);
    carry = x >> 32;
  }
  pw[4] = static_cast<uint32_t>(carry);
}

// V = fold constant + lo + hi * 2^128 (lo, hi: half partials) -> one
// Montgomery step by 2^32 (the same quotient as fold_reduce_bal's two
// 16-bit rounds, so the same value) -> subtract p once -> 8 packed words.
__device__ __forceinline__ void fold_words(const uint32_t (&lo)[5],
                                           const uint32_t (&hi)[5],
                                           const WordFold& wf,
                                           uint32_t (&out)[PL]) {
  uint32_t v[NW];
  long long c = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    long long x = c + static_cast<long long>(wf.w[w]);
    if (w < 4) x += lo[w];
    if (w == 4) x += static_cast<long long>(static_cast<int>(lo[4])) + hi[0];
    if (w >= 5 && w < 8) x += hi[w - 4];
    if (w == 8) x += static_cast<long long>(static_cast<int>(hi[4]));
    v[w] = static_cast<uint32_t>(x);
    c = x >> 32;
  }
  const uint32_t mq = v[0] * PINV;
  unsigned long long cc = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    unsigned long long x = static_cast<unsigned long long>(v[j]) + cc;
    if (j < PL) x += static_cast<unsigned long long>(mq) * kP32[j];
    v[j] = static_cast<uint32_t>(x);
    cc = x >> 32;
  }
  // R = v[1..9]: subtract p when R >= p
  uint32_t dif[PL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const unsigned long long x = static_cast<unsigned long long>(v[j + 1]) -
                                 kP32[j] - borrow;
    dif[j] = static_cast<uint32_t>(x);
    borrow = static_cast<uint32_t>(x >> 63);
  }
  const bool take = (v[NW - 1] != 0u) | (borrow == 0u);
#pragma unroll
  for (int j = 0; j < PL; ++j) out[j] = take ? dif[j] : v[j + 1];
}

// ---------------------------------------------------------------------------
// Epilogue policies: what band_gemm_body does with the result words of one
// (lane, column), the step after fold_words. A policy type has
//
//   Lane     its state of one lane, in registers: one per 64-lane block
//            a thread serves, made by lane(mp, g, valid, grp, c)
//   Fetch    what a column needs besides its result, loaded by fetch()
//            ahead of its use: the first lane's before the tile's dot,
//            each next lane's under the previous lane's fold
//   apply    the step itself: store, compare and count, or nothing
//   finish   after the thread's last tile; the thread is part `part` of
//            the `parts` threads that serve its lane (one per consumer
//            warpgroup and column of a tile)
// ---------------------------------------------------------------------------

struct NoFetch {};

// Columns lo..hi-1, word w, of lane grp * C + c go to
// out[w*ow + grp*op + c*oc + (col - lo)*ocol].
struct Store {
  uint32_t* out;
  long long ow, op, oc, ocol;
  int lo, hi;

  __device__ __forceinline__ long long base(long long grp, long long c) const {
    return grp * op + c * oc;
  }
  __device__ __forceinline__ void put(long long at, int col,
                                      const uint32_t (&words)[PL]) const {
    if (col >= lo && col < hi) {
      uint32_t* o = out + at + static_cast<long long>(col - lo) * ocol;
#pragma unroll
      for (int w = 0; w < PL; ++w) o[w * ow] = words[w];
    }
  }
};

// Every column stored (band_matmul, K1).
struct StoreEpi {
  Store st;
  struct Lane {
    long long at;
    bool valid;
  };
  using Fetch = NoFetch;

  __device__ __forceinline__ Lane lane(const EncodeMap&, long long, bool valid,
                                       long long grp, long long c) const {
    return {st.base(grp, c), valid};
  }
  __device__ __forceinline__ void fetch(const EncodeMap&, const Lane&, int,
                                        Fetch&) const {}
  __device__ __forceinline__ void apply(const EncodeMap&, Lane& ln, int col,
                                        const uint32_t (&words)[PL],
                                        const Fetch&) const {
    if (ln.valid) st.put(ln.at, col, words);
  }
  __device__ __forceinline__ void finish(const EncodeMap&, const Lane&, int,
                                         int) const {}
};

// Where CompareEpi charges the mismatches of lane g = grp * C + c at
// compare column col:
//   Group   errs[g / C]: K2's destination. A lane's count adds up in a
//           register over the thread's columns and goes out in finish(),
//           one atomicAdd per thread and lane when not 0.
//   Lane    errs[g]: the per-column check's (check column, slot); the same.
//   Source  errs[col]: the direct open's source party k + col (the caller
//           passes errs = nerr + k). The 16 threads of a warp that hold a
//           column (the quad positions tg with the same tg >> 1) reduce
//           its 16 lanes with one ballot and popc: one atomicAdd per warp,
//           column and 64-lane block, when not 0.
enum class Charge { Group, Lane, Source };

// Compare and count (K2, the per-column check, the direct open). A lane's
// first k operands decode a polynomial: column col < nv predicts operand
// k + col, which is compared with it; column nv (lam0) is the value at 0,
// stored to vals [PL, nlanes] at lane g; column nv + 1 (the empty half of
// an odd last tile) does nothing. Every caller's operand map puts lane g's
// operand i at src[w*sw + i*si + g] (grp * sp + c * sc = g), so the
// compared words are fetched ahead (band_gemm_body) from there. Honest
// shares make no atomic. The lane state is kept small: at 256 lanes a
// thread holds four.
template <Charge CH>
struct CompareEpi {
  uint32_t* vals;
  int* errs;
  const uint32_t* src;
  int nv;
  struct Lane {
    long long g;
    int bad;
    bool valid;
  };
  struct Fetch {
    uint32_t w[PL];
  };

  __device__ __forceinline__ Lane lane(const EncodeMap&, long long g,
                                       bool valid, long long,
                                       long long) const {
    return {g, 0, valid};
  }
  __device__ __forceinline__ void fetch(const EncodeMap& mp, const Lane& ln,
                                        int col, Fetch& f) const {
    const bool cmp = ln.valid && col < nv;
    const uint32_t* p =
        src + ln.g + static_cast<long long>(mp.k + col) * mp.si;
#pragma unroll
    for (int w = 0; w < PL; ++w) f.w[w] = cmp ? __ldg(p + w * mp.sw) : 0u;
  }
  __device__ __forceinline__ void apply(const EncodeMap& mp, Lane& ln,
                                        int col, const uint32_t (&words)[PL],
                                        const Fetch& f) const {
    if (CH == Charge::Source) {            // every thread of the warp
      const bool bad = ln.valid && col < nv && mismatch(words, f.w);
      const int laneid = threadIdx.x & 31;
      const uint32_t half = (laneid & 2) ? 0xCCCCCCCCu : 0x33333333u;
      const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, bad) & half);
      if (cnt != 0 && (laneid & ~2) == 0) atomicAdd(&errs[col], cnt);
      if (ln.valid && col == nv) store(mp, ln, words);
      return;
    }
    if (!ln.valid) return;
    if (col < nv) {
      ln.bad += mismatch(words, f.w) ? 1 : 0;
    } else if (col == nv) {
      store(mp, ln, words);
    }
  }
  __device__ __forceinline__ void store(const EncodeMap& mp, const Lane& ln,
                                        const uint32_t (&words)[PL]) const {
#pragma unroll
    for (int w = 0; w < PL; ++w) vals[w * mp.nlanes + ln.g] = words[w];
  }
  __device__ __forceinline__ void finish(const EncodeMap& mp, const Lane& ln,
                                         int, int) const {
    if (CH != Charge::Source && ln.bad)
      atomicAdd(&errs[CH == Charge::Group ? ln.g / mp.C : ln.g], ln.bad);
  }
};

// ---------------------------------------------------------------------------
// The block
// ---------------------------------------------------------------------------

// One (lane, operand) item of the planes: 8 packed words -> 32 digit bytes
// at their place in the K-major image.
__device__ __forceinline__ void plane_item(unsigned char* planes, int oct_n,
                                           int i, int oct, int l8,
                                           const uint32_t (&word)[PL]) {
  uint32_t dig[PL];
  uint32_t carry = 0;
#pragma unroll
  for (int w = 0; w < PL; ++w) dig[w] = balance_word(word[w], carry);
  uint4* dst = reinterpret_cast<uint4*>(
      planes + (static_cast<size_t>(2 * i) * oct_n + oct) * 128 + l8 * 16);
  dst[0] = make_uint4(dig[0], dig[1], dig[2], dig[3]);
  dst[oct_n * 8] = make_uint4(dig[4], dig[5], dig[6], dig[7]);
}

// ---------------------------------------------------------------------------
// Operand source policies: where the 8 packed words of item (lane g,
// operand i) come from. A policy type has
//
//   item     item(mp, g, i, word): the words, zero for a lane past the end
//            or an operand past k (planes of zero operands dot to nothing)
// ---------------------------------------------------------------------------

// Loaded from device memory through the EncodeMap (band_matmul, the
// direct open, K1, K2, the per-column check, the extractions).
struct LoadSrc {
  const uint32_t* src;              // read with __ldg

  __device__ __forceinline__ void item(const EncodeMap& mp, long long g, int i,
                                       uint32_t (&word)[PL]) const {
    if (g < mp.nlanes && i < mp.k) {
      const long long grp = g / mp.C;
      const long long c = g - grp * mp.C;
      const uint32_t* p =
          src + grp * mp.sp + c * mp.sc + static_cast<long long>(i) * mp.si;
#pragma unroll
      for (int w = 0; w < PL; ++w) word[w] = __ldg(p + w * mp.sw);
    } else {
#pragma unroll
      for (int w = 0; w < PL; ++w) word[w] = 0u;
    }
  }
};

// 12 Threefry words (little-endian, 384 bits T) -> T * 2^-144 mod p as 8
// packed words: four 32-bit Montgomery rounds and one 16-bit round. The
// same quotient as field_core.cuh's redc384 (nine 16-bit rounds), so the
// same value < 2p and, after one conditional subtract, the same words
// (plain twin ops/band_gemm.py::_redc384_words).
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

// Drawn in registers (the deal, randousha_deal.cu): item (g, i) is
// coefficient i of lane g's polynomial, the uniform draw of Threefry-2x32-20
// at counters c0 = DEAL_CTR_TAG + 8 row + s (s = 0..5), c1 = g, through
// the 384-bit REDC. Coefficient 0 is global row 0 (the secret, the same in
// both degrees), coefficient i >= 1 row row1 + i - 1. The coefficients
// never reach device memory.
constexpr uint32_t DEAL_CTR_TAG = 0x10000u;

struct DrawSrc {
  uint32_t key0, key1;
  int row1;

  __device__ __forceinline__ void item(const EncodeMap& mp, long long g, int i,
                                       uint32_t (&word)[PL]) const {
    if (g < mp.nlanes && i < mp.k) {
      const uint32_t row = i == 0 ? 0u : static_cast<uint32_t>(row1 + i - 1);
      const uint32_t c0 = DEAL_CTR_TAG + 8u * row;
      uint32_t x[12];
#pragma unroll
      for (int s = 0; s < 6; ++s)
        threefry2x32(key0, key1, c0 + static_cast<uint32_t>(s),
                     static_cast<uint32_t>(g), x[2 * s], x[2 * s + 1]);
      redc384_words(x, word);
    } else {
#pragma unroll
      for (int w = 0; w < PL; ++w) word[w] = 0u;
    }
  }
};

template <int MB, class Src>
__device__ __forceinline__ void build_planes(unsigned char* planes,
                                             const Src& src,
                                             const EncodeMap& mp,
                                             long long lane0) {
  constexpr int TM = 64 * MB;
  constexpr int OCT = TM / 8;              // lane octets
  constexpr int NWARPS = threads(MB) / 32;
  const int tid = threadIdx.x;
  const int l8 = tid & 7, q4 = (tid >> 3) & 3;
  // a warp takes 8 lanes x 4 operands: 4 stores of 8 x 16 bytes, each
  // over all 32 banks; two items per pass keep 16 loads in flight
  const int items = OCT * ((mp.k + 3) >> 2);
  for (int it = tid >> 5; it < items; it += 2 * NWARPS) {
    const int it2 = it + NWARPS;
    const int i1 = 4 * (it / OCT) + q4, o1 = it % OCT;
    const int i2 = 4 * (it2 / OCT) + q4, o2 = it2 % OCT;
    uint32_t w1[PL], w2[PL];
    src.item(mp, lane0 + 8 * o1 + l8, i1, w1);
    src.item(mp, lane0 + 8 * o2 + l8, it2 < items ? i2 : mp.k, w2);
    if (i1 < mp.k) plane_item(planes, OCT, i1, o1, l8, w1);
    if (it2 < items && i2 < mp.k) plane_item(planes, OCT, i2, o2, l8, w2);
  }
}

template <int MB, class Src, class Epi>
__device__ __forceinline__ void band_gemm_body(
    unsigned char* smem, const Src& src,
    const unsigned char* __restrict__ band, const EncodeMap& mp,
    const WordFold& wf, const Epi& epi) {
  constexpr int TM = 64 * MB;
  constexpr int CONSUMERS = consumers(MB);
  constexpr int NSLOT = CONSUMERS * SLOTS;
  const int k = mp.k;
  const int ntiles = (mp.m + NT - 1) / NT;
  const int nst = (k + KS - 1) / KS;       // ring slots per tile
  unsigned char* planes = smem;
  const uint32_t ring_s = smem_u32(smem + static_cast<size_t>(NBAL) * k * TM);
  const uint32_t full_s = ring_s + NSLOT * SLOT_BYTES;     // mbarriers
  const uint32_t empty_s = full_s + 8 * NSLOT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, laneid = tid & 31;
  const long long lane0 = static_cast<long long>(blockIdx.x) * TM;
  const int pr = warp - CONSUMERS * 4;     // producer of ring pr, or < 0

  if (tid == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Tile ct goes to consumer warpgroup ct % CONSUMERS through that
  // warpgroup's own ring, fed by its own producer warp: KS k-steps per
  // slot, the ring's steps in order. Every slot has one consumer, which
  // waits for each of its phases in order. The first SLOTS loads of a ring
  // need no release: they fly under the plane build.
  auto issue = [&](int sr) {               // ring pr's load number sr
    const int ct = (sr / nst) * CONSUMERS + pr;
    const int kk0 = (sr % nst) * KS;
    const int steps = k - kk0 < KS ? k - kk0 : KS;
    const int slot = pr * SLOTS + sr % SLOTS;
    if (sr >= SLOTS)
      mbar_wait(empty_s + 8 * slot, ((sr / SLOTS) - 1) & 1);
    mbar_expect_tx(full_s + 8 * slot, steps * STEP_BYTES);
    bulk_load(ring_s + slot * SLOT_BYTES,
              band + (static_cast<size_t>(ct) * k + kk0) * STEP_BYTES,
              steps * STEP_BYTES, full_s + 8 * slot);
  };
  const int nload = pr >= 0 ? ((ntiles - pr + CONSUMERS - 1) / CONSUMERS) * nst
                            : 0;
  if (pr >= 0 && laneid == 0)
    for (int sr = 0; sr < SLOTS && sr < nload; ++sr) issue(sr);
  build_planes<MB>(planes, src, mp, lane0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();                         // planes are ready

  if (pr >= 0) {
    if (laneid == 0)
      for (int sr = SLOTS; sr < nload; ++sr) issue(sr);
    return;
  }

  const int wgi = warp >> 2;               // consumer warpgroup = its ring
  const int wl = warp & 3;                 // warp within it: rows 16wl..
  const int g = laneid >> 2, tg = laneid & 3;
  const int hf = tg & 1;                   // diagonal half; owns row g+8hf
  const int cl = tg >> 1;                  // column within the tile
  const uint32_t planes_s = smem_u32(planes);

  // this thread's lanes (one per 64-lane block) and the policy's state
  typename Epi::Lane ln[MB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const long long lane = lane0 + 64 * mb + 16 * wl + g + 8 * hf;
    const bool valid = lane < mp.nlanes;
    const long long grp = valid ? lane / mp.C : 0;
    const long long c = valid ? lane - grp * mp.C : 0;
    ln[mb] = epi.lane(mp, lane, valid, grp, c);
  }

  int acc[MB][32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mb][i] = 0;
  int sr = 0;                              // this ring's load number
  for (int ct = wgi; ct < ntiles; ct += CONSUMERS) {
    const int col = ct * NT + cl;
    // what the column needs besides its result (the compared words): the
    // first lane's loads go out before the tile's dot, each next lane's
    // once the previous lane is done, under its own fold. One lane's words
    // in registers at a time: at 256 lanes the accumulators leave no room
    // for two.
    typename Epi::Fetch fx;
    epi.fetch(mp, ln[0], col, fx);
    for (int kk = 0; kk < k; ++kk) {
      const int slot = wgi * SLOTS + sr % SLOTS;
      if (kk % KS == 0) mbar_wait(full_s + 8 * slot, (sr / SLOTS) & 1);
      const uint64_t db = smem_desc(
          ring_s + slot * SLOT_BYTES + (kk % KS) * STEP_BYTES, 8 * 128, 128);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) acc_fence(acc[mb]);
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const uint64_t da = smem_desc(
            planes_s + (2 * kk * (TM / 8) + 8 * mb) * 128, 16 * TM, 128);
        wgmma_s8(acc[mb], da, db, kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) acc_fence(acc[mb]);
      if (kk > 0) wgmma_wait<1>();         // k-step kk-1 is done
      if (kk % KS == 0 && kk > 0) {        // ... and with it the last slot
        if (laneid == 0)
          mbar_arrive(empty_s + 8 * (wgi * SLOTS + (sr - 1) % SLOTS));
      }
      if (kk % KS == KS - 1 || kk == k - 1) ++sr;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) acc_fence(acc[mb]);
    if (laneid == 0)
      mbar_arrive(empty_s + 8 * (wgi * SLOTS + (sr - 1) % SLOTS));

    // the epilogue: fold, then the policy
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      uint32_t pw0[5], pw1[5], lo[5], hi[5];
      half_partial(acc[mb], 0, pw0);
      half_partial(acc[mb], 1, pw1);
      // the partner (tg ^ 1) holds the other half of the same column; each
      // thread keeps the row it owns and sends the other
#pragma unroll
      for (int w = 0; w < 5; ++w) {
        const uint32_t mine = hf ? pw1[w] : pw0[w];
        const uint32_t other = hf ? pw0[w] : pw1[w];
        const uint32_t recv = __shfl_xor_sync(0xFFFFFFFFu, other, 1);
        lo[w] = hf ? recv : mine;
        hi[w] = hf ? mine : recv;
      }
      uint32_t words[PL];
      fold_words(lo, hi, wf, words);
      epi.apply(mp, ln[mb], col, words, fx);
      if (mb + 1 < MB) epi.fetch(mp, ln[mb + 1], col, fx);
    }
  }
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
    epi.finish(mp, ln[mb], wgi * NT + cl, CONSUMERS * NT);
}

// Launch `kern` (a __global__ wrapper of band_gemm_body<MB, Src, Epi>
// taking the source policy `src` first) on `stream`.
template <int MB, typename Kernel, class Src, class Epi>
int launch_with(Kernel kern, const Src& src, const void* band,
                const EncodeMap& mp, const Epi& epi, const uint32_t* fold,
                void* stream) {
  WordFold wf;
  for (int j = 0; j < NW; ++j) wf.w[j] = fold[j];
  const size_t smem = smem_bytes(mp.k, MB);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid =
      static_cast<unsigned>((mp.nlanes + 64 * MB - 1) / (64 * MB));
  kern<<<grid, threads(MB), smem, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<const unsigned char*>(band), mp, wf, epi);
  return static_cast<int>(cudaGetLastError());
}

// The same for a kernel whose operands are loaded (LoadSrc) from `src`.
template <int MB, typename Kernel, class Epi>
int launch(Kernel kern, const void* src, const void* band,
           const EncodeMap& mp, const Epi& epi, const uint32_t* fold,
           void* stream) {
  return launch_with<MB>(kern, static_cast<const uint32_t*>(src), band, mp,
                         epi, fold, stream);
}

}  // namespace gemm
}  // namespace hb
