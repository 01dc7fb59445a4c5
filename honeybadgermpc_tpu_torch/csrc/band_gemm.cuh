// band_gemm: the Vandermonde band encode as one int8 GEMM per block, on
// Hopper's wgmma and bulk async copies. Runs band_matmul_kernel
// (band_matmul.cu), the direct open (open_direct.cu), K1, K2 and K3 of the
// three-kernel open and the per-column check (open_fused.cu), the deal
// (randousha_deal.cu) and both extractions (randousha_extract.cu); each
// brings its own operand source and epilogue policy (below). The MXU
// field matmuls (mxu_fused2.cu, mxu_fused.cu) run on a sibling body at the
// end of this header, mxu_gemm_body, on the same PTX layer and rings. The
// direct open above k = 81, where the planes of a 64-lane block no longer
// fit shared memory, keeps field_core.cuh's mma.sync core.
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
//              for all its columns. A kernel whose lane blocks alone leave
//              SMs idle (K3: one lane per chunk) splits the columns into
//              groups, one block per (lane block, group).
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

// Where a lane's operands live. Lane g = grp * C + c:
//   operand i, word w   src[w*sw + grp*sp + c*sc + i*si]
// The m result columns of a lane go to the kernel's epilogue policy.
// groups: column groups of a kernel that splits its tiles over blocks
// (band_gemm_body's SPLIT; the others leave it 0 and run one group).
struct EncodeMap {
  long long nlanes, C;
  long long sw, sp, sc, si;
  int k, m;
  int groups;
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
//   Total   errs[0]: K3's one decode, which every destination is charged.
//           The lane's count adds up in a register as for Group; finish()
//           sums the counts of the warp's 32 threads (__reduce_add_sync)
//           and its first thread makes one atomicAdd per 64-lane block
//           when the sum is not 0.
enum class Charge { Group, Lane, Source, Total };

// Compare and count (K2, the per-column check, the direct open, K3). A
// lane's first k operands decode a polynomial: column col < nv predicts
// operand k + col, which is compared with it; the stored columns nv ..
// nv + ns - 1 go to vals [PL, ns, nlanes] at lane g (column nv + s to
// vals[(w * ns + s) * nlanes + g]); a column past them (the empty half of
// an odd last tile) does nothing. K2, the check and the direct open store
// one column, nv (lam0, the value at 0: vals [PL, nlanes]); K3 (Total)
// stores ns = k, its polynomial's coefficients. Every caller's operand map
// puts lane g's operand i at src[w*sw + i*si + g] (grp * sp + c * sc = g),
// so the compared words are fetched ahead (band_gemm_body) from there.
// Honest shares make no atomic. The lane state is kept small: at 256 lanes
// a thread holds four.
template <Charge CH>
struct CompareEpi {
  uint32_t* vals;
  int* errs;
  const uint32_t* src;
  int nv;
  int ns;                  // stored columns (Total; the others store one)
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
    } else if (CH == Charge::Total) {
      const int s = col - nv;
      if (s < ns) {
#pragma unroll
        for (int w = 0; w < PL; ++w)
          vals[(static_cast<long long>(w) * ns + s) * mp.nlanes + ln.g] =
              words[w];
      }
    } else if (col == nv) {
      store(mp, ln, words);
    }
  }
  __device__ __forceinline__ void store(const EncodeMap& mp, const Lane& ln,
                                        const uint32_t (&words)[PL]) const {
#pragma unroll
    for (int w = 0; w < PL; ++w) vals[w * mp.nlanes + ln.g] = words[w];
  }
  // every thread of the consumer warps, in step
  __device__ __forceinline__ void finish(const EncodeMap& mp, const Lane& ln,
                                         int, int) const {
    if (CH == Charge::Total) {
      const int cnt = __reduce_add_sync(0xFFFFFFFFu, ln.bad);
      if (cnt != 0 && (threadIdx.x & 31) == 0) atomicAdd(&errs[0], cnt);
    } else if (CH != Charge::Source && ln.bad) {
      atomicAdd(&errs[CH == Charge::Group ? ln.g / mp.C : ln.g], ln.bad);
    }
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

// Drawn in registers (the deal, randousha_deal.cu): item (g, i) is
// coefficient i of lane g's polynomial, the uniform draw of Threefry-2x32-20
// at counters c0 = DEAL_CTR_TAG + 8 row + s (s = 0..5), c1 = g, through
// field_core.cuh's redc384_words (the sampler's reduction). Coefficient 0
// is global row 0 (the secret, the same in both degrees), coefficient
// i >= 1 row row1 + i - 1. The coefficients never reach device memory.
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

// SPLIT: the column tiles are split into mp.groups groups of
// ceil(tiles / groups) consecutive tiles; block b serves lane block
// b / groups and group b % groups (its planes are built by every block of
// its lanes, its band streams only its group's tiles). Without it a block
// serves all tiles of lane block b.
template <int MB, class Src, class Epi, bool SPLIT = false>
__device__ __forceinline__ void band_gemm_body(
    unsigned char* smem, const Src& src,
    const unsigned char* __restrict__ band, const EncodeMap& mp,
    const WordFold& wf, const Epi& epi) {
  constexpr int TM = 64 * MB;
  constexpr int CONSUMERS = consumers(MB);
  constexpr int NSLOT = CONSUMERS * SLOTS;
  const int k = mp.k;
  const int ntiles = (mp.m + NT - 1) / NT;
  const int groups = SPLIT ? mp.groups : 1;
  const int tpg = SPLIT ? (ntiles + groups - 1) / groups : ntiles;
  const int t0 = SPLIT ? static_cast<int>(blockIdx.x % groups) * tpg : 0;
  const int t1 = SPLIT ? min(t0 + tpg, ntiles) : ntiles;   // tiles t0..t1-1
  const int nst = (k + KS - 1) / KS;       // ring slots per tile
  unsigned char* planes = smem;
  const uint32_t ring_s = smem_u32(smem + static_cast<size_t>(NBAL) * k * TM);
  const uint32_t full_s = ring_s + NSLOT * SLOT_BYTES;     // mbarriers
  const uint32_t empty_s = full_s + 8 * NSLOT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, laneid = tid & 31;
  const long long lane0 =
      static_cast<long long>(SPLIT ? blockIdx.x / groups : blockIdx.x) * TM;
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
    const int ct = t0 + (sr / nst) * CONSUMERS + pr;
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
  const int nload =
      pr >= 0 ? ((t1 - t0 - pr + CONSUMERS - 1) / CONSUMERS) * nst : 0;
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
  for (int ct = t0 + wgi; ct < t1; ct += CONSUMERS) {
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
  const unsigned grid = static_cast<unsigned>(
      (mp.nlanes + 64 * MB - 1) / (64 * MB) * (mp.groups > 1 ? mp.groups : 1));
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

// ---------------------------------------------------------------------------
// The MXU geometry: GF(p) matmuls through unsigned 7-bit digit planes
// (rows 13 and 14 of PERF.md: mxu_fused2.cu, mxu_fused.cu)
// ---------------------------------------------------------------------------
//
// The same GEMM with another operand and another band:
//
//   D[lanes, cols x ND] = P[lanes, 37k] . Band^T[37k, cols x ND]
//
// P holds the 37 unsigned 7-bit digits of each of a lane's k operands
// (16-bit limbs in, digit d = bits 7d..7d+6); a column's band holds ND = 37
// (row 13, the folded scheme) or 73 (row 14, the product convolution)
// diagonals. The epilogue policy `Epi` (mxu_core.cuh's Fold37 or Redc73)
// turns a (lane, column)'s ND int32 diagonals into its 16 limbs.
//
//   chunks     the contraction runs in chunks of MXU_KC = 16 operands: chunk
//              c holds operands 16c.. at digit rows q = 37 (kk % 16) + d,
//              padded to whole k-steps of 32 (19 for a full chunk; the
//              last chunk ceil(37 kc / 32)). The band's digit rows follow
//              the same order; its padding rows are zero, so whatever the
//              planes hold there adds nothing.
//   planes     wgmma's K-major canonical layout per chunk, [k-step][16-byte
//              half][lane octet][lane % 8][16], built by a plane
//              warpgroup: an item is (lane, 4 operands) -> 148 digit bytes
//              = 37 aligned words (operand e's digit d at byte 37 e + d),
//              the 8 lanes x 4 items of a warp on 32 distinct banks.
//              Resident (nbuf = chunks): every chunk stays, built once
//              while the consumers start on the first. Streamed (nbuf = 2,
//              when the planes of k operands do not fit): two chunk buffers
//              behind mbarriers (full: built; empty: every consumer's
//              wgmmas on it are done), the next chunk's limb loads and
//              digit split under the current chunk's wgmmas.
//   band       tiles of MXU_TN = 80 rows, one wgmma B operand per (tile,
//              k-step): 2 columns of 37 diagonals (H = 2 threads of a quad
//              per column) or 1 column of 73 (H = 4). Band row r is
//              column (r % 8) / 2 / H of the tile and diagonal
//              20 ((r % 8) / 2 % H) + 2 (r / 8) + r % 2, zero past ND: in
//              the accumulator layout thread tg of a quad holds, for its
//              two rows, diagonals 20 (tg % H) .. + 19 of column tg / H
//              (ops/mxu_matmul.py::_mxu_tile_rows). Streamed by each
//              consumer's producer warp into its ring, as above.
//   dot        wgmma.m64n80k32.s32.s8.s8: per k-step MB wgmmas (one per
//              64-lane block) on one tile; 40 MB accumulators per thread.
//   tiles      resident: consumer warpgroup w takes tiles w, w + 2, ..., so
//              one's epilogue runs under the other's dot. Streamed: each
//              consumer holds one tile across all chunks, and the grid
//              has ceil(tiles / 2) blocks per 128 lanes, neighbours in
//              launch order so that their limb reads meet in L2.
//   epilogue   straight from the accumulators. A column's 2 MB lane slots
//              (64-lane block, row g or g + 8) go round its H threads: each
//              thread sends, over H - 1 __shfl_xor_sync rounds, its 20
//              diagonals of the slots the others own and receives theirs
//              of its own, then runs Epi on the ND diagonals of its slots.
//   results    out is [limb][lane][column]: a tile's 2 columns (or 1) are
//              8 bytes of a lane's row, and any store that leaves a
//              32-byte sector partly written cost as much as the old
//              kernel's 4-byte scatter. Where the block holds all columns
//              (one tile group), the consumers store 16-bit limbs to a
//              scratch [block][limb][column][lane] (16 lanes, 32 bytes per
//              store) and, once every tile is done, write out by whole lane
//              rows through the free planes and rings (mxu_transpose);
//              else (tile groups: small n) they store to out directly.

constexpr int MXU_L = 16;                    // limbs per element
constexpr int MXU_NDIG = 37;                 // 7-bit digits per operand
constexpr int MXU_KC = 16;                   // operands per plane chunk
constexpr int MXU_CHUNK_STEPS = (MXU_KC * MXU_NDIG + 31) / 32;   // 19
constexpr int MXU_TN = 80;                   // band rows per tile: wgmma N
constexpr int MXU_HALF = MXU_TN / 4;         // diagonals per thread and row
constexpr int MXU_STEP_BYTES = MXU_TN * 32;  // one k-step of one tile
constexpr int MXU_KS = 4;                    // k-steps per ring slot
constexpr int MXU_SLOT_BYTES = MXU_KS * MXU_STEP_BYTES;
constexpr int MXU_SLOTS = 2;                 // slots of each ring
constexpr int MXU_CONS = 2;                  // consumer warpgroups
constexpr int MXU_NBAR = 16;                 // chunk mbarriers of each kind
constexpr int MXU_THREADS = MXU_CONS * 128 + 128 + MXU_CONS * 32;

// k-steps of chunk c of a contraction over k operands.
__host__ __device__ inline int mxu_chunk_steps(int k, int c) {
  const int kc = k - MXU_KC * c < MXU_KC ? k - MXU_KC * c : MXU_KC;
  return (MXU_NDIG * kc + 31) / 32;
}

__host__ __device__ inline int mxu_ksteps(int k) {
  return (k / MXU_KC) * MXU_CHUNK_STEPS +
         (k % MXU_KC ? mxu_chunk_steps(k, k / MXU_KC) : 0);
}

// Dynamic shared memory of a block of 64 MB lanes with nbuf chunk buffers
// (resident: nbuf = chunks, sized to the contraction's k-steps).
__host__ __device__ inline size_t mxu_smem_bytes(int k, int mb, int nbuf) {
  const int nch = (k + MXU_KC - 1) / MXU_KC;
  const size_t steps = nbuf >= nch ? static_cast<size_t>(mxu_ksteps(k))
                                   : static_cast<size_t>(nbuf) *
                                         MXU_CHUNK_STEPS;
  return steps * 32 * 64 * mb +
         static_cast<size_t>(MXU_CONS) * MXU_SLOTS * MXU_SLOT_BYTES +
         16 * (MXU_CONS * MXU_SLOTS + MXU_NBAR);
}

__device__ __forceinline__ void acc_fence40(int (&d)[40]) {
#pragma unroll
  for (int i = 0; i < 40; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 80] (+)= A[64 x 32] . B[80 x 32]^T, int8 -> int32; scale_d = 0
// overwrites D.
__device__ __forceinline__ void mxu_wgmma(int (&d)[40], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The plane warpgroup: the block's chunks, in order, into their buffers
// (chunk c in buffer c % nbuf, that buffer's c / nbuf-th use). An item is
// (lane, 4 operands), a warp takes one
// lane octet at a time, thread (l8, jq) = (t % 8, t / 8 % 4). Its 64
// limbs are loaded 4 operands at a time (16 bytes) where k % 4 == 0, 2
// where k is even (and `a` aligned to match), else one by one; operands
// past k and lanes past B are zeros. The 148 digit bytes go out as 37
// words (operand e's digit d at byte 37 e + d), none past the chunk's
// k-steps (a resident last chunk ends there).
template <int MB>
__device__ __forceinline__ void mxu_build_block(
    unsigned char* bufs, const uint32_t* __restrict__ a, long long B, int k,
    long long lane0, int nbuf, uint32_t cfull_s, uint32_t cempty_s) {
  constexpr int TM = 64 * MB;
  constexpr int OCT = TM / 8;
  const int nch = (k + MXU_KC - 1) / MXU_KC;
  const size_t chunk_bytes = static_cast<size_t>(MXU_CHUNK_STEPS) * 32 * TM;
  const int bt = threadIdx.x - MXU_CONS * 128;
  const int bw = bt >> 5, l8 = bt & 7, jq = (bt >> 3) & 3;
  const size_t Bk = static_cast<size_t>(B) * k;
  const uintptr_t base = reinterpret_cast<uintptr_t>(a);
  const int vw = k % 4 == 0 && base % 16 == 0 ? 4
                 : (k % 2 == 0 && base % 8 == 0 ? 2 : 1);
  for (int c = 0; c < nch; ++c) {
    const int b = c % nbuf;
    if (c >= nbuf) mbar_wait(cempty_s + 8 * b, ((c / nbuf) - 1) & 1);
    unsigned char* row = bufs + b * chunk_bytes + l8 * 16;
    const int qend = 32 * mxu_chunk_steps(k, c);
    const int kk0 = MXU_KC * c + 4 * jq;
    for (int oct = bw; kk0 < k && oct < OCT; oct += 4) {
      const long long lane = lane0 + 8 * oct + l8;
      const uint32_t* p = a + static_cast<size_t>(lane) * k + kk0;
      uint32_t l[4][MXU_L];
      if (lane < B && kk0 + 3 < k && vw == 4) {
#pragma unroll
        for (int j = 0; j < MXU_L; ++j) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + j * Bk));
          l[0][j] = v.x; l[1][j] = v.y; l[2][j] = v.z; l[3][j] = v.w;
        }
      } else if (lane < B && kk0 + 3 < k && vw == 2) {
#pragma unroll
        for (int j = 0; j < MXU_L; ++j) {
          const uint2 v0 = __ldg(reinterpret_cast<const uint2*>(p + j * Bk));
          const uint2 v1 =
              __ldg(reinterpret_cast<const uint2*>(p + j * Bk + 2));
          l[0][j] = v0.x; l[1][j] = v0.y; l[2][j] = v1.x; l[3][j] = v1.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = lane < B && kk0 + e < k;
#pragma unroll
          for (int j = 0; j < MXU_L; ++j)
            l[e][j] = live ? __ldg(p + e + j * Bk) : 0u;
        }
      }
      // the four operands as eight 32-bit words each
      uint32_t w[4][9];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[e][i] = l[e][2 * i] | (l[e][2 * i + 1] << 16);
        w[e][8] = 0u;
      }
#pragma unroll
      for (int wd = 0; wd < MXU_NDIG; ++wd) {
        uint32_t word = 0;
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int t = 4 * wd + e4;                 // byte of the item
          const int e = t / MXU_NDIG, d = t % MXU_NDIG;
          const int bit = 7 * d, j = bit >> 5, r = bit & 31;
          const uint32_t v =
              r <= 25 ? (w[e][j] >> r)
                      : __funnelshift_r(w[e][j], w[e][j + 1], r);
          word |= (v & 0x7Fu) << (8 * e4);
        }
        const int q = 148 * jq + 4 * wd;             // digit row in the chunk
        if (q < qend)
          *reinterpret_cast<uint32_t*>(
              row + ((q >> 4) * OCT + oct) * 128 + (q & 15)) = word;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(cfull_s + 8 * b);
  }
}

// The consumers write the block's results out once every tile is done:
// 16-bit limbs [limb][column][lane] in tb (their scratch) to out[limb]
// [lane][col], lj limbs at a time through the planes and rings (free now;
// rows of `stride` words per lane, odd: no bank conflicts). Rows of 128
// lanes come in as 16-byte loads, 8 in flight per thread; whole lane rows
// go out, so every sector of out is written whole.
template <int MB>
__device__ __forceinline__ void mxu_transpose(
    uint32_t* sm, const uint16_t* __restrict__ tb, uint32_t* __restrict__ out,
    long long B, int n, int ncolsp, long long lane0, int lj) {
  constexpr int TM = 64 * MB;
  constexpr int NT = MXU_CONS * 128;         // consumer threads
  const int t = threadIdx.x;
  const int tw = t >> 5, laneid = t & 31;
  const int stride = ncolsp | 1;
  const int nval = B - lane0 < TM ? static_cast<int>(B - lane0) : TM;
  const size_t Bn = static_cast<size_t>(B) * n;
  // (the transpose)
  for (int j0 = 0; j0 < MXU_L; j0 += lj) {
    const int nj = MXU_L - j0 < lj ? MXU_L - j0 : lj;
    const int items = nj * n * (TM / 8);     // 8 lanes of one (limb, column)
    // every tile's results are in tb and the dot's reads of shared memory
    // are done, or the last step's reads of the staging are
    asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
    for (int i0 = t; i0 < items; i0 += 8 * NT) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * NT;
        const int jc = i / (TM / 8), l0 = 8 * (i % (TM / 8));
        const int jj = jc / n, c = jc - jj * n;
        if (i < items)
          v[u] = __ldcg(reinterpret_cast<const uint4*>(
              tb + (static_cast<size_t>(j0 + jj) * ncolsp + c) * TM + l0));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * NT;
        const int jc = i / (TM / 8), l0 = 8 * (i % (TM / 8));
        const int jj = jc / n, c = jc - jj * n;
        if (i < items) {
          uint32_t* d = sm + (jj * TM + l0) * stride + c;
          const uint32_t w4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[(2 * e) * stride] = w4[e] & 0xFFFFu;
            d[(2 * e + 1) * stride] = w4[e] >> 16;
          }
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
    for (int jj = 0; jj < nj; ++jj) {
      uint32_t* dst = out + static_cast<size_t>(j0 + jj) * Bn +
                      static_cast<size_t>(lane0) * n;
      for (int r = tw; r < nval; r += NT / 32)
        for (int c = laneid; c < n; c += 32)
          dst[static_cast<size_t>(r) * n + c] = sm[(jj * TM + r) * stride + c];
    }
  }
}

// This thread's diagonal 20 part + j (j < 20, part = tg % H) of lane slot
// s = 2 mb + h (row g + 8h of 64-lane block mb): accumulator 4 (j / 2) +
// 2h + j % 2 of block mb. s is known at run time only; j after unrolling.
template <int MB>
__device__ __forceinline__ int mxu_slot_diag(const int (&acc)[MB][40], int s,
                                             int j) {
  int v = 0;
#pragma unroll
  for (int x = 0; x < 2 * MB; ++x)
    if (x == s) v = acc[x >> 1][4 * (j >> 1) + 2 * (x & 1) + (j & 1)];
  return v;
}

template <int MB, int H, class Epi>
__device__ __forceinline__ void mxu_gemm_body(
    unsigned char* smem, const uint32_t* __restrict__ a,
    const unsigned char* __restrict__ band, uint32_t* __restrict__ out,
    uint16_t* __restrict__ tmp, long long B, int k, int n, int tgroups,
    int nbuf) {
  constexpr int TM = 64 * MB;
  constexpr int OCT = TM / 8;
  constexpr int CPT = 4 / H;                 // columns per tile
  constexpr int ND = Epi::NDIAG;
  constexpr int NSLOT = MXU_CONS * MXU_SLOTS;
  constexpr int OWN = 2 * MB / H;            // lane slots a thread owns
  static_assert(H * MXU_HALF >= ND && 2 * MB % H == 0, "MXU geometry");
  const int ntiles = (n + CPT - 1) / CPT;
  const int nch = (k + MXU_KC - 1) / MXU_KC;
  const int ksteps = mxu_ksteps(k);
  const bool stream = nbuf < nch;
  const int tpg = tgroups == 1 ? ntiles : MXU_CONS;
  const long long lane0 = static_cast<long long>(blockIdx.x / tgroups) * TM;
  const int t0 = static_cast<int>(blockIdx.x % tgroups) * tpg;
  const int t1 = t0 + tpg < ntiles ? t0 + tpg : ntiles;
  const int active = t1 - t0 < MXU_CONS ? t1 - t0 : MXU_CONS;
  const size_t chunk_bytes = static_cast<size_t>(MXU_CHUNK_STEPS) * 32 * TM;
  auto buf_off = [&](int c) { return (c % nbuf) * chunk_bytes; };
  const int ncolsp = ntiles * CPT;           // tmp's columns
  unsigned char* bufs = smem;
  const size_t plane_bytes =
      stream ? nbuf * chunk_bytes : static_cast<size_t>(ksteps) * 32 * TM;
  const uint32_t ring_s = smem_u32(smem + plane_bytes);
  const uint32_t full_s = ring_s + NSLOT * MXU_SLOT_BYTES;   // ring mbarriers
  const uint32_t empty_s = full_s + 8 * NSLOT;
  const uint32_t cfull_s = empty_s + 8 * NSLOT;              // chunk mbarriers
  const uint32_t cempty_s = cfull_s + 8 * MXU_NBAR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, laneid = tid & 31;
  uint16_t* const tblk =                     // this block's scratch
      tmp == nullptr ? nullptr
                     : tmp + static_cast<size_t>(blockIdx.x) * MXU_L *
                                 ncolsp * TM;

  if (tid == 0) {
    for (int s = 0; s < NSLOT; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, 4);
    }
    for (int b = 0; b < nbuf && b < MXU_NBAR; ++b) {
      mbar_init(cfull_s + 8 * b, 128);               // each plane thread
      mbar_init(cempty_s + 8 * b, 4 * active);       // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= MXU_CONS * 4 + 4) {                    // producer of ring pr
    const int pr = warp - (MXU_CONS * 4 + 4);
    if (laneid != 0 || pr >= active) return;
    const int nst = (ksteps + MXU_KS - 1) / MXU_KS;
    const int mine = (t1 - t0 - pr + MXU_CONS - 1) / MXU_CONS;
    for (int sr = 0; sr < mine * nst; ++sr) {
      const int ct = t0 + pr + (sr / nst) * MXU_CONS;
      const int kk0 = (sr % nst) * MXU_KS;
      const int steps = ksteps - kk0 < MXU_KS ? ksteps - kk0 : MXU_KS;
      const int slot = pr * MXU_SLOTS + sr % MXU_SLOTS;
      if (sr >= MXU_SLOTS)
        mbar_wait(empty_s + 8 * slot, ((sr / MXU_SLOTS) - 1) & 1);
      mbar_expect_tx(full_s + 8 * slot, steps * MXU_STEP_BYTES);
      bulk_load(ring_s + slot * MXU_SLOT_BYTES,
                band + (static_cast<size_t>(ct) * ksteps + kk0) *
                           MXU_STEP_BYTES,
                steps * MXU_STEP_BYTES, full_s + 8 * slot);
    }
    return;
  }
  if (warp >= MXU_CONS * 4) {                        // the plane warpgroup
    mxu_build_block<MB>(bufs, a, B, k, lane0, nbuf, cfull_s, cempty_s);
    return;
  }

  // the consumers
  const int wgi = warp >> 2;                 // consumer warpgroup = its ring
  const int wl = warp & 3;                   // warp within it: rows 16wl..
  const int g = laneid >> 2, tg = laneid & 3;
  const int part = tg % H;                   // diagonals 20 part .. + 19
  const int cl = tg / H;                     // column within the tile
  const uint32_t planes_s = smem_u32(bufs);
  const size_t Bn = static_cast<size_t>(B) * n;
  int acc[MB][40];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[mb][i] = 0;
  int sr = 0;                                // this ring's load number
  for (int ct = t0 + wgi; ct < t1; ct += MXU_CONS) {
    int ks = 0;
    for (int c = 0; c < nch; ++c) {
      const int b = c % nbuf;
      mbar_wait(cfull_s + 8 * b, (c / nbuf) & 1);
      const int csteps = mxu_chunk_steps(k, c);
      const uint32_t cbase = planes_s + static_cast<uint32_t>(buf_off(c));
      for (int kl = 0; kl < csteps; ++kl, ++ks) {
        const int slot = wgi * MXU_SLOTS + sr % MXU_SLOTS;
        if (ks % MXU_KS == 0)
          mbar_wait(full_s + 8 * slot, (sr / MXU_SLOTS) & 1);
        const uint64_t db = smem_desc(ring_s + slot * MXU_SLOT_BYTES +
                                          (ks % MXU_KS) * MXU_STEP_BYTES,
                                      (MXU_TN / 8) * 128, 128);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) acc_fence40(acc[mb]);
        wgmma_fence();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const uint64_t da =
              smem_desc(cbase + (2 * kl * OCT + 8 * mb) * 128, 16 * TM, 128);
          mxu_wgmma(acc[mb], da, db, ks > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) acc_fence40(acc[mb]);
        if (ks > 0) wgmma_wait<1>();         // k-step ks-1 is done
        if (ks % MXU_KS == 0 && ks > 0 && laneid == 0)   // ... its slot too
          mbar_arrive(empty_s + 8 * (wgi * MXU_SLOTS + (sr - 1) % MXU_SLOTS));
        if (stream && kl == 0 && c > 0 && laneid == 0)   // ... and its chunk
          mbar_arrive(cempty_s + 8 * ((c - 1) % nbuf));
        if (ks % MXU_KS == MXU_KS - 1 || ks == ksteps - 1) ++sr;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) acc_fence40(acc[mb]);
    if (laneid == 0) {
      mbar_arrive(empty_s + 8 * (wgi * MXU_SLOTS + (sr - 1) % MXU_SLOTS));
      if (stream) mbar_arrive(cempty_s + 8 * ((nch - 1) % nbuf));
    }

    // the epilogue: exchange, fold, store
    // Lane slot s = 2 mb + h (row g + 8h of 64-lane block mb) is owned by
    // part s % H (mxu_slot_diag: this thread's diagonals of slot s).
    const int col = ct * CPT + cl;
#pragma unroll
    for (int u = 0; u < OWN; ++u) {
      // got[x][j]: diagonal 20 (part ^ x) + j of the slot u H + part
      int got[H][MXU_HALF];
#pragma unroll
      for (int j = 0; j < MXU_HALF; ++j)
        got[0][j] = mxu_slot_diag<MB>(acc, u * H + part, j);
#pragma unroll
      for (int o = 1; o < H; ++o)
#pragma unroll
        for (int j = 0; j < MXU_HALF; ++j)
          got[o][j] = __shfl_xor_sync(
              0xFFFFFFFFu, mxu_slot_diag<MB>(acc, u * H + (part ^ o), j), o);
      int32_t ds[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int x = (i / MXU_HALF) ^ part;
        int v = got[0][i % MXU_HALF];
#pragma unroll
        for (int o = 1; o < H; ++o)
          if (x == o) v = got[o][i % MXU_HALF];
        ds[i] = v;
      }
      uint32_t limbs[MXU_L];
      Epi::run(ds, limbs);
      const int s = u * H + part;
      const int ll = 64 * (s >> 1) + 16 * wl + g + 8 * (s & 1);
      const long long lane = lane0 + ll;
      if (tblk != nullptr) {                 // 16 lanes x 32 B per store
        uint16_t* dst = tblk + static_cast<size_t>(col) * TM + ll;
#pragma unroll
        for (int j = 0; j < MXU_L; ++j)
          dst[static_cast<size_t>(j) * ncolsp * TM] =
              static_cast<uint16_t>(limbs[j]);
      } else if (lane < B && col < n) {
        uint32_t* dst = out + static_cast<size_t>(lane) * n + col;
#pragma unroll
        for (int j = 0; j < MXU_L; ++j)
          dst[static_cast<size_t>(j) * Bn] = limbs[j];
      }
    }
    // end of the epilogue
  }
  if (tblk != nullptr)
    mxu_transpose<MB>(reinterpret_cast<uint32_t*>(smem), tblk, out, B, n,
                      ncolsp, lane0,
                      static_cast<int>((full_s - planes_s) /
                                       (static_cast<size_t>(TM) *
                                        (ncolsp | 1) * 4)));
}

}  // namespace gemm
}  // namespace hb
