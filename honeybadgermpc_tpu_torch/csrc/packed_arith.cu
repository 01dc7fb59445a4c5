// packed_arith: elementwise GF(p) arithmetic on packed share tensors: the
// extraction kernels' native 4D layout [PL, n, R, S], and the flat [PL, B].
//
//   mul_add_packed4    (a*b + c) mod p, Montgomery product; replaces the TPU
//                      kernel honeybadgermpc_tpu/ops/pallas_field.py::
//                      _mul_add4_kernel (called through mul_add_packed4)
//   sub_bcast_packed4  (a - b) mod p with a [PL, R, S] shared by all n
//                      parties of b [PL, n, R, S]; replaces ops/
//                      pallas_field.py::_sub_bcast4_kernel (called through
//                      sub_bcast_packed4)
//   mul_add_packed     (a*b + c) mod p on flat [PL, B]; replaces ops/
//                      pallas_field.py::_mul_add_kernel (called through
//                      mul_add_packed)
//   sub_bcast_packed   (a - b) mod p on flat words, a [PL, B] shared by all
//                      n parties of b [PL, n, B]; replaces ops/
//                      pallas_field.py::_sub_bcast_kernel (called through
//                      sub_bcast_packed)
//
// Same functions, bit for bit: 8 packed words -> 16 limbs of 16 bits, the
// carry-save CIOS Montgomery product (per outer step every accumulator limb
// gains at most four 16-bit terms, so limbs stay below 2^23 in uint32), one
// carry normalization and one conditional subtract; the add and the
// subtract are 16-limb carry/borrow chains.
//
// What bounds them on an H100: bytes, both. mul_add moves 4 x 32 bytes per
// element (0.24 ms for the main path's 6.3 M elements); on 32-bit words the
// function needs about 320 integer instructions per element (0.06 ms at the
// card's instruction rate). This kernel, on the reference's 16-bit limbs,
// spends about 2,400 (0.45 ms), so it is limited by its own instruction
// count and not yet by memory: a 32-bit-word CIOS is the way to the bound.
// sub_bcast moves about 64 bytes per element against about 160 instructions
// here (24 needed) and runs close to its bytes.
//
// Design: one thread per element, neighbouring threads on neighbouring
// elements of the innermost axis, so every word row is read and written
// coalesced. A packed tensor is 8 word planes of M = n*R*S elements; an
// element's flat index g is the same in every plane. Two strides keep the
// callers free of copies:
//   * mul_add writes row (w, party) at a caller-given row stride, so the
//     result can land in a buffer [PL, n, R*S + pad] whose zero tail makes
//     the column count a multiple of the open's k (no concatenate pass);
//   * sub_bcast reads plane w of `a` at a caller-given plane stride, so `a`
//     can be a prefix view of the opened [PL, B] tensor.
// Offsets pass 2^31 bytes on the main path's tensors: size_t throughout.
//
// mul_add_packed is a kernel of its own on 32-bit words: a packed word IS
// a word of mont32.cuh's layout (limb 2j low, limb 2j+1 high), so it runs
// the 32-bit-word CIOS and modular add on the words as read, with nothing
// to unpack. Bound by bytes (4 x 32 bytes per element; 0.22 ms for the
// 5.77 M elements of the eager triple finish at n=64, k=4096), the function
// needing about 320 instructions per element on 32-bit words. One thread
// per element, every word plane read and written coalesced.
//
// sub_bcast_packed is the same on 32-bit words: mont32.cuh's borrow and
// add-back chains on the 8 words as read. Bound by bytes: 32 bytes of b
// read and 32 written per element, a read once per party row from L2
// (0.111 ms at B = 90,112, n = 64, the flat triple finish), against about
// 24 instructions per element. B is taken as it is: the last block masks
// the edge (the reference pads B to its tile, SUBS*512).
#include "field_core.cuh"
#include "mont32.cuh"

namespace hb {

__device__ __forceinline__ void unpack16(const uint32_t (&words)[PL],
                                         uint32_t (&limbs)[L]) {
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    limbs[2 * j] = words[j] & MASK;
    limbs[2 * j + 1] = words[j] >> 16;
  }
}

// a*b*R^-1 mod p, canonical, by carry-save CIOS.
__device__ __forceinline__ void mont_mul16(const uint32_t (&a)[L],
                                           const uint32_t (&b)[L],
                                           uint32_t (&out)[L]) {
  uint32_t t[L + 1];
#pragma unroll
  for (int j = 0; j <= L; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t pr = a[i] * b[j];
      t[j] += pr & MASK;
      t[j + 1] += pr >> 16;
    }
    const uint32_t m = ((t[0] & MASK) * N0) & MASK;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t pr = m * kP[j];
      t[j] += pr & MASK;
      t[j + 1] += pr >> 16;
    }
    const uint32_t carry0 = t[0] >> 16;    // t[0] = 0 mod 2^16 now
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] = t[j + 1];
    t[L] = 0u;
    t[0] += carry0;
  }
  normalize_cond_sub(t, t[L], out);
}

__global__ void mul_add_packed4_kernel(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       const uint32_t* __restrict__ c,
                                       uint32_t* __restrict__ out,
                                       long long M, long long RS,
                                       long long out_stride) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= M) return;
  const size_t n = static_cast<size_t>(M / RS);
  const size_t party = static_cast<size_t>(g / RS);
  const size_t e = static_cast<size_t>(g) - party * RS;
  uint32_t wa[PL], wb[PL], wc[PL];
#pragma unroll
  for (int w = 0; w < PL; ++w) {
    const size_t at = static_cast<size_t>(w) * M + g;
    wa[w] = a[at];
    wb[w] = b[at];
    wc[w] = c[at];
  }
  uint32_t la[L], lb[L], lc[L], prod[L], sum[L], res[L];
  unpack16(wa, la);
  unpack16(wb, lb);
  unpack16(wc, lc);
  mont_mul16(la, lb, prod);
#pragma unroll
  for (int j = 0; j < L; ++j) sum[j] = prod[j] + lc[j];
  normalize_cond_sub(sum, 0u, res);        // prod + c < 2p
  uint32_t wo[PL];
  pack16(res, wo);
#pragma unroll
  for (int w = 0; w < PL; ++w)
    out[(static_cast<size_t>(w) * n + party) * out_stride + e] = wo[w];
}

__global__ void sub_bcast_packed4_kernel(const uint32_t* __restrict__ a,
                                         const uint32_t* __restrict__ b,
                                         uint32_t* __restrict__ out,
                                         long long M, long long RS,
                                         long long a_stride) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= M) return;
  const size_t e = static_cast<size_t>(g % RS);
  uint32_t wa[PL], wb[PL];
#pragma unroll
  for (int w = 0; w < PL; ++w) {
    wa[w] = a[static_cast<size_t>(w) * a_stride + e];
    wb[w] = b[static_cast<size_t>(w) * M + g];
  }
  uint32_t la[L], lb[L], d[L], res[L];
  unpack16(wa, la);
  unpack16(wb, lb);
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = la[j] - lb[j] - borrow;
    d[j] = v & MASK;
    borrow = (v >> 16) & 1u;
  }
  uint32_t carry = 0;                      // add p back when a < b
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t v = d[j] + kP[j] * borrow + carry;
    res[j] = v & MASK;
    carry = v >> 16;
  }
  uint32_t wo[PL];
  pack16(res, wo);
#pragma unroll
  for (int w = 0; w < PL; ++w) out[static_cast<size_t>(w) * M + g] = wo[w];
}

}  // namespace hb

namespace hb32 {

__global__ void mul_add_packed_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      const uint32_t* __restrict__ c,
                                      uint32_t* __restrict__ out,
                                      long long B) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= B) return;
  uint32_t wa[NW], wb[NW], wc[NW], prod[NW], res[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const size_t at = static_cast<size_t>(w) * B + g;
    wa[w] = a[at];
    wb[w] = b[at];
    wc[w] = c[at];
  }
  mont_mul_w(wa, wb, prod);
  add_mod_w(prod, wc, res);
#pragma unroll
  for (int w = 0; w < NW; ++w) out[static_cast<size_t>(w) * B + g] = res[w];
}

__global__ void sub_bcast_packed_kernel(const uint32_t* __restrict__ a,
                                        const uint32_t* __restrict__ b,
                                        uint32_t* __restrict__ out,
                                        long long M, long long B,
                                        long long a_stride, long long b_plane,
                                        long long b_row) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= M) return;
  const long long party = g / B;
  const size_t e = static_cast<size_t>(g - party * B);
  const size_t bg = static_cast<size_t>(party * b_row) + e;
  uint32_t wa[NW], wb[NW], res[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    wa[w] = a[static_cast<size_t>(w) * a_stride + e];
    wb[w] = b[static_cast<size_t>(w) * b_plane + bg];
  }
  sub_mod_w(wa, wb, res);
#pragma unroll
  for (int w = 0; w < NW; ++w) out[static_cast<size_t>(w) * M + g] = res[w];
}

}  // namespace hb32

extern "C" int hb_mul_add_packed(const void* a, const void* b, const void* c,
                                 void* out, long long B, void* stream) {
  const int threads = 128;
  const unsigned grid = static_cast<unsigned>((B + threads - 1) / threads);
  hb32::mul_add_packed_kernel<<<grid, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), static_cast<uint32_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hb_mul_add_packed4(const void* a, const void* b, const void* c,
                                  void* out, long long M, long long RS,
                                  long long out_stride, void* stream) {
  const int threads = 128;
  const unsigned grid = static_cast<unsigned>((M + threads - 1) / threads);
  hb::mul_add_packed4_kernel<<<grid, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), static_cast<uint32_t*>(out), M, RS,
      out_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hb_sub_bcast_packed4(const void* a, const void* b, void* out,
                                    long long M, long long RS,
                                    long long a_stride, void* stream) {
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((M + threads - 1) / threads);
  hb::sub_bcast_packed4_kernel<<<grid, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), M, RS, a_stride);
  return static_cast<int>(cudaGetLastError());
}

// a: plane w at a + w*a_stride; b: row (w, party) at b + w*b_plane +
// party*b_row (rows dense, so b may be a column slice of a wider tensor);
// out: [PL, n, B] dense, M = n*B elements per plane.
extern "C" int hb_sub_bcast_packed(const void* a, const void* b, void* out,
                                   long long M, long long B,
                                   long long a_stride, long long b_plane,
                                   long long b_row, void* stream) {
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((M + threads - 1) / threads);
  hb32::sub_bcast_packed_kernel<<<grid, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), M, B, a_stride, b_plane, b_row);
  return static_cast<int>(cudaGetLastError());
}
