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
// Same functions, bit for bit. sub_bcast_packed4 unpacks 8 packed words
// to 16 limbs of 16 bits and runs the reference's 16-limb borrow and
// add-back chains. The other three run on 32-bit words as read: a packed
// word IS a word of mont32.cuh's layout (limb 2j low, limb 2j+1 high), so
// mont32.cuh's CIOS product (mont_mul_w), modular add (add_mod_w) and
// subtract (sub_mod_w) take the words with nothing to unpack. Any correct
// Montgomery product with the same R has one canonical result, so the words
// are the reference's.
//
// What bounds them on an H100: bytes, all four. mul_add moves 4 x 32 bytes
// per element (0.24 ms for the 4D main path's 6.3 M elements) and needs
// about 320 integer instructions per element on 32-bit words (0.06 ms at
// the card's instruction rate). sub_bcast moves about 64 bytes per element
// against about 24 instructions (160 on the 16-bit limbs here).
//
// Design: one thread per element, neighbouring threads on neighbouring
// elements of the innermost axis, so every word row is read and written
// coalesced. A packed tensor is 8 word planes of M elements.
//
// mul_add_packed4 on [PL, n, R, S]: the grid's y index is the party and
// its x index runs over the R*S elements of the party's row, so no thread
// divides: element e of party j is g = j*R*S + e in every input plane. The
// result row (w, party) lands at a caller-given row stride, so the result
// can fill a buffer [PL, n, R*S + pad] whose zero tail makes the column
// count a multiple of the open's k (no concatenate pass). n is at most the
// grid's 65,535 rows (the wrapper checks).
//
// sub_bcast_packed4 reads plane w of `a` at a caller-given plane stride,
// so `a` can be a prefix view of the opened [PL, B] tensor. Offsets pass
// 2^31 bytes on the main path's tensors: size_t throughout.
//
// mul_add_packed on flat [PL, B]: bound by bytes (4 x 32 bytes per
// element; 0.22 ms for the 5.77 M elements of the eager triple finish at
// n=64, k=4096).
//
// sub_bcast_packed on flat words: 32 bytes of b read and 32 written per
// element, a read once per party row from L2 (0.111 ms at B = 90,112,
// n = 64, the flat triple finish). B is taken as it is: the last block
// masks the edge (the reference pads B to its tile, SUBS*512).
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

// Row 7: (a*b + c) mod p on [PL, n, R*S]; blockIdx.y is the party.
__global__ void mul_add_packed4_kernel(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       const uint32_t* __restrict__ c,
                                       uint32_t* __restrict__ out,
                                       long long M, long long RS,
                                       long long out_stride) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= RS) return;
  const size_t g = static_cast<size_t>(blockIdx.y) * RS + e;
  uint32_t xa[NW], xb[NW], xc[NW], ab[NW], res[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const size_t at = static_cast<size_t>(w) * M + g;
    xa[w] = a[at];
    xb[w] = b[at];
    xc[w] = c[at];
  }
  mont_mul_w(xa, xb, ab);
  add_mod_w(ab, xc, res);
  const size_t plane = static_cast<size_t>(gridDim.y) * out_stride;
  const size_t row = static_cast<size_t>(blockIdx.y) * out_stride + e;
#pragma unroll
  for (int w = 0; w < NW; ++w) out[w * plane + row] = res[w];
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

// M = n*R*S elements per input plane; out rows (w, party) at out_stride.
extern "C" int hb_mul_add_packed4(const void* a, const void* b, const void* c,
                                  void* out, long long M, long long RS,
                                  long long out_stride, void* stream) {
  const int threads = 128;
  const dim3 grid(static_cast<unsigned>((RS + threads - 1) / threads),
                  static_cast<unsigned>(M / RS));
  hb32::mul_add_packed4_kernel<<<grid, threads, 0,
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
