"""Host side of the Hopper band-encode core (``csrc/band_gemm.cuh``).

The band matmul (``ops/band_matmul.py``), K1, K2 and K3 of the three-kernel
open (``ops/fused_open.py``), the deal and both extractions
(``ops/fused_randousha.py``) run on one int8 GEMM core: per block, the
lanes' balanced digit planes [lanes, 32k] against the folded band [32k, 32
cols] through ``wgmma.m64n64k32.s8``, the band streamed through shared
memory in 2 KB tiles, the fold straight from the accumulators, then the
kernel's own epilogue policy (a store, K2's compare and count, the
extractions' two stores). The planes' operands come from the kernel's
source policy: loaded (``LoadSrc``) or, in the deal, drawn in registers
(``DrawSrc``). This module holds what the host does for it (the band's
tile layout and its device re-lay, the launch plan and its column
groups, the fold constants)
and plain twins of the layouts, of the draw's REDC and of the epilogue,
which the CPU tests hold against the reference.

Layouts: wgmma's K-major canonical layout without swizzle. A matrix of R
rows and 32 K bytes is stored as core matrices of 8 rows x 16 bytes, 128
contiguous bytes each; a descriptor names its start, the leading byte
offset LBO between the two 16-byte halves of a row's K bytes and the
stride byte offset SBO between 8-row groups (``_desc_walk``):

    byte (row, kb) at start + (kb // 16) * LBO + (row // 8) * SBO
                            + (row % 8) * 16 + kb % 16

  planes  per block of TM lanes, [k][2][TM/8][8][16]: digit s of operand kk
          of lane l at ((2 kk + s // 16) * TM/8 + l // 8) * 128
          + (l % 8) * 16 + s % 16. The A operand of 64-lane block mb at
          k-step kk starts at (2 kk * TM/8 + 8 mb) * 128; LBO = 16 TM,
          SBO = 128.
  band    [ceil(m/2)][k][2][8][8][16]: tile (column pair ct, k-step kk) is
          one B operand, 64 rows x 32 bytes; LBO = 1024, SBO = 128. Row n
          of a tile is column 2 ct + (n % 8) // 4 and diagonal
          16 ((n // 2) % 2) + 2 (n // 8) + n % 2: in wgmma's accumulator
          layout thread tg of a quad holds entries 8i + 2 tg + e of its
          rows, which are then diagonals 16 (tg & 1) + 2i + e of column
          tg >> 1 (``_tile_rows``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .limbs import P

PL = 8
NBAL = 32
NT = 2                      # output columns per band tile
TILE_N = NBAL * NT          # band rows per tile: wgmma's N
STEP_BYTES = TILE_N * NBAL  # one k-step of one tile
KS = 4                      # k-steps per slot of a band ring
SLOTS = 2                   # slots of each consumer warpgroup's ring
SMEM_MAX = 232448           # shared memory a Hopper block may use
NW = 10                     # 32-bit words of the fold value
M32 = 0xFFFFFFFF
P32 = tuple((P >> (32 * j)) & M32 for j in range(PL))


def consumers(mb: int) -> int:
    """Consumer warpgroups of a block of 64*mb lanes (band_gemm.cuh)."""
    return {1: 4, 2: 3, 4: 2}[mb]


def smem_bytes(k: int, mb: int) -> int:
    """Dynamic shared memory of a block of 64*mb lanes (band_gemm.cuh)."""
    return NBAL * k * 64 * mb + consumers(mb) * SLOTS * (KS * STEP_BYTES + 16)


def _gemm_plan(k: int, nlanes: int, nsm: int = 132) -> int:
    """64-lane blocks per thread block: the most whose planes fit shared
    memory and still give every SM a block, else one."""
    for mb in (4, 2, 1):
        if smem_bytes(k, mb) > SMEM_MAX:
            continue
        if mb > 1 and -(-nlanes // (64 * mb)) < nsm:
            continue
        return mb
    raise ValueError(f"contraction length {k} does not fit shared memory")


def _gemm_split(k: int, nlanes: int, m: int, nsm: int = 132):
    """(64-lane blocks per thread block, column groups) of a launch that
    may split its m columns' tiles over blocks (K3): _gemm_plan's, one
    group, where its lane blocks give every SM a block. Else 128-lane
    blocks where their planes fit (half the band's L2 stream of 64-lane
    ones, and three consumer warpgroups where 256-lane ones have two),
    and the most groups whose blocks still run in one wave (one block per
    SM resides; a second wave of smaller blocks was slower on an H100,
    PERF.md §6), each group keeping at least one tile per consumer
    warpgroup."""
    mb = _gemm_plan(k, nlanes, nsm)
    if -(-nlanes // (64 * mb)) >= nsm:
        return mb, 1
    mb = 2 if smem_bytes(k, 2) <= SMEM_MAX else 1
    most = max(1, -(-m // NT) // consumers(mb))
    return mb, max(1, min(most, nsm // -(-nlanes // (64 * mb))))


def _tile_rows():
    """(column within the tile, diagonal) of each of a band tile's rows."""
    n = np.arange(TILE_N)
    return (n % 8) // 4, 16 * ((n // 2) % 2) + 2 * (n // 8) + n % 2


def _gemm_band(band: np.ndarray, ncp: int, k: int, m: int,
               order=None) -> np.ndarray:
    """Re-lay a reference band [NBAL*ncp, >= NBAL*k] (row r*ncp + col,
    column s*k + kk) for csrc/band_gemm.cuh: int8 [ceil(m/2), k, 2048],
    one wgmma B tile per (column pair, k-step). Kernel column j is the
    reference's column j (ncp >= 2*ceil(m/2), as ncp is a multiple of 8),
    or order[j] (m distinct columns; the empty half of an odd last tile
    zero). A pure permutation of the reference's bytes."""
    ntiles = -(-m // NT)
    b = band[:, :NBAL * k].reshape(NBAL, ncp, NBAL, k)      # r, col, s, kk
    if order is None:
        assert NT * ntiles <= ncp, (m, ncp)
        order = np.arange(NT * ntiles)
    else:
        assert len(order) == m == len(set(order)) and max(order) < ncp
        b = np.concatenate([b, np.zeros_like(b[:, :1])], axis=1)
        order = np.array(list(order) + [ncp] * (NT * ntiles - m))
    colt, diag = _tile_rows()
    cols = order[NT * np.arange(ntiles)[:, None] + colt[None, :]]
    t = b[diag[None, :], cols]                  # [ntiles, 64 n, 32 s, kk]
    t = t.reshape(ntiles, 8, 8, 2, 16, k)       # ct, ng, r8, kc, byte, kk
    return np.ascontiguousarray(t.transpose(0, 5, 3, 1, 2, 4)).reshape(
        ntiles, k, STEP_BYTES)


def _relay_index(relay, nrows: int, rowlen: int) -> np.ndarray:
    """int64 array of relay's output shape: for every byte that `relay` (a
    pure permutation of the bytes of an int8 band [nrows, rowlen] into a
    kernel layout) puts out, its position in the flat band. So a band that
    only exists on the device is re-laid there with one gather. Found by
    sending the positions themselves through `relay`, one base-256 digit at
    a time."""
    size = nrows * rowlen
    assert size <= 1 << 24, size
    pos = np.arange(size, dtype=np.int64).reshape(nrows, rowlen)
    idx = 0
    for d in range(3):
        digit = ((pos >> (8 * d)) & 0xFF).astype(np.uint8).view(np.int8)
        idx = idx + (relay(digit).view(np.uint8).astype(np.int64) << (8 * d))
    return idx


@functools.lru_cache(maxsize=None)
def _gemm_band_index(ncp: int, k: int, m: int, rowlen: int) -> np.ndarray:
    """int64 [ceil(m/2), k, 2048]: the gather index that re-lays a flat
    reference band [NBAL*ncp, rowlen] into `_gemm_band`'s tiles."""
    return _relay_index(lambda b: _gemm_band(b, ncp, k, m), NBAL * ncp,
                        rowlen)


def _desc_walk(image: np.ndarray, start: int, lbo: int, sbo: int,
               rows: int) -> np.ndarray:
    """The [rows, 32] byte matrix a no-swizzle K-major wgmma descriptor
    (start, LBO, SBO; bytes) names in a shared-memory image."""
    r = np.arange(rows)[:, None]
    kb = np.arange(NBAL)[None, :]
    return image[start + (kb // 16) * lbo + (r // 8) * sbo + (r % 8) * 16
                 + kb % 16]


def _balance_words(words):
    """Packed words int64 [PL, ...] (uint32 values) -> digit words [PL, ...]:
    field_core.cuh's balance_word over the 8 words of an operand, the
    carry running from word to word."""
    carry = torch.zeros_like(words[0])
    out = []
    for w in range(PL):
        acc = torch.zeros_like(words[0])
        for e in range(4):
            u = ((words[w] >> (8 * e)) & 0xFF) + carry
            carry = (u >= 128).to(torch.int64)
            acc = acc | ((u & 0xFF) << (8 * e))
        out.append(acc)
    return torch.stack(out)


def _gemm_planes(words, tm: int) -> np.ndarray:
    """The kernel's shared-memory planes of every block: packed int32
    [PL, k, lanes] -> uint8 [nblk, k * 2 * tm * 16], lanes past the end
    zero (band_gemm.cuh's build_planes)."""
    _, k, lanes = words.shape
    nblk = -(-lanes // tm)
    dig = _balance_words(words.to(torch.int64) & M32)       # [PL, k, lanes]
    dig = torch.nn.functional.pad(dig, (0, nblk * tm - lanes))
    by = torch.stack([(dig >> (8 * e)) & 0xFF for e in range(4)], -1)
    by = by.to(torch.uint8).numpy()                 # [w, kk, lane, e]
    by = by.reshape(2, 4, k, nblk, tm // 8, 8, 4)   # kc, w4, kk, blk, oct, l8, e
    img = by.transpose(3, 2, 0, 4, 5, 1, 6)         # blk, kk, kc, oct, l8, w4, e
    return np.ascontiguousarray(img).reshape(nblk, k * 2 * tm * 16)


@functools.lru_cache(maxsize=None)
def _word_fold_consts(init_limbs: tuple, bias: int) -> tuple:
    """The fold constant in 32-bit words: I + bias * sum_r 256^r, where I
    (16-bit limbs `init_limbs`) starts fold_reduce_bal's accumulator and
    the bias is added to every diagonal there. Adding it once to the
    signed diagonals' sum gives the same value."""
    ival = sum(int(v) << (16 * j) for j, v in enumerate(init_limbs))
    ic = ival + bias * sum(1 << (8 * r) for r in range(NBAL))
    assert 0 <= ic < 1 << (32 * NW)
    return tuple((ic >> (32 * j)) & M32 for j in range(NW))


def _fold_array(init_limbs: tuple, bias: int):
    """_word_fold_consts as the C array a launch takes."""
    return (ctypes.c_uint32 * NW)(*_word_fold_consts(init_limbs, bias))


def _mul_wide(a, b: int):
    """a (int64 tensor of uint32 values) * b (< 2^32) -> (low, high) 32-bit
    halves, from 16-bit pieces (int64 holds no 64-bit product)."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a0 * b1 + a1 * b0
    lo = a0 * b0 + ((mid & 0xFFFF) << 16)
    hi = a1 * b1 + (mid >> 16) + (lo >> 32)
    return lo & M32, hi


def _half_partial(ds16):
    """16 signed diagonal tensors (8-bit spacing) -> their exact sum as four
    32-bit words and a signed fifth (band_gemm.cuh's half_partial)."""
    carry = torch.zeros_like(ds16[0])
    pw = []
    for w in range(4):
        x = (carry + ds16[4 * w] + ds16[4 * w + 1] * 256
             + ds16[4 * w + 2] * 65536 + ds16[4 * w + 3] * 16777216)
        pw.append(x & M32)
        carry = x >> 32
    pw.append(carry)
    return pw


def _redc384_words(x):
    """Plain twin of band_gemm.cuh's redc384_words: 12 int64 tensors of
    Threefry words (uint32 values; 384 bits T, little-endian) -> packed
    int32 [PL, ...] of T * 2^-144 mod p. Four 32-bit Montgomery rounds and
    one 16-bit round give the quotient of redc384's nine 16-bit rounds, a
    value < 2p; one conditional subtract, as in the kernel, word for
    word."""
    t = [xi & M32 for xi in x] + [torch.zeros_like(x[0])]
    for r in range(4):
        m = (-t[r]) & M32             # t_r * (-p^-1) mod 2^32; p = 1 mod 2^32
        c = torch.zeros_like(m)
        for j in range(PL):
            lo, hi = _mul_wide(m, P32[j])
            s = lo + t[r + j] + c
            t[r + j] = s & M32
            c = hi + (s >> 32)
        for j in range(r + PL, 13):
            s = t[j] + c
            t[j] = s & M32
            c = s >> 32
    m16 = (-t[4]) & 0xFFFF            # one 16-bit round
    c = torch.zeros_like(m16)
    for j in range(PL):
        s = m16 * P32[j] + t[4 + j] + c
        t[4 + j] = s & M32
        c = s >> 32
    t[12] = (t[12] + c) & M32
    v = [((t[4 + j] >> 16) | (t[5 + j] << 16)) & M32 for j in range(PL)]
    hi = t[12] >> 16
    borrow = torch.zeros_like(hi)
    dif = []
    for j in range(PL):
        d = v[j] - P32[j] - borrow
        dif.append(d & M32)
        borrow = (d < 0).to(torch.int64)
    take = (hi != 0) | (borrow == 0)
    out = torch.stack([torch.where(take, dif[j], v[j]) for j in range(PL)])
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def _fold_reduce_words(ds, fold: tuple):
    """Plain twin of the core's epilogue (band_gemm.cuh: half_partial for
    diagonals 0-15 and 16-31, then fold_words): NBAL signed int64 diagonal
    tensors and the fold constant's words -> packed int32 [PL, ...]. One
    Montgomery step by 2^32 stands for fold_reduce_bal's two 16-bit REDC
    rounds: both add the multiple of p that clears the low 32 bits, so
    the value, and after one conditional subtract the words, agree."""
    lo, hi = _half_partial(ds[:16]), _half_partial(ds[16:])
    v, c = [], torch.zeros_like(ds[0])
    for w in range(NW):
        x = c + fold[w]
        if w < 4:
            x = x + lo[w]
        elif w == 4:
            x = x + lo[4] + hi[0]
        elif w < 8:
            x = x + hi[w - 4]
        elif w == 8:
            x = x + hi[4]
        v.append(x & M32)
        c = x >> 32
    mq = (-v[0]) & M32                # v0 * (-p^-1 mod 2^32); p = 1 mod 2^32
    cc = torch.zeros_like(v[0])
    for j in range(NW):
        x = v[j] + cc
        if j < PL:
            plo, phi = _mul_wide(mq, P32[j])
            x = x + plo
            cc = phi + (x >> 32)
        else:
            cc = x >> 32
        v[j] = x & M32
    borrow = torch.zeros_like(v[0])
    dif = []
    for j in range(PL):
        x = v[j + 1] - P32[j] - borrow
        dif.append(x & M32)
        borrow = (x < 0).to(torch.int64)
    take = (v[NW - 1] != 0) | (borrow == 0)
    out = torch.stack([torch.where(take, dif[j], v[j + 1])
                       for j in range(PL)])
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
