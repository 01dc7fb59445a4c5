"""Shared arithmetic core of the folded-band kernels, and the packed format.

Counterpart of ``honeybadgermpc_tpu/ops/fused_open.py``: the shared core
of the folded-band kernels, the packed format, and the faithful
three-kernel n-party open (``sim_open_fused_packed``, at the end). Every
band kernel of the port — the direct n-party open, the Vandermonde band
matmul, the three kernels of the faithful open — computes

    balanced base-256 int8 digit planes of the packed operand
      -> int8 x int8 -> int32 dot against a host-folded int8 band
      -> 32-diagonal carry-save fold into 19 limbs
      -> two 16-bit REDC rounds -> one conditional subtract -> pack.

This module holds the host routines that build the bands (numpy / ints,
byte-identical to the reference's) and plain-tensor twins of the device
core, from which every kernel's plain PyTorch version is built. The CUDA
twin of the same core is ``csrc/field_core.cuh``.

Balanced base-256 digit scheme: both operands decompose into 32 SIGNED
digits in [-128, 127] (any value < p fits: p's top byte is 0x73, so the
balanced carry never spills into a 33rd digit). Signedness is handled
without branching:
  * each int32 diagonal (|diag| <= NBAL*k*128^2) gets a +bias(k) offset so
    the carry-save fold stays unsigned;
  * the fold's accumulator is INITIALIZED with the 16-bit limbs of
    I = M*p - sum_r bias * 256^r (M chosen so every reachable value stays
    nonnegative), which cancels the bias mod p;
  * two REDC rounds bring the result under 2p — a single conditional
    subtract finishes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .band_gemm import _fold_array, _gemm_band, _gemm_plan, _gemm_split
from .limbs import L, MASK, N0, P, P_LIMBS, W

TB = 128            # chunk tile of the reference's layouts (kept for parity)
PL = 8              # packed limb rows: two 16-bit limbs per 32-bit word
NBAL = 32
_BAL_ROUNDS = 2
KMAX = 64
_NL = 19            # carry-save limbs of the fold accumulator
_D_STRIDE = 40      # words per row of a warp's transpose area (field_core.cuh)

_P = [int(x) for x in P_LIMBS]


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _bal_bias(k: int) -> int:
    """Max |diagonal|: NBAL*k products of balanced digits (|.| <= 2^14)."""
    return NBAL * k * (1 << 14)


def _bal_digits(x: int):
    """Balanced base-256 digits of 0 <= x < p (32 signed digits)."""
    out = []
    c = 0
    for _ in range(NBAL):
        u = (x & 0xFF) + c
        x >>= 8
        if u >= 128:
            out.append(u - 256)
            c = 1
        else:
            out.append(u)
            c = 0
    assert x == 0 and c == 0
    return out


def _bal_fold_init(k: int):
    """16-bit limbs of I = M*p - B0 (see scheme comment); M covers both the
    per-diagonal bias sum B0 and the most negative reachable value
    (|V| <= B0 by construction of bias(k))."""
    b0 = sum(_bal_bias(k) * (1 << (8 * r)) for r in range(NBAL))
    m = 2 * -(-b0 // P)
    i_val = m * P - b0
    assert i_val >= 0
    limbs = []
    for _ in range(_NL):
        limbs.append(i_val & 0xFFFF)
        i_val >>= 16
    assert i_val == 0
    return tuple(limbs)


def _folded_band_host(mat_int, rounds: int, ncp: int) -> np.ndarray:
    """mat_int: [k][ncols] plain-int matrix. Returns int8 band
    W[NBAL*ncp, NBAL*k] (ncp >= ncols, extra columns zero) with

      W[r*ncp + col, s*k + kk] = baldigit_r(m[kk][col] * 256^s
                                            * 2^(16*rounds) mod p)

    so that dotted against balanced base-256 planes of Montgomery-form
    data the diagonals represent sum_k a_mont_k * m_k * 2^(16*rounds) —
    after `rounds` 16-bit REDC steps the result is (sum a_k m_k) in
    Montgomery form."""
    k = len(mat_int)
    ncols = len(mat_int[0])
    assert ncp >= ncols
    band = np.zeros((NBAL * ncp, NBAL * k), np.int8)
    for kk in range(k):
        for col in range(ncols):
            for s in range(NBAL):
                w = mat_int[kk][col] * pow(
                    2, 8 * s + 16 * rounds, P) % P
                dig = _bal_digits(w)
                for r in range(NBAL):
                    band[r * ncp + col, s * k + kk] = dig[r]
    return band


def _pad_band(band: np.ndarray, kcols: int) -> np.ndarray:
    if band.shape[1] < kcols:
        band = np.concatenate(
            [band, np.zeros((band.shape[0], kcols - band.shape[1]),
                            np.int8)], axis=1)
    return band[None]           # leading block axis, as in the reference


def _lam_int(xs, x0):
    """lambda_j(x0): Lagrange basis of nodes xs evaluated at x0 (ints)."""
    out = []
    for j, xj in enumerate(xs):
        num, den = 1, 1
        for m_, xm in enumerate(xs):
            if m_ != j:
                num = num * (x0 - xm) % P
                den = den * (xj - xm) % P
        out.append(num * pow(den, P - 2, P) % P)
    return out


@functools.lru_cache(maxsize=None)
def _encode_band_np(points: tuple, k: int):
    """(band, n1): the folded int8 band [1, NBAL*n1, kcols] of the encode
    matrix E[i][j] = points[j]^i (k coefficients -> shares at the n
    points), n1 = round8(n). The first entry of `_bands_np`."""
    n = len(points)
    assert k <= KMAX, (k, "balanced scheme requires k <= 64")
    kcols = -(-(k * NBAL) // 32) * 32
    enc_mat = [[pow(int(points[j]), i, P) for j in range(n)]
               for i in range(k)]
    n1 = _round8(n)
    return _pad_band(_folded_band_host(enc_mat, _BAL_ROUNDS, n1), kcols), n1


@functools.lru_cache(maxsize=None)
def _bands_np(points: tuple, k: int):
    """Folded int8 bands of the three protocol matrices for a k-of-n
    code + layout metadata, byte-identical to the reference's:
    ((encode band, n1), (re-evaluate-then-interpolate band, n2),
    (coefficients-then-validate band, n3), rounds, kcols)."""
    from .fpmatmul import _lagrange_int_rows
    n = len(points)
    nv = n - k
    enc = _encode_band_np(points, k)
    rounds = _BAL_ROUNDS
    kcols = -(-(k * NBAL) // 32) * 32
    # [lam(points[k:]) | lam_0]: re-evaluation at the validation points
    # first, interpolate-at-0 last.
    xs = tuple(int(points[z]) % P for z in range(k))
    cols = [_lam_int(xs, int(points[z]) % P) for z in range(k, n)]
    cols.append(_lam_int(xs, 0))
    r1_mat = [[col[j] for col in cols] for j in range(k)]
    n2 = _round8(nv + 1)
    # [Minv | lam(points[k:])]: coefficients then validation, k + nv
    rows = _lagrange_int_rows(xs)
    cols = [[rows[j][i] for j in range(k)] for i in range(k)]
    for z in range(k, n):
        cols.append(_lam_int(xs, int(points[z]) % P))
    r2_mat = [[col[j] for col in cols] for j in range(k)]
    n3 = _round8(k + nv)
    return (enc,
            (_pad_band(_folded_band_host(r1_mat, rounds, n2), kcols), n2),
            (_pad_band(_folded_band_host(r2_mat, rounds, n3), kcols), n3),
            rounds, kcols)


def _kernel_band(band: np.ndarray, ncp: int, k: int) -> np.ndarray:
    """Re-lay a reference band [NBAL*ncp, >= NBAL*k] (row r*ncp + col,
    column s*k + kk) for the mma.sync band kernel (the direct open above
    k = 81, csrc/open_direct.cu's open_direct_mma_kernel): int32 [ncp, k,
    2, 32, 4], the A fragments of ``mma.sync.m16n8k32.s8`` in the order
    the threads load them. For column `col`, k-step `kk` (one operand's 32
    digits), m-tile `mt` (diagonals 16mt..16mt+15) and thread `l`
    (g = l >> 2, tg = l & 3), register j holds the four int8 band digits
    (lowest byte first)

        row r = 16*mt + g + 8*(j & 1),   s = 16*(j >> 1) + 4*tg + 0..3

    which is the PTX fragment layout of a row-major 16x32 int8 A tile. A
    pure permutation of the reference's bytes."""
    b = band[:, :NBAL * k].reshape(NBAL, ncp, NBAL, k)       # r, col, s, kk
    lane = np.arange(32)
    g, tg = lane >> 2, lane & 3
    j = np.arange(4)
    mt = np.arange(2)
    e = np.arange(4)
    r = (16 * mt[:, None, None] + g[None, :, None]
         + 8 * (j[None, None, :] & 1))                       # [mt, l, j]
    sdig = (16 * (j[None, :, None] >> 1) + 4 * tg[:, None, None]
            + e[None, None, :])                              # [l, j, e]
    # gather -> [mt, l, j, e, col, kk]
    frag = b[r[:, :, :, None], :, sdig[None, :, :, :], :]
    frag = np.ascontiguousarray(frag.transpose(4, 5, 0, 1, 2, 3))
    return frag.view(np.int32).reshape(ncp, k, 2, 32, 4)


def _smem_plan(k: int):
    """Launch shape of the mma.sync band kernel for a contraction of k
    operands: (tl lanes per block, wg column slots); the block has tl*wg
    threads. It keeps its lanes' digit planes (8k words per lane, row
    stride tl+8) and a 5 KB transpose area per warp in shared memory,
    inside the 227 KB a Hopper block may use. The kernels are bound by operand fetch latency
    and bandwidth, so many warps per block come first (16, on 64 lanes
    where they fit), fewer lanes and then fewer warps for long
    contractions."""
    for tl, threads in ((64, 512), (32, 512), (32, 256)):
        stage = (threads // 32) * 32 * _D_STRIDE * 4
        if 4 * PL * k * (tl + 8) + stage + 1024 <= 226 * 1024:
            return tl, threads // tl
    raise ValueError(f"contraction length {k} does not fit shared memory")


def _fold_consts(k: int):
    """(init limbs as a C array, bias) of the fold for contraction k."""
    init = (ctypes.c_uint32 * 19)(*_bal_fold_init(k))
    return init, _bal_bias(k)


def _launch_stream(t) -> int:
    """The raw CUDA stream a kernel on tensor `t` launches on. Kernels go
    to the current device's current stream, so `t` must live there."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# Packed format
# ---------------------------------------------------------------------------

def _wrap32(x64):
    """int64 holding a uint32 value -> int32 with the same bit pattern."""
    return torch.where(x64 >= (1 << 31), x64 - (1 << 32), x64).to(torch.int32)


def _u32(x32):
    """int32 bit pattern -> int64 holding the uint32 value."""
    return x32.to(torch.int64) & 0xFFFFFFFF


def pack_limbs(limbs):
    """[L, ...] 16-bit int32 limbs -> [PL, ...] packed int32 words."""
    rows = []
    for j in range(PL):
        hi = limbs[2 * j + 1]
        hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)   # sign half
        rows.append(limbs[2 * j] | (hi * 0x10000))
    return torch.stack(rows, dim=0)


def unpack_limbs(packed):
    """[PL, ...] packed int32 words -> [L, ...] 16-bit int32 limbs."""
    rows = []
    for w in range(PL):
        rows.append(packed[w] & 0xFFFF)
        rows.append((packed[w] >> 16) & 0xFFFF)
    return torch.stack(rows, dim=0)


# ---------------------------------------------------------------------------
# Plain-tensor twins of the device core (int64 arithmetic)
# ---------------------------------------------------------------------------

def _balance_bytes(us):
    """us: NBAL int64 byte tensors [k, lanes] -> int8 [NBAL*k, lanes]
    balanced planes (row s*k + kk) via the sequential carry chain:
    d_s = byte_s + c, minus 256 when >= 128. A carry out of the last digit
    (only possible for a value >= p) is dropped, as in the reference."""
    blocks = []
    c = None
    for s in range(NBAL):
        t = us[s] if c is None else us[s] + c
        ge = (t >= 128).to(torch.int64)
        blocks.append((t - (ge << 8)).to(torch.int8))
        c = ge
    return torch.cat(blocks, dim=0)


def _planes_of(limbs):
    """Balanced planes from UNPACKED 16-bit limbs int64 [L, k, lanes] (the
    deal's sampled coefficients never exist packed)."""
    us = [(limbs[s // 2] >> (8 * (s % 2))) & 0xFF for s in range(NBAL)]
    return _balance_bytes(us)


def _planes_of_packed(words):
    """Balanced planes from PACKED words int32 [PL, k, lanes]."""
    w64 = _u32(words)
    us = [(w64[s // 4] >> (8 * (s % 4))) & 0xFF for s in range(NBAL)]
    return _balance_bytes(us)


def _pack16(limbs):
    """L int64 16-bit limb tensors -> packed int32 [PL, ...]."""
    return _wrap32(torch.stack([limbs[2 * j] | (limbs[2 * j + 1] << 16)
                                for j in range(PL)], dim=0))


def _redc_step(t):
    """One 16-bit Montgomery REDC round on the carry-save limb list t:
    t <- (t + m*p) >> 16."""
    m = ((t[0] & MASK) * N0) & MASK
    for j in range(L):
        pr = m * _P[j]
        t[j] = t[j] + (pr & MASK)
        t[j + 1] = t[j + 1] + (pr >> W)
    carry0 = t[0] >> W
    t = t[1:] + [torch.zeros_like(t[0])]
    t[0] = t[0] + carry0
    return t


def _fold_reduce_bal(ds, init_limbs, bias):
    """NBAL signed int64 diagonal tensors (8-bit spacing, |d| <= bias) ->
    L canonical Montgomery limb tensors. The per-diagonal bias keeps the
    carry-save fold unsigned; `init_limbs` cancels it mod p. Two REDC
    rounds, one conditional subtract."""
    t = [torch.full_like(ds[0], int(init_limbs[j])) for j in range(_NL)]
    for r in range(NBAL):
        d = ds[r] + bias                         # 0 <= d < 2*bias <= 2^27
        j, off = divmod(8 * r, W)
        if off == 0:                             # 16-bit aligned: 2 chunks
            t[j] = t[j] + (d & 0xFFFF)
            t[j + 1] = t[j + 1] + (d >> 16)
        else:                                    # *2^8: 3 chunks
            t[j] = t[j] + ((d << 8) & 0xFFFF)
            t[j + 1] = t[j + 1] + ((d >> 8) & 0xFFFF)
            if j + 2 < _NL:
                t[j + 2] = t[j + 2] + (d >> 24)
    for _ in range(_BAL_ROUNDS):
        t = _redc_step(t)
    # value < 2p: carry-normalize and subtract p at most once
    c = torch.zeros_like(t[0])
    out = []
    for j in range(L):
        v = t[j] + c
        out.append(v & 0xFFFF)
        c = v >> 16
    hi = c + t[L]
    borrow = torch.zeros_like(t[0])
    d2 = []
    for j in range(L):
        v = out[j] - _P[j] - borrow
        d2.append(v & 0xFFFF)
        borrow = (v >> 16) & 1
    take = (hi != 0) | (borrow == 0)
    return [torch.where(take, d2[j], out[j]) for j in range(L)]


def _int_dot(w_blk, planes):
    """int8 [M, K] @ int8 [K, N] -> exact int64 [M, N]. CUDA PyTorch has no
    integer matmul, so on the card the dot runs in float64, which is exact
    here: |sum| <= NBAL*KMAX_DIRECT*2^14 = 2^26 < 2^53."""
    if w_blk.is_cuda:
        return (w_blk.to(torch.float64) @ planes.to(torch.float64)).to(
            torch.int64)
    return w_blk.to(torch.int64) @ planes.to(torch.int64)


def _band_dot_fold(w_blk, planes, ncp, init_limbs, bias):
    """int8 [NBAL*ncp, kcols] @ int8 [kcols, lanes] -> L canonical limb
    tensors of shape [ncp, lanes]. kcols may exceed the plane rows (zero
    band padding): only the first planes.shape[0] band columns count."""
    d = _int_dot(w_blk[:, :planes.shape[0]], planes)
    ds = [d[r * ncp:(r + 1) * ncp] for r in range(NBAL)]
    return _fold_reduce_bal(ds, init_limbs, bias)


def _mismatch(pred, recv):
    """pred, recv: packed int32 [PL, nv, lanes] -> int32 [lanes]: the
    number of validation points whose share differs in any word. The CUDA
    twin is field_core.cuh's ``mismatch``."""
    diff = torch.zeros_like(pred[0])
    for w in range(PL):
        diff = diff | (pred[w] ^ recv[w])
    return (diff != 0).sum(0).to(torch.int32)


# ---------------------------------------------------------------------------
# The faithful three-kernel open
#
#   K1 encode   party p's chunk c holds the k coefficients view[:, p, :, c];
#               predict its columns at all n points -> cols [PL, src, dst, C]
#   K2 R1       destination j decodes psi_j(0) of chunk c from the first k
#               sources' columns and validates the re-encoding against the
#               other n-k -> vals [PL, n, C], mismatches charged to j
#   K3 R2       the k secret coefficients of chunk c from the first k psi
#               values, validated against the other n-k -> secrets
#               [PL, k, C] and one mismatch total, charged to every
#               destination
#
# In the simulation every destination's K3 input is the same gathered
# vector, so K3 decodes it once: the secrets are one copy and every
# destination is charged the same count, which is the function the
# reference computes with one decode per destination. No chunk padding:
# the kernels take any chunk count C and mask their ragged edge (the
# reference pads C to a multiple of 128 for its BlockSpecs; zero chunks
# are valid sharings, so the padding changes no secret and no count).
# ---------------------------------------------------------------------------

launches_k1 = 0       # times each CUDA kernel was launched (and nowhere else)
launches_k2 = 0
launches_k3 = 0
# times a plain version of K1-K3 ran on a CUDA tensor: the card's paths
# must keep this at 0 (only a comparison against the kernels may move it)
plain_calls_on_cuda = 0
_PLAIN_LANES = 1 << 15     # lanes per step of the plain versions


def _k3_columns(n: int, k: int) -> tuple:
    """K3's kernel columns as columns of the reference's R2 band [Minv |
    lam(points[k:])]: the n - k compare columns first (kernel column
    col < nv predicts operand k + col, as CompareEpi has it), then the k
    coefficients (kernel column nv + s is coefficient s)."""
    return tuple(range(k, n)) + tuple(range(k))


@functools.lru_cache(maxsize=None)
def _open_kernel_bands(points: tuple, k: int):
    """The three bands in band_gemm tiles (numpy, ``_gemm_band``), each cut
    to the columns its kernel walks: K1's n encode columns, K2's nv + 1,
    K3's n in ``_k3_columns`` order. K2's tiles also serve the per-column
    check (ops/fused_randousha.py), on the same core."""
    n = len(points)
    nv = n - k
    (enc, n1), (r1, n2), (r2, n3), _, _ = _bands_np(points, k)
    return (_gemm_band(enc[0], n1, k, n), _gemm_band(r1[0], n2, k, nv + 1),
            _gemm_band(r2[0], n3, k, n, order=_k3_columns(n, k)))


@functools.lru_cache(maxsize=None)
def _open_bands(points: tuple, k: int, device: torch.device):
    """The three bands on `device`: ((reference-layout band [NBAL*ncp,
    kcols] int8, ncp, tile band or None), ...) for K1, K2, K3, plus the
    fold constants. The tiles (``_open_kernel_bands``) exist for CUDA
    devices only."""
    enc, r1, r2, _, _ = _bands_np(points, k)
    tiles = _open_kernel_bands(points, k) if device.type == "cuda" else \
        (None,) * 3
    out = []
    for (band, ncp), t in zip((enc, r1, r2), tiles):
        ref = torch.from_numpy(np.ascontiguousarray(band[0])).to(device)
        out.append((ref, ncp,
                    None if t is None else torch.from_numpy(t).to(device)))
    return tuple(out), _bal_fold_init(k), _bal_bias(k)


def _count_plain(x):
    global plain_calls_on_cuda
    if x.is_cuda:
        plain_calls_on_cuda += 1


def _k1_plain(view, points: tuple):
    """Plain version of K1: view int32 [PL, n, k, C] -> predicted columns
    int32 [PL, n_src, n_dst, C]."""
    _count_plain(view)
    _, n, k, C = view.shape
    ((band, ncp, _), _, _), init, bias = _open_bands(points, k,
                                                     view.device)
    cols = torch.empty((PL, n, n, C), dtype=torch.int32, device=view.device)
    for p in range(n):
        for c0 in range(0, C, _PLAIN_LANES):
            c1 = min(C, c0 + _PLAIN_LANES)
            planes = _planes_of_packed(view[:, p, :, c0:c1])
            out = _pack16(_band_dot_fold(band, planes, ncp, init, bias))
            cols[:, p, :, c0:c1] = out[:, :n]
    return cols


def _r1_lanes_plain(lanes, points: tuple, k: int):
    """K2's function lane by lane: lanes int32 [PL, n, nl] (operand i of
    lane g at [:, i, g]) -> (vals int32 [PL, nl], the value at 0 decoded
    from the first k operands; bad int32 [nl], how many of the other n-k
    differ from their prediction). Shared by K2's plain version and the
    per-column check's (ops/fused_randousha.py)."""
    _, n, nl = lanes.shape
    nv = n - k
    (_, (band, ncp, _), _), init, bias = _open_bands(points, k,
                                                     lanes.device)
    vals = torch.empty((PL, nl), dtype=torch.int32, device=lanes.device)
    bad = torch.empty((nl,), dtype=torch.int32, device=lanes.device)
    for l0 in range(0, nl, _PLAIN_LANES):
        l1 = min(nl, l0 + _PLAIN_LANES)
        planes = _planes_of_packed(lanes[:, :k, l0:l1])
        out = _pack16(_band_dot_fold(band, planes, ncp, init, bias))
        vals[:, l0:l1] = out[:, nv]
        bad[l0:l1] = _mismatch(out[:, :nv], lanes[:, k:, l0:l1])
    return vals, bad


def _k2_plain(cols, points: tuple, k: int):
    """Plain version of K2: cols int32 [PL, n_src, n_dst, C] -> (vals int32
    [PL, n, C] = psi_j(0) of every chunk, errs int32 [n] per destination)."""
    _count_plain(cols)
    _, n, _, C = cols.shape
    vals, bad = _r1_lanes_plain(cols.reshape(PL, n, n * C), points, k)
    return vals.reshape(PL, n, C), bad.reshape(n, C).sum(1).to(torch.int32)


def _k3_plain(vals, points: tuple, k: int):
    """Plain version of K3: vals int32 [PL, n, C] -> (secrets int32
    [PL, k, C], errs int32 [1]: the mismatches of the one decode, which
    every destination is charged)."""
    _count_plain(vals)
    _, n, C = vals.shape
    nv = n - k
    (_, _, (band, ncp, _)), init, bias = _open_bands(points, k,
                                                     vals.device)
    sec = torch.empty((PL, k, C), dtype=torch.int32, device=vals.device)
    bad = torch.zeros((1,), dtype=torch.int64, device=vals.device)
    for c0 in range(0, C, _PLAIN_LANES):
        c1 = min(C, c0 + _PLAIN_LANES)
        planes = _planes_of_packed(vals[:, :k, c0:c1])
        out = _pack16(_band_dot_fold(band, planes, ncp, init, bias))
        sec[:, :, c0:c1] = out[:, :k]
        bad += _mismatch(out[:, k:k + nv], vals[:, k:, c0:c1]).sum()
    return sec, bad.to(torch.int32)


def _gemm_args(k: int, nlanes: int, device):
    """(64-lane blocks per thread block, fold constants) of a launch on
    csrc/band_gemm.cuh with k operands per lane."""
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    return (_gemm_plan(k, nlanes, nsm),
            _fold_array(_bal_fold_init(k), _bal_bias(k)))


def _open_k1_cuda(view, points: tuple):
    """Launch K1 of csrc/open_fused.cu (on csrc/band_gemm.cuh) on view
    (CUDA) -> cols int32 [PL, n_src, n_dst, C]."""
    global launches_k1
    from .._build import lib
    _, n, k, C = view.shape
    tiles = _open_bands(points, k, view.device)[0][0][2]
    out = torch.empty((PL, n, n, C), dtype=torch.int32, device=view.device)
    rc = lib().hb_open_fused_k1(
        view.data_ptr(), tiles.data_ptr(), out.data_ptr(), n, k, C,
        *_gemm_args(k, n * C, view.device), _launch_stream(view))
    launches_k1 += 1
    if rc != 0:
        raise RuntimeError(
            f"open_fused K1 kernel launch failed: CUDA error {rc}")
    return out


def _open_k2_cuda(cols, points: tuple, k: int):
    """Launch K2 of csrc/open_fused.cu (on csrc/band_gemm.cuh) on cols
    (CUDA) -> (vals int32 [PL, n, C], errs int32 [n])."""
    global launches_k2
    from .._build import lib
    _, n, _, C = cols.shape
    tiles = _open_bands(points, k, cols.device)[0][1][2]
    vals = torch.empty((PL, n, C), dtype=torch.int32, device=cols.device)
    errs = torch.zeros(n, dtype=torch.int32, device=cols.device)
    rc = lib().hb_open_fused_k2(
        cols.data_ptr(), tiles.data_ptr(), vals.data_ptr(), errs.data_ptr(),
        n, k, C, *_gemm_args(k, n * C, cols.device), _launch_stream(cols))
    launches_k2 += 1
    if rc != 0:
        raise RuntimeError(
            f"open_fused K2 kernel launch failed: CUDA error {rc}")
    return vals, errs


def _open_k3_cuda(vals, points: tuple, k: int):
    """Launch K3 of csrc/open_fused.cu (on csrc/band_gemm.cuh, its column
    tiles split into groups over blocks) on vals (CUDA) -> (secrets int32
    [PL, k, C], errs int32 [1])."""
    global launches_k3
    from .._build import lib
    n = len(points)
    tiles = _open_bands(points, k, vals.device)[0][2][2]
    C = vals.shape[-1]
    nsm = torch.cuda.get_device_properties(vals.device).multi_processor_count
    mb, groups = _gemm_split(k, C, n, nsm)
    sec = torch.empty((PL, k, C), dtype=torch.int32, device=vals.device)
    errs = torch.zeros(1, dtype=torch.int32, device=vals.device)
    rc = lib().hb_open_fused_k3(
        vals.data_ptr(), tiles.data_ptr(), sec.data_ptr(), errs.data_ptr(), n,
        k, C, mb, groups, _fold_array(_bal_fold_init(k), _bal_bias(k)),
        _launch_stream(vals))
    launches_k3 += 1
    if rc != 0:
        raise RuntimeError(
            f"open_fused K3 kernel launch failed: CUDA error {rc}")
    return sec, errs


def _check_stage_input(x, name: str, dims: int):
    if x.dtype != torch.int32 or x.dim() != dims or x.shape[0] != PL:
        raise ValueError(f"{name} must be int32 [{PL}, ...] of {dims} dims, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def open_k1(view, points: tuple):
    """K1, encode: view int32 [PL, n, k, C] (party p's chunk c holds the k
    coefficients view[:, p, :, c]) -> cols int32 [PL, n_src, n_dst, C].
    csrc/open_fused.cu on a CUDA tensor, the plain version on a CPU one."""
    _check_stage_input(view, "view", 4)
    if view.is_cuda:
        return _open_k1_cuda(view, points)
    return _k1_plain(view, points)


def open_k2(cols, points: tuple, k: int):
    """K2, R1 decode and validate: cols int32 [PL, n_src, n_dst, C] ->
    (vals int32 [PL, n, C], errs int32 [n] charged to the destination)."""
    _check_stage_input(cols, "cols", 4)
    if cols.is_cuda:
        return _open_k2_cuda(cols, points, k)
    return _k2_plain(cols, points, k)


def open_k3(vals, points: tuple, k: int):
    """K3, R2 decode and validate: vals int32 [PL, n, C] -> (secrets int32
    [PL, k, C], errs int32 [1], the count every destination is charged)."""
    _check_stage_input(vals, "vals", 3)
    if vals.is_cuda:
        return _open_k3_cuda(vals, points, k)
    return _k3_plain(vals, points, k)


@functools.lru_cache(maxsize=None)
def _open_calls(n: int, k: int, cpad: int, points: tuple):
    """The three-kernel open of packed shares [PL, n, k*cpad] (chunk count
    cpad = C, unpadded) as a plain callable on the device of its argument:
    run(packed) -> (secrets int32 [PL, k*cpad], ONE copy — every
    destination decodes the same values —, nerr int32 [n]: R1 counts per
    destination plus the R2 count, which every destination is charged).
    run.parts = (K1, K2, K3) for tests and timing."""
    if k > KMAX:
        raise ValueError(f"the balanced scheme holds k <= {KMAX}, got {k}")
    if len(points) != n:
        raise ValueError(f"{len(points)} points for n={n} parties")

    def k1(view):
        return open_k1(view, points)

    def k2(cols):
        return open_k2(cols, points, k)

    def k3(vals):
        return open_k3(vals, points, k)

    def run(packed_kc):
        cols = k1(packed_kc.reshape(PL, n, k, cpad))
        vals, errs1 = k2(cols)
        del cols
        sec, errs2 = k3(vals)
        return sec.reshape(PL, k * cpad), errs1 + errs2

    run.parts = (k1, k2, k3)
    return run


def sim_open_fused_packed(packed, n: int, t: int, points: tuple,
                          robust: bool = True):
    """The faithful three-kernel open on PACKED shares int32 [PL, n, B]
    (the dealer's at-rest format; B % (t+1) == 0) -> (secrets PACKED
    [PL, n, B], nerr int32 [n], mismatches charged to the destination).
    Without a fallback the secrets are the broadcast view of one copy.

    robust=True: when any mismatch is seen (one host read of nerr.sum(),
    the only host sync the open adds), the whole open is redone by the
    generic two-round program with its Gao fallback
    (parallel/reconstruct.py::batch_reconstruct) on the unpacked shares,
    whose secrets and per-destination counts are returned instead: the
    reference's lax.cond(total == 0, fast, slow)."""
    k = t + 1
    if packed.dtype != torch.int32 or packed.dim() != 3 \
            or packed.shape[0] != PL or packed.shape[1] != n:
        raise ValueError(f"packed must be int32 [{PL}, {n}, B], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    B = packed.shape[-1]
    if B % k:
        raise ValueError(f"batch {B} is not a multiple of t+1 = {k}")
    points = tuple(int(x) % P for x in points)
    run = _open_calls(n, k, B // k, points)
    sec, nerr = run(packed.contiguous())
    if robust and int(nerr.sum()) != 0:
        from ..parallel.mesh import SimBackend
        from ..parallel.reconstruct import batch_reconstruct
        from .fparray import FpArray
        sec2, nerr2 = batch_reconstruct(SimBackend(n),
                                        FpArray(unpack_limbs(packed)), n, t,
                                        robust=True)
        return pack_limbs(sec2.limbs), nerr2.to(torch.int32)
    return sec[:, None, :].expand(PL, n, B), nerr


def sim_open_fused(shares_limbs, n: int, t: int, points: tuple,
                   robust: bool = True):
    """The three-kernel open of shares int32 [L, n, B] (B % (t+1) == 0) ->
    (secrets PACKED [PL, n, B], nerr [n]). See sim_open_fused_packed."""
    return sim_open_fused_packed(pack_limbs(shares_limbs), n, t, points,
                                 robust=robust)
