"""GF(p) matrix products through 7-bit digit planes and an int8 dot.

Counterpart of ``honeybadgermpc_tpu/ops/mxu_matmul.py``. A Montgomery
product sum_k a*v over GF(p) becomes an integer convolution of base-2^7
digits (0..127, exact in int8), one int8 matmul, and a short modular
epilogue. Two routes, chosen by shape exactly as the reference chooses
(``fused2_fits``, ``fused_fits``, called from ops/fpmatmul.py):

* ``fp_matmul_mxu2`` — the folded-constant scheme: the band operand
  w_dk = v_k * 2^(7d + 16 rounds) * R^-1 mod p is built on the device from
  v (``_folded_band_digits``: a mont_mul and ``_planes7``), so 37 output
  diagonals carry the already-reduced value and the epilogue is a 37-term
  fold, 1-2 REDC rounds and two conditional subtracts (``_fold_reduce``).
  On a CUDA tensor the dot and the epilogue are the hand-written kernel
  ``csrc/mxu_fused2.cu`` (planes, ``mma.sync`` and fold in one launch);
  ``_fused2_plain`` is its plain version.
* ``fp_matmul_mxu`` — the full product convolution: a's planes against a
  band of v's planes (pre-scaled by 2^16 R, ``_scaled_planes``) give 73
  diagonals, which a 17-round REDC epilogue reduces
  (``_redc_diagonals``). The dot is the library's int8 matmul
  (``torch._int_mm`` on the card), as the reference left it to XLA; the
  epilogue is the hand-written kernel ``csrc/mxu_redc.cu`` on a CUDA
  tensor. The reference's fused v1 kernel (``_fused_kernel``) is not
  ported: shapes where ``fused_fits`` holds raise on the card.

All integer work mirrors the reference's uint32 arithmetic (int64 tensors
masked to 32 bits where a uint32 would wrap), so the words are equal.
"""

from __future__ import annotations

import torch

from . import montgomery as mont
from .fused_open import _launch_stream
from .limbs import L, MASK, N0, P, P_LIMBS, R_MOD_P, W, int_to_limbs

PLANE_BITS = 7
NPLANES = 37                  # ceil(259 / 7) covers 256-bit values
NOUT = 2 * NPLANES - 1        # 73 product diagonals
REDC_ROUNDS = 17              # divide by 2^272
_P = [int(x) for x in P_LIMBS]
_M32 = 0xFFFFFFFF

# 2^(16*17-256) * R mod p: mont_mul(x, this) = x * 2^16, which cancels the
# 2^-16 surplus of the 17-round REDC
_SCALE_PRE = int_to_limbs((1 << (16 * REDC_ROUNDS - 256)) * R_MOD_P % P)

K_ROUNDS1 = (1 << 17) // (NPLANES * 127)      # = 27

# times each CUDA kernel was launched (counted there and nowhere else)
launches_fused2 = 0
launches_redc = 0
# times a plain version ran on CUDA tensors (only comparisons may do that)
plain_calls_on_cuda = 0


def _count_plain(x):
    global plain_calls_on_cuda
    if x.is_cuda:
        plain_calls_on_cuda += 1


def _planes7(limbs):
    """int32[L, ...] 16-bit limbs -> int8[..., NPLANES] base-2^7 digits.
    Digit d covers bits [7d, 7d+7), assembled from 1-2 limbs."""
    outs = []
    for d in range(NPLANES):
        j, r = divmod(PLANE_BITS * d, W)
        v = limbs[j] >> r
        if r + PLANE_BITS > W and j + 1 < L:
            v = v | (limbs[j + 1] << (W - r))
        outs.append((v & 0x7F).to(torch.int8))
    return torch.stack(outs, dim=-1)


def _scaled_planes(v_limbs):
    """v[L, k, n] Montgomery limbs -> int8[k, n, NPLANES] planes of
    v * 2^(16*REDC_ROUNDS-256) (the REDC pre-scale baked in)."""
    k, n = v_limbs.shape[1], v_limbs.shape[2]
    scale = mont.const_stack(_SCALE_PRE, (k, n), v_limbs.device)
    return _planes7(mont.mont_mul(v_limbs, scale))


def _build_vband(v_limbs):
    """v[L, k, n] -> V' int8[k*NPLANES, n*NOUT]: column (nn, l) holds plane
    l-i of v[:, nn] at row (kk, i)."""
    k, n = v_limbs.shape[1], v_limbs.shape[2]
    v8 = _scaled_planes(v_limbs)                   # [k, n, NPLANES]
    band = torch.zeros((k, NPLANES, n, NOUT), dtype=torch.int8,
                       device=v_limbs.device)
    for i in range(NPLANES):
        band[:, i, :, i:i + NPLANES] = v8
    return band.reshape(k * NPLANES, n * NOUT)


def _dot_s8(x, y):
    """Exact int8 x int8 -> int32 matmul [M, K] @ [K, N]. On the card the
    library's int8 GEMM (``torch._int_mm``: every side zero-padded to a
    multiple of 16, M to at least 32, the result sliced; y handed over
    column-major, since cuBLASLt refused some row-major shapes, e.g.
    [1040, 112] @ [112, 160], on an H100); on the CPU an int32 matmul.
    Callers keep every sum below 2^31."""
    if not x.is_cuda:
        return x.to(torch.int32) @ y.to(torch.int32)
    m, kd = x.shape
    n = y.shape[1]
    mp, kp, np_ = (max(-(-m // 16) * 16, 32), -(-kd // 16) * 16,
                   -(-n // 16) * 16)
    if (mp, kp) != (m, kd):
        x = torch.nn.functional.pad(x, (0, kp - kd, 0, mp - m))
    if (kp, np_) != (kd, n):
        y = torch.nn.functional.pad(y, (0, np_ - n, 0, kp - kd))
    return torch._int_mm(x.contiguous(), y.t().contiguous().t())[:m, :n]


def _add_at_bit(t, e, bit):
    """t (carry-save 16-bit limbs) += e * 2^bit, e < 2^32, as three
    16-bit chunks at limbs j, j+1, j+2."""
    j, r = divmod(bit, W)
    elo, ehi = e & MASK, e >> W
    t[j] = t[j] + ((elo << r) & MASK)
    if j + 1 < len(t):
        c1 = ((elo >> (W - r)) if r else 0) | ((ehi << r) & MASK)
        t[j + 1] = t[j + 1] + (c1 & MASK)
    if j + 2 < len(t) and r:
        t[j + 2] = t[j + 2] + (ehi >> (W - r))


def _pairs(d, count):
    """Diagonals (int64, values < 2^32) -> (bit, e) terms: adjacent pairs
    e = d_2i + (d_2i+1 << 7) mod 2^32 (the reference's uint32), the odd
    last one alone."""
    out = [(PLANE_BITS * i, (d[i] + (d[i + 1] << PLANE_BITS)) & _M32)
           for i in range(0, count - 1, 2)]
    if count % 2:
        out.append((PLANE_BITS * (count - 1), d[count - 1]))
    return out


def _redc_step(t):
    """One 16-bit Montgomery REDC round on carry-save limbs t (list of
    int64 tensors, each far below 2^32): t <- (t + m*p) >> 16."""
    m = ((t[0] & MASK) * N0) & MASK
    for j in range(L):
        if _P[j]:
            pr = m * _P[j]
            t[j] = t[j] + (pr & MASK)
            t[j + 1] = t[j + 1] + (pr >> W)
    carry0 = t[0] >> W
    t = t[1:] + [torch.zeros_like(t[0])]
    t[0] = t[0] + carry0
    return t


def _cond_sub_wide(limbs, hi):
    """Value hi*2^256 + limbs (canonical 16-bit limbs) < 3p: subtract p
    once if it is >= p. Returns (limbs, hi)."""
    borrow = torch.zeros_like(hi)
    d = []
    for j in range(L):
        v = limbs[j] - _P[j] - borrow
        d.append(v & MASK)
        borrow = (v >> W) & 1
    take = (hi != 0) | (borrow == 0)
    hi2 = torch.where(take, hi - borrow, hi)
    return [torch.where(take, d[j], limbs[j]) for j in range(L)], hi2


def _redc_diagonals(ds):
    """Plain version of the row-15 kernel (csrc/mxu_redc.cu): int32
    [NOUT, ...] diagonals (each < 2^31) -> int32 [L, ...] canonical
    Montgomery limbs. 36 carry-save limbs, 17 REDC rounds, one
    conditional subtract."""
    _count_plain(ds)
    d = ds.to(torch.int64) & _M32
    t = [torch.zeros_like(d[0]) for _ in range(36)]
    for bit, e in _pairs(d, NOUT):
        _add_at_bit(t, e, bit)
    for _ in range(REDC_ROUNDS):
        t = _redc_step(t)
    out, hi = mont._carry_chain(t)
    out, _ = _cond_sub_wide(out, hi)
    return torch.stack(out, 0).to(torch.int32)


def _rounds_for(k: int) -> int:
    return 1 if k <= K_ROUNDS1 else 2


def _fold_reduce(ds, rounds: int):
    """Plain version of the row-13 kernel's epilogue: int32 [NPLANES, ...]
    diagonals (7-bit spacing, total value V < 3p * 2^(16 rounds)) -> int32
    [L, ...] canonical limbs of V / 2^(16 rounds) mod p."""
    d = ds.to(torch.int64) & _M32
    t = [torch.zeros_like(d[0]) for _ in range(19)]
    for bit, e in _pairs(d, NPLANES):
        _add_at_bit(t, e, bit)
    for _ in range(rounds):
        t = _redc_step(t)
    out, c = mont._carry_chain(t)
    hi = c + t[L]
    out, hi = _cond_sub_wide(out, hi)
    out, hi = _cond_sub_wide(out, hi)
    return torch.stack(out, 0).to(torch.int32)


def _folded_band_digits(v_limbs, rounds: int):
    """v[L, k, n] Montgomery limbs -> int8[k, n, NPLANES(d), NPLANES(s)]:
    digit s of w_dk = v_kn * 2^(7d + 16*rounds) * R^{-1} mod p."""
    cs = torch.stack([
        mont.const_stack(int_to_limbs(pow(2, PLANE_BITS * d + 16 * rounds, P)),
                         (), v_limbs.device)
        for d in range(NPLANES)], dim=-1)                   # [L, NPLANES]
    w = mont.mont_mul(v_limbs[..., None], cs.reshape(L, 1, 1, NPLANES))
    return _planes7(w)                                       # [k, n, d, s]


def fused_fits(k: int, n: int) -> bool:
    """The reference's VMEM test for its fused v1 kernel (kept as a pure
    function of (k, n): it decides which route a shape takes)."""
    if n < 4:
        return False
    TN = min(n, 128)
    kcols = -(-(k * NPLANES) // 32) * 32
    band = NOUT * TN * kcols
    d32 = NOUT * TN * 128 * 4
    return band + d32 < 9 * 2 ** 20


def fused2_fits(k: int, n: int) -> bool:
    """The reference's VMEM test for its folded-constant kernel (a pure
    function of (k, n), as above)."""
    if n < 4 or NPLANES * k * 127 * 127 >= 2 ** 31:
        return False
    TN = min(n, 128)
    kcols = -(-(k * NPLANES) // 32) * 32
    band = NPLANES * TN * kcols
    d32 = NPLANES * TN * 128 * 4
    ablk = (L + 1) * k * 128 * 4
    return band + d32 + ablk < 6 * 2 ** 20


# -- row 13: the folded-constant kernel --------------------------------------

_FUSED2_THREADS = 512
_FUSED2_STAGE = (_FUSED2_THREADS // 32) * NPLANES * 40 * 4   # transpose areas


def _fused2_plan(k: int) -> int:
    """Lanes per 512-thread block of csrc/mxu_fused2.cu: its digit planes
    (k*37 rows padded to 32, row stride tl+8 bytes x 4) and 16 transpose
    areas must fit the 227 KB of shared memory a Hopper block may use."""
    kcols = -(-(k * NPLANES) // 32) * 32
    for tl in (64, 32):
        if kcols * (tl + 8) + _FUSED2_STAGE <= 226 * 1024:
            return tl
    raise NotImplementedError(
        f"k={k}: the fused MXU kernel keeps k*37 digit rows per lane in "
        "shared memory, which holds k <= 91")


def _fused2_band(wd):
    """Digits wd int8 [k, n, d, s] -> the kernel's band: int32
    [n, ksteps, 3, 32, 4], for column col, k-step ks (digit rows q = kk*37
    + d, 32 per step), m-tile mt (diagonals s = 16mt..16mt+15, zero above
    36) and thread l (g = l >> 2, tg = l & 3), register j holds the four
    int8 digits (lowest byte first) of row 16mt + g + 8(j & 1), columns
    32ks + 16(j >> 1) + 4tg + 0..3 — the PTX fragment layout of a row-major
    16x32 int8 A tile."""
    k, n = wd.shape[0], wd.shape[1]
    kq = k * NPLANES
    kcols = -(-kq // 32) * 32
    m = wd.permute(1, 3, 0, 2).reshape(n, NPLANES, kq)          # [n, s, q]
    m = torch.nn.functional.pad(m, (0, kcols - kq, 0, 48 - NPLANES))
    m = m.reshape(n, 3, 2, 8, kcols // 32, 2, 4, 4)   # mt h g ks half tg e
    m = m.permute(0, 4, 1, 3, 6, 5, 2, 7).contiguous()
    return m.view(torch.int32).reshape(n, kcols // 32, 3, 32, 4)


def _fused2_cuda(a, wd, rounds: int):
    """Launch csrc/mxu_fused2.cu: a int32 [L, B, k] (contiguous), wd the
    band digits [k, n, 37, 37] -> int32 [L, B, n]."""
    global launches_fused2
    from .._build import lib
    _, B, k = a.shape
    n = wd.shape[1]
    tl = _fused2_plan(k)
    band = _fused2_band(wd)
    out = torch.empty((L, B, n), dtype=torch.int32, device=a.device)
    kcols = -(-(k * NPLANES) // 32) * 32
    rc = lib().hb_mxu_fused2(a.data_ptr(), band.data_ptr(), out.data_ptr(),
                             B, k, n, rounds, tl, kcols, _launch_stream(a))
    launches_fused2 += 1
    if rc != 0:
        raise RuntimeError(f"mxu_fused2 kernel launch failed: CUDA error {rc}")
    return out


def _fused2_plain(a, wd, rounds: int):
    """Plain PyTorch version of the row-13 kernel: same digits, an exact
    integer dot (_dot_s8) and the same fold -> int32 [L, B, n]."""
    _count_plain(a)
    _, B, k = a.shape
    n = wd.shape[1]
    ap = _planes7(a).reshape(B, k * NPLANES)                   # q = kk*37+d
    w = wd.permute(0, 2, 1, 3).reshape(k * NPLANES, n * NPLANES)
    diag = _dot_s8(ap, w).reshape(B, n, NPLANES)
    return _fold_reduce(diag.permute(2, 0, 1), rounds)


def fp_matmul_mxu2(a_limbs, v_limbs):
    """a[L, B, k] @ v[L, k, n] (both Montgomery) -> [L, B, n] via the
    folded-constant scheme: the kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    k = a_limbs.shape[2]
    rounds = _rounds_for(k)
    wd = _folded_band_digits(v_limbs, rounds)                  # [k, n, d, s]
    a = a_limbs.contiguous()
    if a.is_cuda:
        return _fused2_cuda(a, wd, rounds)
    return _fused2_plain(a, wd, rounds)


# -- row 15: library dot + the REDC epilogue kernel --------------------------

def _redc_cuda(diag):
    """Launch csrc/mxu_redc.cu: int32 [NOUT, M] (contiguous) -> int32
    [L, M]."""
    global launches_redc
    from .._build import lib
    M = diag.shape[1]
    out = torch.empty((L, M), dtype=torch.int32, device=diag.device)
    rc = lib().hb_mxu_redc(diag.data_ptr(), out.data_ptr(), M,
                           _launch_stream(diag))
    launches_redc += 1
    if rc != 0:
        raise RuntimeError(f"mxu_redc kernel launch failed: CUDA error {rc}")
    return out


def _mxu_diagonals(a_limbs, v_limbs):
    """a[L, B, k], v[L, k, n] -> int32 [NOUT, B*n]: the 73 product
    diagonals of every output element, from one int8 dot."""
    _, B, k = a_limbs.shape
    n = v_limbs.shape[2]
    ap = _planes7(a_limbs).reshape(B, k * NPLANES)
    diag = _dot_s8(ap, _build_vband(v_limbs))             # [B, n*NOUT]
    return diag.reshape(B * n, NOUT).t().contiguous()


def fp_matmul_mxu(a_limbs, v_limbs):
    """a[L, B, k] @ v[L, k, n] (both Montgomery) -> [L, B, n] Montgomery:
    an int8 dot of a's planes against v's scaled band, then the REDC
    epilogue (the kernel on a CUDA tensor, its plain version on a CPU
    tensor)."""
    _, B, k = a_limbs.shape
    n = v_limbs.shape[2]
    if a_limbs.is_cuda and fused_fits(k, n):
        raise NotImplementedError(
            f"k={k}, n={n} takes the reference's fused v1 MXU kernel "
            "(mxu_matmul.py _fused_kernel), which is not ported yet")
    diag = _mxu_diagonals(a_limbs, v_limbs)
    if diag.is_cuda:
        out = _redc_cuda(diag)
    else:
        out = _redc_diagonals(diag)
    return out.reshape(L, B, n)
