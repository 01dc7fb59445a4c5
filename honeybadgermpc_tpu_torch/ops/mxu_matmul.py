"""GF(p) matrix products through 7-bit digit planes and an int8 dot.

Counterpart of ``honeybadgermpc_tpu/ops/mxu_matmul.py``. A Montgomery
product sum_k a*v over GF(p) becomes an integer convolution of base-2^7
digits (0..127, exact in int8), one int8 matmul, and a modular epilogue.
Three routes, chosen by shape exactly as the reference chooses
(``fused2_fits``, ``fused_fits``, called from ops/fpmatmul.py):

* ``fp_matmul_mxu2`` — the folded-constant scheme: the band operand
  w_dk = v_k * 2^(7d + 16 rounds) * R^-1 mod p is built on the device from
  v (``_folded_band_digits``: a mont_mul and ``_planes7``), so 37 output
  diagonals carry the already-reduced value and the epilogue is a 37-term
  fold, 1-2 REDC rounds and two conditional subtracts (``_fold_reduce``).
  On a CUDA tensor: the kernel ``csrc/mxu_fused2.cu``; ``_fused2_plain``
  is its plain version.
* ``fp_matmul_mxu_fused`` — the full product convolution in one kernel:
  a's planes against the band of v's planes (pre-scaled by 2^16 R,
  ``_scaled_planes``) give 73 diagonals, which the 17-round REDC epilogue
  reduces (``_redc_diagonals``) without leaving the chip. On a CUDA tensor:
  ``csrc/mxu_fused.cu``; ``_fused_plain`` is its plain version.
* ``fp_matmul_mxu`` — the same convolution with the dot outside the
  kernel: the library's int8 matmul (``torch._int_mm`` on the card), as
  the reference left it to XLA, then the epilogue kernel
  ``csrc/mxu_redc.cu`` on a CUDA tensor. Where ``fused_fits`` holds it
  takes the fused kernel on the card, as the reference does on the TPU.

Both fused kernels are csrc/mxu_core.cuh's k-streamed kernel: digit planes
pass through shared memory in chunks of 32 operands, so every k that the
reference's predicates route to them runs.

The plain versions mirror the reference's integer work in int64, with one
deliberate difference: the reference folds adjacent diagonals in pairs,
d_2i + (d_2i+1 << 7), in uint32, which wraps once a diagonal reaches 2^25
(uniform inputs do from about k = 230), and then returns wrong words. The
port keeps that sum exact (``_pairs``; the kernels pair only where it
cannot wrap, k <= 55), so every route gives the true product; at the
shapes where the reference does not wrap the words are equal.
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

# 2^(16*17-256) * R mod p: mont_mul(x, this) = x * 2^16, which cancels the
# 2^-16 surplus of the 17-round REDC
_SCALE_PRE = int_to_limbs((1 << (16 * REDC_ROUNDS - 256)) * R_MOD_P % P)

K_ROUNDS1 = (1 << 17) // (NPLANES * 127)      # = 27

# times each CUDA kernel was launched (counted there and nowhere else)
launches_fused2 = 0
launches_fused = 0
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
    """t (carry-save 16-bit limbs) += e * 2^bit as 16-bit chunks at limbs
    j, j+1, j+2 (the last one holds all of e's bits above 32 - r)."""
    j, r = divmod(bit, W)
    elo, ehi = e & MASK, e >> W
    t[j] = t[j] + ((elo << r) & MASK)
    if j + 1 < len(t):
        t[j + 1] = t[j + 1] + ((elo >> (W - r)) | ((ehi << r) & MASK))
    if j + 2 < len(t):
        t[j + 2] = t[j + 2] + (ehi >> (W - r))


def _pairs(d, count):
    """Diagonals (int64, values < 2^31) -> (bit, e) terms: adjacent pairs
    e = d_2i + (d_2i+1 << 7), the odd last one alone. Exact in int64 (the
    reference's uint32 wraps here at large k; see the module docstring)."""
    out = [(PLANE_BITS * i, d[i] + (d[i + 1] << PLANE_BITS))
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
    d = ds.to(torch.int64)
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
    d = ds.to(torch.int64)
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


# -- the k-streamed kernels (rows 13 and 14, csrc/mxu_core.cuh) --------------

_KC = 32                          # operands per streamed chunk
_SMEM_MAX = 227 * 1024            # shared memory a Hopper block may use
_D_STRIDE = 40                    # staging row stride (ints) per warp
# m-tiles of 16 diagonals -> (threads per block, diagonals of the epilogue)
_STREAM = {3: (512, NPLANES), 5: (256, NOUT)}


def _kcols(k: int) -> int:
    """Digit rows k*37, padded to the 32 of an mma k-step. Chunks of 32
    operands are 1184 = 37 x 32 rows, so chunking adds no padding."""
    return -(-(k * NPLANES) // 32) * 32


def _pair_safe(k: int) -> bool:
    """d_2i + (d_2i+1 << 7) stays below 2^32 for diagonals < 37 k 127^2."""
    return 129 * NPLANES * k * 127 * 127 < 2 ** 32


def _stream_plan(k: int, mt: int):
    """(threads, lanes per block, dynamic shared bytes) of the k-streamed
    kernel with `mt` m-tiles at contraction k: the digit planes of one
    chunk (at most 1184 rows of tl + 8 bytes) and a staging area of
    diagonals x 40 ints per warp. It fits at every k."""
    threads, ndiag = _STREAM[mt]
    tl = 64
    smem = (min(_kcols(k), _KC * NPLANES) * (tl + 8)
            + threads // 32 * ndiag * _D_STRIDE * 4)
    if smem > _SMEM_MAX:
        raise ValueError(f"k={k}: {smem} bytes of shared memory")
    return threads, tl, smem


def _band_fragments(m, mt: int):
    """Band digits int8 [n, 16 mt, kcols] (rows = output diagonals, zero
    past the real ones; columns = digit rows q = kk*37 + d, zero past
    k*37) -> the kernels' band int32 [n, ksteps, mt, 32, 4]: for column col,
    k-step ks, m-tile mt and thread l (g = l >> 2, tg = l & 3), register j
    holds the four int8 digits (lowest byte first) of row 16mt + g + 8(j &
    1), columns 32ks + 16(j >> 1) + 4tg + 0..3 — the PTX fragment layout of
    a row-major 16x32 int8 A tile."""
    n, _, kcols = m.shape
    m = m.reshape(n, mt, 2, 8, kcols // 32, 2, 4, 4)   # mt h g ks half tg e
    m = m.permute(0, 4, 1, 3, 6, 5, 2, 7).contiguous()
    return m.view(torch.int32).reshape(n, kcols // 32, mt, 32, 4)


def _fused2_band(wd):
    """Folded digits wd int8 [k, n, d, s] -> row 13's band (3 m-tiles:
    diagonals s = 0..36, zero to 47)."""
    k, n = wd.shape[0], wd.shape[1]
    kq = k * NPLANES
    m = wd.permute(1, 3, 0, 2).reshape(n, NPLANES, kq)          # [n, s, q]
    m = torch.nn.functional.pad(m, (0, _kcols(k) - kq, 0, 48 - NPLANES))
    return _band_fragments(m, 3)


def _fused_band(v8):
    """Scaled planes v8 int8 [k, n, 37] -> row 14's band (5 m-tiles):
    diagonal l at digit row kk*37 + d holds digit l - d of v[kk] (0
    outside 0..36), diagonals 73..79 zero."""
    k, n = v8.shape[0], v8.shape[1]
    band = torch.zeros((n, 80, k, NPLANES), dtype=torch.int8,
                       device=v8.device)
    vt = v8.permute(1, 2, 0)                                     # [n, s, k]
    for d in range(NPLANES):
        band[:, d:d + NPLANES, :, d] = vt
    band = band.reshape(n, 80, k * NPLANES)
    band = torch.nn.functional.pad(band, (0, _kcols(k) - k * NPLANES))
    return _band_fragments(band, 5)


def _run_streamed(entry, a, band, n, *args):
    """Launch a k-streamed kernel: a int32 [L, B, k] (contiguous), band
    from _band_fragments -> int32 [L, B, n]."""
    _, B, k = a.shape
    mt = band.shape[2]
    _, tl, smem = _stream_plan(k, mt)
    out = torch.empty((L, B, n), dtype=torch.int32, device=a.device)
    rc = entry(a.data_ptr(), band.data_ptr(), out.data_ptr(), B, k, n,
               *args, tl, band.shape[1], smem, int(_pair_safe(k)),
               _launch_stream(a))
    if rc != 0:
        raise RuntimeError(f"MXU kernel launch failed: CUDA error {rc}")
    return out


def _fused2_cuda(a, wd, rounds: int):
    """Launch csrc/mxu_fused2.cu: a int32 [L, B, k] (contiguous), wd the
    band digits [k, n, 37, 37] -> int32 [L, B, n]."""
    global launches_fused2
    from .._build import lib
    out = _run_streamed(lib().hb_mxu_fused2, a, _fused2_band(wd),
                         wd.shape[1], rounds)
    launches_fused2 += 1
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


# -- row 14: the unfolded product convolution in one kernel ------------------

def _fused_cuda(a, v_limbs):
    """Launch csrc/mxu_fused.cu: a int32 [L, B, k] (contiguous), v [L, k,
    n] Montgomery limbs -> int32 [L, B, n]."""
    global launches_fused
    from .._build import lib
    out = _run_streamed(lib().hb_mxu_fused, a,
                        _fused_band(_scaled_planes(v_limbs)), v_limbs.shape[2])
    launches_fused += 1
    return out


def _fused_plain(a, v_limbs):
    """Plain PyTorch version of the row-14 kernel: the same 73 diagonals
    from an exact integer dot, the same REDC epilogue -> int32 [L, B, n]."""
    _, B, _ = a.shape
    return _redc_diagonals(_mxu_diagonals(a, v_limbs)).reshape(
        L, B, v_limbs.shape[2])


def fp_matmul_mxu_fused(a_limbs, v_limbs):
    """a[L, B, k] @ v[L, k, n] (both Montgomery) -> [L, B, n] through the
    73-diagonal product convolution and the 17-round REDC: the kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    a = a_limbs.contiguous()
    if a.is_cuda:
        return _fused_cuda(a, v_limbs)
    return _fused_plain(a, v_limbs)


# -- row 15: library dot + the REDC epilogue kernel --------------------------

def _redc_cuda(diag, k: int):
    """Launch csrc/mxu_redc.cu: int32 [NOUT, M] (contiguous) diagonals of a
    contraction over k -> int32 [L, M]."""
    global launches_redc
    from .._build import lib
    M = diag.shape[1]
    out = torch.empty((L, M), dtype=torch.int32, device=diag.device)
    rc = lib().hb_mxu_redc(diag.data_ptr(), out.data_ptr(), M,
                           int(_pair_safe(k)), _launch_stream(diag))
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
    tensor). On the card a shape where ``fused_fits`` holds takes the fused
    kernel instead, as the reference does on the TPU."""
    _, B, k = a_limbs.shape
    n = v_limbs.shape[2]
    if a_limbs.is_cuda and fused_fits(k, n):
        return fp_matmul_mxu_fused(a_limbs, v_limbs)
    diag = _mxu_diagonals(a_limbs, v_limbs)
    if diag.is_cuda:
        out = _redc_cuda(diag, k)
    else:
        out = _redc_diagonals(diag)
    return out.reshape(L, B, n)
