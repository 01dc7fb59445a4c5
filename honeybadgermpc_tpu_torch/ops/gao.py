"""Gao Reed-Solomon error-correcting decode over a batch.

Counterpart of ``honeybadgermpc_tpu/ops/gao.py``. Every polynomial lives in
a fixed-size coefficient buffer [m+1] with a degree per batch instance, and
the extended Euclidean algorithm runs a FIXED number of masked,
division-free elimination steps (cross-multiplying by leading coefficients
instead of dividing; (g, v) are only needed up to a common scalar, which
cancels in f = g / v):

    r0' = lc(r1) * r0 - lc(r0) * X^(d0-d1) * r1      (deg drops by >= 1)

The trip counts are part of the function: 2m elimination steps, then m+1
long-division steps, whatever the data; an instance that is done keeps its
state through the remaining steps. Error positions come out as the shares
that disagree with the re-encoded decoded polynomial.

The reference reads a leading coefficient with a one-hot masked sum and
shifts by X^s with a log-decomposed pad-and-select, because per-lane
gathers scalarize on the TPU; here both are ``torch.gather`` with index
arithmetic, which gives the same words. Each step's products go through
``montgomery.mont_mul``: the elementwise kernel on a CUDA tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import montgomery as mont
from .fparray import FpArray, dev_const
from .limbs import L, P, R_MOD_P, ints_to_limbs


def _poly_degree(limbs):
    """Highest nonzero coefficient index (or -1): limbs [L, ..., M] ->
    int64 [...]."""
    m = limbs.shape[-1]
    ar = torch.arange(m, device=limbs.device)
    return torch.where(~mont.is_zero_mask(limbs), ar, -1).amax(-1)


def _gather_coeff(limbs, idx):
    """limbs[L, ..., M] at per-instance coefficient index idx[...] (negative
    indices read coefficient 0) -> [L, ...]."""
    i = idx.clamp(min=0)[None, ..., None].expand(limbs.shape[:-1] + (1,))
    return limbs.gather(-1, i)[..., 0]


def _shift_poly(limbs, s):
    """Multiply by X^s (per-instance shift s[...] >= 0): out[i] = in[i-s],
    zero below s."""
    m = limbs.shape[-1]
    src = torch.arange(m, device=limbs.device) - s[..., None]    # [..., M]
    picked = limbs.gather(-1, src.clamp(min=0)[None].expand(limbs.shape))
    return torch.where((src >= 0)[None], picked, torch.zeros_like(picked))


def _one_hot_mul(value_limbs, idx, m):
    """value * X^idx as a dense [L, ..., m] tensor."""
    hot = torch.arange(m, device=idx.device) == idx[..., None]   # [..., m]
    v = value_limbs[..., None].expand(value_limbs.shape + (m,))
    return torch.where(hot[None], v, torch.zeros_like(v))


@lru_cache(maxsize=None)
def _g0_coeffs(xs: tuple):
    """A(X) = prod (X - x_i) as Montgomery limbs [L, m+1] (host exact)."""
    a = [1]
    for x in xs:
        nxt = [0] * (len(a) + 1)
        for i, c in enumerate(a):
            nxt[i] = (nxt[i] - c * x) % P
            nxt[i + 1] = (nxt[i + 1] + c) % P
        a = nxt
    return ints_to_limbs(np.asarray([c * R_MOD_P % P for c in a],
                                    dtype=object))


@lru_cache(maxsize=None)
def _gao_vand_np(xs: tuple, rows: int):
    """Re-encode matrix V[i][j] = xs[j]^i (Montgomery numpy, host-cached)."""
    v = np.asarray([[pow(x, i, P) * R_MOD_P % P for x in xs]
                    for i in range(rows)], dtype=object)
    return ints_to_limbs(v)


def gao_robust_decode(enc, zs, ys: FpArray, k: int):
    """Decode degree<k messages from shares ys[..., m] of parties zs, with up
    to (m-k)//2 wrong shares. Returns (coeffs[..., k], reenc[..., m],
    ok[...]): reenc is the decoded codeword at the parties' points (shares
    that disagree with it are the errors); ok=False where more than
    (m-k)//2 errors made decoding fail."""
    zs = tuple(int(z) for z in zs)
    if ys.shape[-1] != len(zs) or k > len(zs):
        raise ValueError(f"{ys.shape[-1]} shares of {len(zs)} parties, k={k}")
    xs = tuple(enc.points[z] for z in zs)
    g1 = enc.decode(zs, ys)                                # [..., m]
    return _gao_from_g1(xs, k, g1)


def gao_decode_points(xs, ys: FpArray, k: int):
    """gao_robust_decode over arbitrary evaluation points xs (no Encoding
    domain). Same returns as gao_robust_decode."""
    from .fpmatmul import vandermonde_batch_interpolate
    xs = tuple(int(x) % P for x in xs)
    if ys.shape[-1] != len(xs) or k > len(xs):
        raise ValueError(f"{ys.shape[-1]} shares at {len(xs)} points, k={k}")
    g1 = vandermonde_batch_interpolate(xs, ys)             # [..., m]
    return _gao_from_g1(xs, k, g1)


def _gao_from_g1(xs: tuple, k: int, g1: FpArray):
    m = len(xs)
    g0 = dev_const(_g0_coeffs, (xs,), g1.device)                 # [L, m+1]
    vand = dev_const(_gao_vand_np, (xs, m + 1), g1.device)       # [L, m+1, m]
    return _gao_kernel(m, k)(g1.limbs, g0, vand)


@lru_cache(maxsize=None)
def _gao_kernel(m: int, k: int):
    """The decoder for shape (m, k); the x-set enters through g0 and vand."""
    from .fpmatmul import _matmul_kernel
    M = m + 1
    stop2 = m + k            # continue while 2*deg(r1) >= m+k
    n_eea = 2 * m            # each step drops max(d0, d1) by >= 1

    def kernel(g1_limbs, g0, vand):
        batch = tuple(g1_limbs.shape[1:-1])
        dev = g1_limbs.device
        r1 = torch.cat([g1_limbs, g1_limbs.new_zeros((L,) + batch + (1,))],
                       -1)                                     # [L, ..., M]
        r0 = g0.reshape((L,) + (1,) * len(batch) + (M,)).expand(r1.shape)
        zpoly = torch.zeros_like(r1)
        v0 = zpoly
        v1 = torch.cat([mont.one_mont(batch + (1,), dev),
                        g1_limbs.new_zeros((L,) + batch + (M - 1,))], -1)
        d0 = torch.full(batch, m, dtype=torch.int64, device=dev)
        d1 = _poly_degree(r1)

        for _ in range(n_eea):
            active = (2 * d1 >= stop2) & (d1 >= 0)
            lc0 = _gather_coeff(r0, d0)[..., None]             # [L, ..., 1]
            lc1 = _gather_coeff(r1, d1)[..., None]
            sh = (d0 - d1).clamp(min=0)
            r1s = _shift_poly(r1, sh)
            v1s = _shift_poly(v1, sh)
            r0n = mont.sub_mod(mont.mont_mul(lc1, r0), mont.mont_mul(lc0, r1s))
            v0n = mont.sub_mod(mont.mont_mul(lc1, v0), mont.mont_mul(lc0, v1s))
            d0n = _poly_degree(r0n)
            swap = d0n < d1
            keep = active & ~swap
            take = active & swap
            nr0 = mont.select(keep[..., None], r0n,
                              mont.select(take[..., None], r1, r0))
            nv0 = mont.select(keep[..., None], v0n,
                              mont.select(take[..., None], v1, v0))
            nd0 = torch.where(keep, d0n, torch.where(take, d1, d0))
            r1 = mont.select(take[..., None], r0n, r1)
            v1 = mont.select(take[..., None], v0n, v1)
            d1 = torch.where(take, d0n, d1)
            r0, v0, d0 = nr0, nv0, nd0

        # (g, v) = (r1, v1): the first remainder with deg < (m+k)/2
        g, v = r1, v1
        dv = _poly_degree(v)

        # long division f = g / v, remainder rr
        lcv_inv = mont.inv_mod(_gather_coeff(v, dv))
        f = zpoly
        rr = g
        dr = _poly_degree(rr)
        for _ in range(M):
            active = dr >= dv
            q = mont.mont_mul(_gather_coeff(rr, dr), lcv_inv)    # [L, ...]
            qpos = (dr - dv).clamp(min=0)
            f_n = mont.add_mod(f, _one_hot_mul(q, qpos, M))
            sub = mont.mont_mul(q[..., None], _shift_poly(v, qpos))
            rr_n = mont.sub_mod(rr, sub)
            f = mont.select(active[..., None], f_n, f)
            rr = mont.select(active[..., None], rr_n, rr)
            dr = torch.where(active, _poly_degree(rr_n), dr)

        ok = (dr < 0) & (_poly_degree(f) < k) & (dv >= 0)
        reenc = _matmul_kernel(f, vand)                        # [L, ..., m]
        return FpArray(f[..., :k]), FpArray(reenc), ok

    return kernel


def gao_decode_with_errors(enc, zs, ys: FpArray, k: int):
    """Returns (coeffs, error_mask_over_zs, ok): the shares that disagree
    with the decoded codeword are the errors."""
    f, reenc, ok = gao_robust_decode(enc, zs, ys, k)
    return f, ~reenc.eq(ys), ok
