"""Batched radix-2 NTT over GF(p): evaluation and interpolation on the
powers of a root of unity.

Counterpart of ``honeybadgermpc_tpu/ops/ntt.py`` (the reference's
replacement for NTL's FFT core). The transform axis is the LAST axis;
leading axes are the batch. Each of the log2(n) stages is a butterfly on
whole tensors: one Montgomery multiply of the odd halves by the stage's
twiddles (``montgomery.mont_mul``, the row-9 kernel on a CUDA tensor), a
modular add and a modular subtract. The twiddle tables (all stages in one
[L, n-1] table, stage s at columns 2^s - 1 .. 2^(s+1) - 2) and the
bit-reversal permutation are built on the host with exact Python ints and
kept on the device per (omega, n, device) (``fparray.dev_const``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import montgomery as mont
from .fparray import FpArray, dev_const
from .limbs import L, P, R_MOD_P, int_to_limbs


@lru_cache(maxsize=None)
def _bitrev_np(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    perm = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
            for i in range(n)]
    return np.asarray(perm, dtype=np.uint32)


@lru_cache(maxsize=None)
def _twiddles_np(omega: int, n: int) -> np.ndarray:
    """Montgomery limbs [L, n - 1]: stage s (m = 2^(s+1)) needs
    omega^(j * n/m) for j < m/2, at columns m/2 - 1 + j."""
    tw = np.empty((L, max(n - 1, 0)), dtype=np.uint32)
    for s in range(n.bit_length() - 1):
        m = 2 << s
        w = pow(omega, n // m, P)
        acc = 1
        for j in range(m // 2):
            tw[:, m // 2 - 1 + j] = int_to_limbs(acc * R_MOD_P % P)
            acc = acc * w % P
    return tw


def _ntt_limbs(limbs, omega: int):
    """limbs[L, ..., n] -> natural-order DIT NTT over the last axis."""
    n = limbs.shape[-1]
    dev = limbs.device
    tw = dev_const(_twiddles_np, (omega, n), dev)
    perm = dev_const(_bitrev_np, (n,), dev).long()
    x = limbs.index_select(limbs.dim() - 1, perm)
    nb = x.dim() - 2                    # batch axes between limbs and n
    for s in range(n.bit_length() - 1):
        m = 2 << s
        half = m // 2
        v = x.reshape(x.shape[:-1] + (n // m, m))
        lo, hi = v[..., :half], v[..., half:]
        twb = tw[:, half - 1:m - 1].reshape((L,) + (1,) * (nb + 1) + (half,))
        t = mont.mont_mul(twb, hi)
        x = torch.cat([mont.add_mod(lo, t), mont.sub_mod(lo, t)],
                      dim=-1).reshape(x.shape)
    return x


def ntt(x: FpArray, omega: int) -> FpArray:
    """Evaluate polynomials (coefficients on the last axis, length n a
    power of 2) at omega^0 .. omega^(n-1)."""
    n = x.shape[-1]
    if n & (n - 1) or n < 2:
        raise ValueError(f"transform length {n} is not a power of 2 >= 2")
    if pow(omega, n, P) != 1 or pow(omega, n // 2, P) == 1:
        raise ValueError(f"omega is not a primitive {n}-th root of unity")
    return FpArray(_ntt_limbs(x.limbs, omega % P))


@lru_cache(maxsize=None)
def _n_inv_np(n: int) -> np.ndarray:
    return int_to_limbs(pow(n, P - 2, P) * R_MOD_P % P)


def intt(y: FpArray, omega: int) -> FpArray:
    """Inverse transform: coefficients of the unique degree < n polynomial
    with p(omega^i) = y[..., i]."""
    n = y.shape[-1]
    coeffs = ntt(y, pow(omega, P - 2, P))
    n_inv = dev_const(_n_inv_np, (n,), y.device).reshape(
        (L,) + (1,) * y.ndim)
    return FpArray(mont.mont_mul(coeffs.limbs, n_inv))


def fft_evaluate(coeffs: FpArray, omega: int, n: int,
                 k: int | None = None) -> FpArray:
    """Pad coeffs (last axis) to n, NTT, keep the first k outputs (all
    when k is None)."""
    pad = n - coeffs.shape[-1]
    if pad < 0:
        raise ValueError(f"{coeffs.shape[-1]} coefficients exceed n = {n}")
    if pad:
        zeros = FpArray.zeros(coeffs.shape[:-1] + (pad,), coeffs.device)
        coeffs = FpArray.concatenate([coeffs, zeros], axis=coeffs.ndim - 1)
    out = ntt(coeffs, omega)
    if k is not None and k < n:
        out = FpArray(out.limbs[..., :k])
    return out


def partial_fft(coeffs: FpArray, omega: int, n: int, k: int) -> FpArray:
    """First k outputs of the n-point NTT."""
    return fft_evaluate(coeffs, omega, n, k=k)


def fft_interpolate(ys: FpArray, omega: int) -> FpArray:
    """Coefficients through (omega^i, ys[..., i])."""
    return intt(ys, omega)


def interp_extrap(xs: FpArray, omega: int) -> FpArray:
    """Interpolate on the even powers of omega, evaluate at all 2n powers
    (xs: last axis n)."""
    n = xs.shape[-1]
    coeffs = intt(xs, pow(omega, 2, P))
    return fft_evaluate(coeffs, omega, 2 * n)
