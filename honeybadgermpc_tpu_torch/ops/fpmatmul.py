"""Batched polynomial evaluation over GF(p) at fixed point sets.

Counterpart of the Vandermonde-evaluate part of
``honeybadgermpc_tpu/ops/fpmatmul.py``: ``vandermonde_batch_evaluate`` on
the host-constant folded-band path (ops/band_matmul.py). The reference's
matmuls against runtime device matrices (``fp_matmul`` and its kernels)
are not ported yet; shapes that only they serve raise.
"""

from __future__ import annotations

from functools import lru_cache

from .band_matmul import band_fits, band_matmul_limbs
from .fparray import FpArray, _numel
from .limbs import P


@lru_cache(maxsize=None)
def _vandermonde_int_rows(xs: tuple, k: int):
    """Plain-int V[k][n], V[i][j] = xs[j]^i."""
    rows = []
    acc = [1] * len(xs)
    for _ in range(k):
        rows.append(list(acc))
        acc = [a * x % P for a, x in zip(acc, xs)]
    return tuple(tuple(r) for r in rows)


def _lagrange_int_rows(xs: tuple):
    """Host-exact int rows of W[k, k] such that coeffs = ys @ W interpolates
    through (xs, ys): W[j, i] = coefficient of X^i in the Lagrange basis
    polynomial L_j(X)."""
    k = len(xs)
    # master polynomial A(X) = prod (X - x_j)
    a = [1]
    for x in xs:
        nxt = [0] * (len(a) + 1)
        for i, c in enumerate(a):
            nxt[i] = (nxt[i] - c * x) % P
            nxt[i + 1] = (nxt[i + 1] + c) % P
        a = nxt
    rows = []
    for j, xj in enumerate(xs):
        # N_j(X) = A(X) / (X - xj) by synthetic division
        nj = [0] * k
        carry = a[k]
        for i in range(k - 1, -1, -1):
            nj[i] = carry
            carry = (a[i] + carry * xj) % P
        denom = 1
        for m_, xm in enumerate(xs):
            if m_ != j:
                denom = denom * (xj - xm) % P
        dinv = pow(denom, P - 2, P)
        rows.append([c * dinv % P for c in nj])
    return rows


def vandermonde_batch_evaluate(xs, coeffs: FpArray) -> FpArray:
    """Evaluate polynomials (coeffs[..., k], k = degree+1) at points xs:
    the band kernel on a CUDA tensor, its plain version on a CPU tensor.
    The band is keyed by the point set (the production hot path uses ONE
    x-set: the n party points)."""
    xs_t = tuple(int(x) % P for x in xs)
    k = coeffs.shape[-1]
    if not band_fits(k, len(xs_t)):
        raise NotImplementedError(
            f"evaluation with k={k}, m={len(xs_t)} is outside the band "
            "matmul (k <= 64, m <= 128); the general GF(p) matmul is not "
            "ported yet")
    batch = _numel(coeffs.shape[:-1])
    flat = coeffs.limbs.reshape(coeffs.limbs.shape[0], batch, k)
    out = band_matmul_limbs(flat, _vandermonde_int_rows(xs_t, k))
    return FpArray(out.reshape(
        tuple(out.shape[:1]) + coeffs.shape[:-1] + (len(xs_t),)))
