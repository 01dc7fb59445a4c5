"""Modular matrix products over GF(p): Vandermonde evaluate / interpolate.

Counterpart of ``honeybadgermpc_tpu/ops/fpmatmul.py``. The Vandermonde and
Lagrange matrices depend only on the x-set, so they are computed once on
the host with exact Python ints and kept on the device per (x-set, device)
(``fparray.dev_const``).

``fp_matmul`` routes a shape to a kernel exactly as the reference routes it
on the TPU (``_route``): batches of 1024 or more with a contraction inside
the int8 headroom go to the MXU matmuls (the folded-constant kernel where
``fused2_fits``, else the fused 73-diagonal kernel where ``fused_fits``,
else the library dot and the REDC epilogue), everything else to the CIOS
matmul
``field_kernels.fp_matmul_pallas`` — where the reference's CPU and tiny-shape
branch ran its jnp scan, the port runs that kernel. Each route takes its
kernel on a CUDA tensor and its plain version on a CPU tensor.
Vandermonde evaluation at a protocol-constant x-set of a large batch takes
the host-constant band matmul (ops/band_matmul.py) instead, as in the
reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import montgomery as mont
from .band_matmul import band_fits, band_matmul_limbs
from .fparray import FpArray, _numel, dev_const
from .limbs import L, P, R_MOD_P, ints_to_limbs

_INT8_HEADROOM = 2 ** 31      # 37 k 127^2 int8 products per diagonal


def _mont_np(values) -> np.ndarray:
    """Host ints -> Montgomery-form uint32[L, *shape]."""
    arr = np.asarray(
        [[v * R_MOD_P % P for v in row] for row in values], dtype=object)
    return ints_to_limbs(arr)


def _matmul_kernel(a_limbs, m_limbs, mul=mont.mont_mul):
    """a[L, ..., k] @ m[L, k, n] -> [L, ..., n] over GF(p), Montgomery form:
    a scan over the contraction axis, acc += a[..., i] * m[i, :] (one
    `mul` and one add_mod per step). With the default multiply every step
    launches the elementwise kernel on a CUDA tensor."""
    k = a_limbs.shape[-1]
    n = m_limbs.shape[-1]
    batch_shape = tuple(a_limbs.shape[1:-1])
    acc = None
    for i in range(k):
        col = a_limbs[..., i, None]                          # [L, ..., 1]
        row = m_limbs[:, i].reshape((L,) + (1,) * len(batch_shape) + (n,))
        prod = mul(col, row)                                 # [L, ..., n]
        acc = prod if acc is None else mont.add_mod(acc, prod)
    if acc is None:
        return a_limbs.new_zeros((L,) + batch_shape + (n,))
    return acc


def _route(numel: int, k: int, n: int) -> str:
    """The kernel a shape reaches: "mxu2" (folded-constant MXU matmul),
    "mxu_fused" (the fused 73-diagonal MXU matmul), "mxu" (library dot and
    the REDC epilogue) or "cios" (the CIOS matmul). The reference's
    predicates (fpmatmul.py fp_matmul, mxu_matmul.py fp_matmul_mxu on the
    TPU), with its jnp branch for shapes under 1024 outputs taken by the
    CIOS kernel."""
    from .mxu_matmul import fused2_fits, fused_fits
    big = (numel * n >= 1024 and numel >= 1024
           and k * 37 * 127 * 127 < _INT8_HEADROOM)
    if not big:
        return "cios"
    if n >= 4 and fused2_fits(k, n):
        return "mxu2"
    return "mxu_fused" if fused_fits(k, n) else "mxu"


def fp_matmul(a: FpArray, m: FpArray) -> FpArray:
    """a[..., k] @ m[k, n] -> [..., n] over GF(p) (see ``_route``)."""
    from .field_kernels import fp_matmul_pallas
    from .mxu_matmul import (fp_matmul_mxu, fp_matmul_mxu2,
                             fp_matmul_mxu_fused)
    if m.ndim != 2 or a.shape[-1] != m.shape[0]:
        raise ValueError(f"cannot multiply {a.shape} by {m.shape}")
    batch_shape = a.shape[:-1]
    numel = _numel(batch_shape)
    k, n = m.shape
    flat = a.limbs.reshape(L, numel, k)
    route = _route(numel, k, n)
    if route == "mxu2":
        out = fp_matmul_mxu2(flat, m.limbs)
    elif route == "mxu_fused":
        out = fp_matmul_mxu_fused(flat, m.limbs)
    elif route == "cios":
        out = fp_matmul_pallas(flat, m.limbs)
    else:
        out = fp_matmul_mxu(flat, m.limbs)
    return FpArray(out.reshape((L,) + tuple(batch_shape) + (n,)))


@lru_cache(maxsize=None)
def _vandermonde_int_rows(xs: tuple, k: int):
    """Plain-int V[k][n], V[i][j] = xs[j]^i."""
    rows = []
    acc = [1] * len(xs)
    for _ in range(k):
        rows.append(list(acc))
        acc = [a * x % P for a, x in zip(acc, xs)]
    return tuple(tuple(r) for r in rows)


@lru_cache(maxsize=None)
def _vandermonde_np(xs: tuple, k: int):
    return _mont_np([list(r) for r in _vandermonde_int_rows(xs, k)])


def _band_path_ok(k: int, m: int, batch: int) -> bool:
    """Host-constant folded-band path: big batches, as on the TPU."""
    return batch >= 1024 and band_fits(k, m)


def vandermonde_matrix(xs: tuple, k: int, device) -> FpArray:
    """V[k, n] with V[i, j] = xs[j]^i (host-exact, Montgomery constants)."""
    return FpArray(dev_const(_vandermonde_np, (tuple(xs), k), device))


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
def _lagrange_matrix_np(xs: tuple):
    return _mont_np(_lagrange_int_rows(xs))


def _lam_int(xs: tuple, x0: int):
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


@lru_cache(maxsize=None)
def _decode_validate_np(points: tuple, k: int, want_coeffs: bool):
    """Fused decode + validate matrix for the optimistic open path: shares
    of the FIRST k parties are interpolated and re-evaluated at the
    remaining points[k:] in one matmul.

      want_coeffs: W[k, n]        = [Minv | lambda(points[k:])]
      else:        W[k, 1+(n-k)]  = [lambda(0) | lambda(points[k:])]
    """
    xs = tuple(points[:k])
    if want_coeffs:
        rows = _lagrange_int_rows(xs)
        cols = [[rows[j][i] for j in range(k)] for i in range(k)]
    else:
        cols = [_lam_int(xs, 0)]
    for x in points[k:]:
        cols.append(_lam_int(xs, int(x) % P))
    rows = [[col[j] for col in cols] for j in range(k)]
    return _mont_np(rows)


def decode_validate_matmul(points, k: int, ys: FpArray,
                           want_coeffs: bool) -> FpArray:
    """ys[..., k] (shares of parties 0..k-1) -> fused decode+validate
    output (see _decode_validate_np)."""
    w = FpArray(dev_const(_decode_validate_np,
                          (tuple(int(x) % P for x in points), k, want_coeffs),
                          ys.device))
    return fp_matmul(ys, w)


def lagrange_matrix(xs: tuple, device) -> FpArray:
    return FpArray(dev_const(_lagrange_matrix_np, (tuple(xs),), device))


def _band_evaluate(xs_t: tuple, coeffs: FpArray) -> FpArray:
    """Folded-constant band path, keyed by the x-set (the production hot
    path uses ONE x-set: the n party points)."""
    k = coeffs.shape[-1]
    batch = _numel(coeffs.shape[:-1])
    flat = coeffs.limbs.reshape(L, batch, k)
    out = band_matmul_limbs(flat, _vandermonde_int_rows(xs_t, k))
    return FpArray(out.reshape((L,) + coeffs.shape[:-1] + (len(xs_t),)))


def vandermonde_batch_evaluate(xs, coeffs: FpArray,
                               allow_band: bool = True) -> FpArray:
    """Evaluate polynomials (coeffs[..., k], k = degree+1) at points xs.
    A batch of 1024 or more at k <= 64, m <= 128 takes the band kernel
    (unless ``allow_band=False``, for callers whose x-set varies); the
    rest goes through fp_matmul against the Vandermonde matrix."""
    xs_t = tuple(int(x) % P for x in xs)
    k = coeffs.shape[-1]
    if allow_band and _band_path_ok(k, len(xs_t), _numel(coeffs.shape[:-1])):
        return _band_evaluate(xs_t, coeffs)
    return fp_matmul(coeffs, vandermonde_matrix(xs_t, k, coeffs.device))


def vandermonde_batch_interpolate(xs, ys: FpArray,
                                  allow_band: bool = True) -> FpArray:
    """Coefficients (degree < len(xs)) through (xs[i], ys[..., i]).
    ``allow_band=False``: see vandermonde_batch_evaluate."""
    xs_t = tuple(int(x) % P for x in xs)
    k = len(xs_t)
    if ys.shape[-1] != k:
        raise ValueError(f"{ys.shape[-1]} values for {k} points")
    if allow_band and _band_path_ok(k, k, _numel(ys.shape[:-1])):
        rows = tuple(tuple(r) for r in _lagrange_int_rows(xs_t))
        flat = ys.limbs.reshape(L, _numel(ys.shape[:-1]), k)
        out = band_matmul_limbs(flat, rows)
        return FpArray(out.reshape((L,) + ys.shape[:-1] + (k,)))
    return fp_matmul(ys, lagrange_matrix(xs_t, ys.device))


def lagrange_evaluate_at(xs, ys: FpArray, x0: int = 0) -> FpArray:
    """Evaluate the interpolant at a single point x0 via a precomputed
    Lagrange-coefficient vector (one matmul): out[...] for ys[..., k]."""
    lam = FpArray(dev_const(_lagrange_coeffs_at_np,
                            (tuple(int(x) % P for x in xs), int(x0) % P),
                            ys.device))
    return FpArray(fp_matmul(ys, lam).limbs[..., 0])


@lru_cache(maxsize=None)
def _lagrange_coeffs_at_np(xs: tuple, x0: int):
    return _mont_np([[c] for c in _lam_int(xs, x0)])
