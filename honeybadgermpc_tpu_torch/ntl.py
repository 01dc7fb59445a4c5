"""Drop-in int-level kernel API matching HoneyBadgerMPC's ``honeybadgermpc.ntl``
module (honeybadgermpc/ntl/hbmpc_ntl_helpers.pyx:73-455), so code written
against that NTL surface ports without changes.

Counterpart of ``honeybadgermpc_tpu/ntl.py``. Semantics preserved per
function (cited at each def). Differences from the NTL module, as in the
reference:
 * when ``modulus`` is the BLS12-381 scalar prime, the batch functions run
   on FpArrays on ``device`` (default ``cuda``; ``device="cpu"`` runs the
   plain versions): ``fp_matmul`` and its kernels, the NTT, the Gao
   decoder. Any other modulus takes the exact host Python fallbacks
   (``_lagrange_coeffs_host``, ``_fft_host``, ``_gao_host``), which also
   serve as Python-int oracles;
 * ``vandermonde_inverse`` returns the matrix as a list of row lists of ints;
 * thread controls are accepted and ignored.

Scalar helpers (``evaluate``, ``sqrt_mod``) and ``vandermonde_inverse``
stay on the host: a single 255-bit operation is cheaper in Python ints than
a device round trip.
"""

from __future__ import annotations

import torch

from .ops.fparray import FpArray
from .ops.limbs import P as _BLS_P

_CUDA = torch.device("cuda")

__all__ = [
    "lagrange_interpolate", "evaluate", "vandermonde_inverse",
    "vandermonde_batch_interpolate", "vandermonde_batch_evaluate",
    "fft", "partial_fft", "fft_batch_evaluate", "fft_interpolate",
    "fft_batch_interpolate", "gao_interpolate", "sqrt_mod",
    "SetNumThreads", "SetNTLNumThreads", "AvailableNTLThreads",
    "GetMaxThreads", "InterpolationError",
]


class InterpolationError(Exception):
    """reed_solomon/pyx vandermonde_batch_interpolate error class."""


def _on_device(modulus: int) -> bool:
    return int(modulus) == _BLS_P


def _rows_in(rows, modulus, device) -> FpArray:
    return FpArray.from_ints([[int(v) % modulus for v in row]
                              for row in rows], device)


def _rows_out(arr: FpArray):
    return [[int(v) for v in row] for row in arr.to_ints()]


def _check_distinct(x, modulus):
    """Duplicate evaluation points make the Vandermonde matrix singular —
    the reference raises InterpolationError there
    (hbmpc_ntl_helpers.pyx:169); without this check both the device and
    host paths would silently return garbage (0^(p-2) == 0)."""
    xr = [int(v) % modulus for v in x]
    if len(set(xr)) != len(xr):
        raise InterpolationError(
            f"duplicate evaluation points (mod p): {len(xr) - len(set(xr))}"
            " repeats")


# -- host-exact fallbacks (arbitrary modulus) ---------------------------------

def _lagrange_coeffs_host(x, y, p):
    k = len(x)
    # A(X) = prod (X - x_j)
    a = [1]
    for xi in x:
        nxt = [0] * (len(a) + 1)
        for i, c in enumerate(a):
            nxt[i] = (nxt[i] - c * xi) % p
            nxt[i + 1] = (nxt[i + 1] + c) % p
        a = nxt
    out = [0] * k
    for j, xj in enumerate(x):
        # N_j = A / (X - xj) by synthetic division; denom = N_j(xj)
        nj = [0] * k
        carry = a[k]
        for i in range(k - 1, -1, -1):
            nj[i] = carry
            carry = (a[i] + carry * xj) % p
        denom = 0
        xp = 1
        for c in nj:
            denom = (denom + c * xp) % p
            xp = xp * xj % p
        w = y[j] * pow(denom, p - 2, p) % p
        for i in range(k):
            out[i] = (out[i] + nj[i] * w) % p
    return out


def _fft_host(coeffs, omega, p, n):
    if n == 1:
        return [coeffs[0] % p if coeffs else 0]
    evens = _fft_host(coeffs[::2], omega * omega % p, p, n // 2)
    odds = _fft_host(coeffs[1::2], omega * omega % p, p, n // 2)
    out = [0] * n
    w = 1
    for i in range(n // 2):
        t = w * odds[i] % p
        out[i] = (evens[i] + t) % p
        out[i + n // 2] = (evens[i] - t) % p
        w = w * omega % p
    return out


# -- API ----------------------------------------------------------------------

def lagrange_interpolate(x, y, modulus, device=_CUDA):
    """Coefficients of P with P(x[i]) = y[i] (pyx:73-99)."""
    assert len(x) == len(y)
    modulus = int(modulus)
    _check_distinct(x, modulus)
    if _on_device(modulus):
        from .ops.fpmatmul import vandermonde_batch_interpolate as vbi
        return _rows_out(vbi(list(x), _rows_in([y], modulus, device)))[0]
    return _lagrange_coeffs_host([int(v) % modulus for v in x],
                                 [int(v) % modulus for v in y], modulus)


def evaluate(polynomial, x, modulus):
    """Evaluate coefficient list at x — Horner (pyx:101-113)."""
    p = int(modulus)
    acc = 0
    for c in reversed(polynomial):
        acc = (acc * x + c) % p
    return acc


def vandermonde_inverse(x, modulus):
    """Inverse of the Vandermonde matrix V[i][j] = x[j]^i as row lists
    (pyx:115-136; see module docstring for the repr difference)."""
    modulus = int(modulus)
    _check_distinct(x, modulus)
    if _on_device(modulus):
        from .ops.fpmatmul import _lagrange_int_rows
        # row j = coefficients of the Lagrange basis poly L_j; since
        # sum_j L_j(X) x_j^i = X^i, this matrix IS V^{-1} for V[i][j]=x_j^i
        return [list(r) for r in _lagrange_int_rows(
            tuple(int(v) % modulus for v in x))]
    k = len(x)
    rows = []
    for j in range(k):
        y = [0] * k
        y[j] = 1
        rows.append(_lagrange_coeffs_host(
            [int(v) % modulus for v in x], y, modulus))
    return rows


def vandermonde_batch_interpolate(x, data_list, modulus, device=_CUDA):
    """Interpolate many polynomials through (x[i], data[i]) (pyx:139-197)."""
    modulus = int(modulus)
    _check_distinct(x, modulus)
    if not data_list:
        return []
    if _on_device(modulus):
        from .ops.fpmatmul import vandermonde_batch_interpolate as vbi
        return _rows_out(vbi(list(x), _rows_in(data_list, modulus, device)))
    return [_lagrange_coeffs_host([int(v) % modulus for v in x],
                                  [int(v) % modulus for v in row], modulus)
            for row in data_list]


def vandermonde_batch_evaluate(x, polynomials, modulus, device=_CUDA):
    """Evaluate many coefficient lists at points x (pyx:199-244)."""
    modulus = int(modulus)
    if not polynomials:
        return []
    width = max(len(q) for q in polynomials)
    padded = [list(q) + [0] * (width - len(q)) for q in polynomials]
    if _on_device(modulus):
        from .ops.fpmatmul import vandermonde_batch_evaluate as vbe
        return _rows_out(vbe(list(x), _rows_in(padded, modulus, device)))
    return [[evaluate(q, int(xi) % modulus, modulus) for xi in x]
            for q in padded]


def fft(coeffs, omega, modulus, n, device=_CUDA):
    """n-point NTT of the coefficient list (pyx:246-264)."""
    return partial_fft(coeffs, omega, modulus, n, n, device)


def partial_fft(coeffs, omega, modulus, n, k, device=_CUDA):
    """First k outputs of the n-point NTT (pyx:266-284)."""
    out = fft_batch_evaluate([coeffs], omega, modulus, n, k, device)
    return out[0]


def fft_batch_evaluate(coeffs, omega, modulus, n, k, device=_CUDA):
    """Batch n-point NTT, first k outputs each (pyx:286-316)."""
    modulus = int(modulus)
    if not coeffs:
        return []
    padded = [(list(q) + [0] * (n - len(q)))[:n] for q in coeffs]
    if _on_device(modulus):
        from .ops.ntt import fft_evaluate
        out = fft_evaluate(_rows_in(padded, modulus, device),
                           int(omega) % modulus, n, k=k)
        return _rows_out(out)
    return [_fft_host(row, int(omega) % modulus, modulus, n)[:k]
            for row in padded]


def fft_interpolate(zs, ys, omega, modulus, n, device=_CUDA):
    """Coefficients of the degree<k polynomial through (omega^zs[i], ys[i])
    (pyx:318-340, fnt_decode_step1+2)."""
    return fft_batch_interpolate(zs, [ys], omega, modulus, n, device)[0]


def fft_batch_interpolate(zs, ys_list, omega, modulus, n, device=_CUDA):
    """Batch FNT decode (pyx:342-381)."""
    modulus = int(modulus)
    omega = int(omega) % modulus
    xs = [pow(omega, int(z), modulus) for z in zs]
    _check_distinct(xs, modulus)
    if _on_device(modulus):
        from .ops.fpmatmul import vandermonde_batch_interpolate as vbi
        return _rows_out(vbi(xs, _rows_in(ys_list, modulus, device)))
    return [_lagrange_coeffs_host(xs, [int(v) % modulus for v in row],
                                  modulus)
            for row in ys_list]


def gao_interpolate(x, y, k, modulus, z=None, omega=None, order=None,
                    use_omega_powers=False, device=_CUDA):
    """Gao RS decode: message coefficients + error-locator polynomial, or
    (None, None) on failure (pyx:389-439). ``None`` entries in y are
    erasures and are dropped, like the reference. The error polynomial is
    prod (X - x_i) over identified error positions (monic; the reference
    returns the EEA's divisor remainder, equal up to a scalar)."""
    assert len(x) == len(y)
    modulus = int(modulus)
    keep = [i for i, yi in enumerate(y) if yi is not None]
    x = [int(x[i]) % modulus for i in keep]
    y = [int(y[i]) % modulus for i in keep]
    if _on_device(modulus):
        from .ops.gao import gao_decode_points
        coeffs, reenc, ok = gao_decode_points(x, FpArray.from_ints([y], device),
                                              k)
        if not bool(ok.reshape(-1)[0]):
            return None, None
        msg = _rows_out(coeffs)[0]
        got = _rows_out(reenc)[0]
        err_pos = [xi for xi, a, b in zip(x, got, y) if a != b]
    else:
        # host fallback: try all erasure-free subsets is exponential; do the
        # textbook EEA instead
        msg, err_pos = _gao_host(x, y, k, modulus)
        if msg is None:
            return None, None
    err_poly = [1]
    for xi in err_pos:
        nxt = [0] * (len(err_poly) + 1)
        for i, c in enumerate(err_poly):
            nxt[i] = (nxt[i] - c * xi) % modulus
            nxt[i + 1] = (nxt[i + 1] + c) % modulus
        err_poly = nxt
    return msg, err_poly


def _gao_host(x, y, k, p):
    """Textbook Gao decode with Python ints (any modulus)."""
    m = len(x)

    def pmul(a, b):
        out = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
        return out

    def pmod_deg(a):
        while len(a) > 1 and a[-1] == 0:
            a.pop()
        return a

    def pdivmod(a, b):
        a = list(a)
        q = [0] * max(1, len(a) - len(b) + 1)
        inv = pow(b[-1], p - 2, p)
        for i in range(len(a) - len(b), -1, -1):
            c = a[i + len(b) - 1] * inv % p
            q[i] = c
            for j, bj in enumerate(b):
                a[i + j] = (a[i + j] - c * bj) % p
        return pmod_deg(q), pmod_deg(a)

    def psub(a, b):
        out = [((a[i] if i < len(a) else 0) -
                (b[i] if i < len(b) else 0)) % p
               for i in range(max(len(a), len(b)))]
        return pmod_deg(out)

    g0 = [1]
    for xi in x:
        g0 = pmul(g0, [(-xi) % p, 1])
    g1 = _lagrange_coeffs_host(x, y, p) or [0]
    g1 = pmod_deg(list(g1))
    r0, r1 = g0, g1
    v0, v1 = [0], [1]
    stop = (m + k) // 2
    while len(r1) - 1 >= stop and any(r1):
        q, r = pdivmod(r0, r1)
        r0, r1 = r1, r
        v0, v1 = v1, psub(v0, pmul(q, v1))
    f, rr = pdivmod(r1, v1)
    if any(rr) or len(f) - 1 >= k:
        return None, []
    f = (f + [0] * k)[:k]
    err = [xi for xi, yi in zip(x, y)
           if evaluate(f, xi, p) != yi]
    return f, err


def sqrt_mod(a, n):
    """Modular square root (pyx:441-444; NTL SqrRootMod). Tonelli-Shanks."""
    a = int(a) % int(n)
    p = int(n)
    if a == 0:
        return 0
    assert pow(a, (p - 1) // 2, p) == 1, "not a quadratic residue"
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


# -- thread controls (pyx:383-386, 446-455): no-ops ---------------------------

def SetNumThreads(n):
    return None


def SetNTLNumThreads(n):
    return None


def AvailableNTLThreads():
    return 1


def GetMaxThreads():
    return 1
