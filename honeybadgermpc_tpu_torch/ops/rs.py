"""Reed-Solomon encoding over GF(p): the evaluation domain, encode and
erasure decode.

Counterpart of ``honeybadgermpc_tpu/ops/rs.py``. An ``Encoding`` wraps an
evaluation domain: the Vandermonde points i+1, or the FFT points omega^i
(``use_omega_powers``, order = next power of 2 >= n). Decode takes the
erasure SUBSET of party indices whose shares are present. The omega domain
encodes with the NTT and decodes with the FNT decode (rsdecode_impl.h's
fnt_decode_step1/step2 in HoneyBadgerMPC): step 1 is host-exact per subset
(``_fnt_step1``, cached), step 2 the batched O(n log n) device work
(``_fnt_decode_kernel``). Robust (error-correcting) decode lives in
ops/gao.py and ops/welch_berlekamp.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..polynomial import get_omega_int
from .fparray import FpArray, dev_const
from .fpmatmul import (fp_matmul, lagrange_evaluate_at,
                       vandermonde_batch_evaluate,
                       vandermonde_batch_interpolate)
from .limbs import P, R_MOD_P, ints_to_limbs
from .ntt import fft_evaluate, intt, ntt


def next_pow2(n: int) -> int:
    return n if n & (n - 1) == 0 else 1 << n.bit_length()


class Encoding:
    """Evaluation domain for n parties; use_omega_powers selects the FFT
    domain (party i -> omega^i, order = next pow2 >= n) vs Vandermonde
    (party i -> i+1)."""

    def __init__(self, n: int, use_omega_powers: bool = False):
        self.n = n
        self.use_omega_powers = use_omega_powers
        if use_omega_powers:
            self.order = next_pow2(n)
            self.omega2 = get_omega_int(P, 2 * self.order, seed=0)
            self.omega = self.omega2 * self.omega2 % P
            self.points = [pow(self.omega, i, P) for i in range(n)]
        else:
            self.order = n
            self.omega2 = None
            self.omega = None
            self.points = list(range(1, n + 1))

    def encode(self, coeffs: FpArray) -> FpArray:
        """coeffs[..., k] -> shares[..., n] (share j = poly(point_j)): the
        NTT on the omega domain, else the Vandermonde evaluation."""
        if coeffs.shape[-1] > self.n:
            raise ValueError(f"degree+1 = {coeffs.shape[-1]} exceeds "
                             f"n = {self.n}")
        if self.use_omega_powers:
            return fft_evaluate(coeffs, self.omega, self.order, k=self.n)
        return vandermonde_batch_evaluate(self.points, coeffs)

    def decode(self, zs, ys: FpArray) -> FpArray:
        """Interpolate coefficients from the shares of parties ``zs`` (a
        tuple of party indices); ys[..., len(zs)]."""
        zs = tuple(int(z) for z in zs)
        if ys.shape[-1] != len(zs):
            raise ValueError(f"{ys.shape[-1]} shares for {len(zs)} parties")
        if self.use_omega_powers:
            return self._fnt_decode(zs, ys)
        xs = tuple(self.points[z] for z in zs)
        return vandermonde_batch_interpolate(xs, ys, allow_band=False)

    def interpolate_at(self, zs, ys: FpArray, x0: int = 0) -> FpArray:
        xs = [self.points[z] for z in zs]
        return lagrange_evaluate_at(xs, ys, x0)

    def _fnt_decode(self, zs: tuple, ys: FpArray) -> FpArray:
        """fnt_decode_step1 (host, cached per subset) then step 2 on the
        device; the subset's tables enter as device constants."""
        n, omega2, dev = self.order, self.omega2, ys.device
        args = (n, omega2, zs)
        return _fnt_decode_kernel(
            self.omega, omega2, n, ys,
            FpArray(dev_const(_fnt_ai_inv, args, dev)),
            FpArray(dev_const(_scatter_matrix, (n, zs), dev)),
            FpArray(dev_const(_fnt_a_evals, args, dev)))


def _fnt_decode_kernel(omega: int, omega2: int, n: int, ys: FpArray,
                       ai_inv: FpArray, scatter: FpArray,
                       a_evals: FpArray) -> FpArray:
    """fnt_decode_step2: ys[..., k] -> the k coefficients. N'(X) has
    coefficient y_i / A_i(x_i) at position z_i; its evaluations on the
    n-domain, reversed and negated, are the coefficients of P/A, which is
    evaluated on the 2n-domain, multiplied by A there and interpolated."""
    k = ys.shape[-1]
    nis = ys * ai_inv                                  # [..., k]
    ncoeffs = fp_matmul(nis, scatter)                  # scatter [k, n] 0/1
    nevals = ntt(ncoeffs, omega)                       # N'(omega^i)
    power_a = -FpArray(nevals.limbs.flip(-1))
    pas = fft_evaluate(power_a, omega2, 2 * n)
    prec = intt(pas * a_evals, omega2)                 # [..., 2n]
    return FpArray(prec.limbs[..., :k])


def _mont_np(vals) -> np.ndarray:
    return ints_to_limbs(np.asarray([v * R_MOD_P % P for v in vals],
                                    dtype=object))


@lru_cache(maxsize=None)
def _fnt_step1(n: int, omega2: int, zs: tuple):
    """Host-exact fnt_decode_step1: A(X) = prod (X - x_i) evaluated on the
    2n omega2-domain and 1/A_i(x_i) per kept party (plain ints), and the
    points x_i = omega^z_i. Cached per (n, zs)."""
    omega = omega2 * omega2 % P
    xs = [pow(omega, z, P) for z in zs]
    a = [1]
    for x in xs:
        nxt = [0] * (len(a) + 1)
        for i, c in enumerate(a):
            nxt[i] = (nxt[i] - c * x) % P
            nxt[i + 1] = (nxt[i + 1] + c) % P
        a = nxt
    a_evals = []
    w = 1
    for _ in range(2 * n):
        acc = 0
        xp = 1
        for c in a:
            acc = (acc + c * xp) % P
            xp = xp * w % P
        a_evals.append(acc)
        w = w * omega2 % P
    ai_inv = []
    for i, xi in enumerate(xs):
        ai = 1
        for j, xj in enumerate(xs):
            if i != j:
                ai = ai * (xi - xj) % P
        ai_inv.append(pow(ai, P - 2, P))
    return a_evals, ai_inv, tuple(xs)


@lru_cache(maxsize=None)
def _fnt_a_evals(n: int, omega2: int, zs: tuple) -> np.ndarray:
    return _mont_np(_fnt_step1(n, omega2, zs)[0])


@lru_cache(maxsize=None)
def _fnt_ai_inv(n: int, omega2: int, zs: tuple) -> np.ndarray:
    return _mont_np(_fnt_step1(n, omega2, zs)[1])


@lru_cache(maxsize=None)
def _scatter_matrix(n: int, zs: tuple) -> np.ndarray:
    """0/1 matrix [k, n] placing value i at column zs[i] (Montgomery
    limbs)."""
    m = np.zeros((len(zs), n), dtype=object)
    for i, z in enumerate(zs):
        m[i, z] = R_MOD_P
    return ints_to_limbs(m)


class EncoderSelector:
    """Evaluation-domain heuristic: tiny n -> Vandermonde matmul; large n
    -> FFT domain; in between, closeness to a power of two decides."""

    @staticmethod
    def select(n: int, batch_size: int = 1) -> bool:
        """Returns use_omega_powers."""
        if n < 8:
            return False
        if n >= 128:
            return True
        order = next_pow2(n)
        return (order - n) <= n // 4

    @staticmethod
    def get(n: int, batch_size: int = 1) -> "Encoding":
        return Encoding(n, EncoderSelector.select(n, batch_size))


DecoderSelector = EncoderSelector  # same heuristic both directions


def optimistic_check(enc: Encoding, coeffs: FpArray, zs_check,
                     ys_check: FpArray):
    """Re-encode decoded coefficients and compare against additional
    shares. Returns a bool mask [..., len(zs_check)] of AGREEMENT per
    share."""
    shares = enc.encode(coeffs)
    sub = shares.take(list(zs_check), axis=shares.ndim - 1)
    return sub.eq(ys_check)
