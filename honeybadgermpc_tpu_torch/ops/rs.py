"""Reed-Solomon encoding over GF(p): the evaluation domain, encode and
erasure decode.

Counterpart of ``honeybadgermpc_tpu/ops/rs.py``. Decode takes the erasure
SUBSET of party indices whose shares are present and interpolates through
the Vandermonde points; the FNT decode of the omega domain
(``use_omega_powers=True``, the reference's ``_fnt_decode`` over
ops/ntt.py) is not ported yet and raises. Robust (error-correcting) decode
lives in ops/gao.py.
"""

from __future__ import annotations

from functools import lru_cache
from random import Random

from .fparray import FpArray
from .fpmatmul import (lagrange_evaluate_at, vandermonde_batch_evaluate,
                       vandermonde_batch_interpolate)
from .limbs import P


def next_pow2(n: int) -> int:
    return n if n & (n - 1) == 0 else 1 << n.bit_length()


@lru_cache(maxsize=None)
def get_omega_int(modulus: int, n: int, seed=0) -> int:
    """A primitive n'th root of unity (n a power of 2), deterministic for
    a given seed: the same Mersenne-Twister draw as the reference's
    ``polynomial.get_omega``, so both packages use the same FFT domain."""
    assert n & (n - 1) == 0, "n must be a power of 2"
    x = Random(seed).randint(0, modulus - 1)
    y = pow(x, (modulus - 1) // n, modulus)
    if y == 1 or pow(y, n // 2, modulus) == 1:
        return get_omega_int(modulus, n, None)
    return y


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
        """coeffs[..., k] -> shares[..., n] (share j = poly(point_j)).
        Both domains evaluate at `self.points` (the band matmul for a large
        batch, else fp_matmul); the reference evaluates the omega domain
        with an NTT, which gives the same canonical values."""
        if coeffs.shape[-1] > self.n:
            raise ValueError(f"degree+1 = {coeffs.shape[-1]} exceeds "
                             f"n = {self.n}")
        return vandermonde_batch_evaluate(self.points, coeffs)

    def decode(self, zs, ys: FpArray) -> FpArray:
        """Interpolate coefficients from the shares of parties ``zs`` (a
        tuple of party indices); ys[..., len(zs)]."""
        zs = tuple(int(z) for z in zs)
        if ys.shape[-1] != len(zs):
            raise ValueError(f"{ys.shape[-1]} shares for {len(zs)} parties")
        if self.use_omega_powers:
            raise NotImplementedError(
                "the FNT decode of the omega domain (ops/ntt.py) is not "
                "ported yet")
        xs = tuple(self.points[z] for z in zs)
        return vandermonde_batch_interpolate(xs, ys, allow_band=False)

    def interpolate_at(self, zs, ys: FpArray, x0: int = 0) -> FpArray:
        xs = [self.points[z] for z in zs]
        return lagrange_evaluate_at(xs, ys, x0)


def optimistic_check(enc: Encoding, coeffs: FpArray, zs_check,
                     ys_check: FpArray):
    """Re-encode decoded coefficients and compare against additional
    shares. Returns a bool mask [..., len(zs_check)] of AGREEMENT per
    share."""
    shares = enc.encode(coeffs)
    sub = shares.take(list(zs_check), axis=shares.ndim - 1)
    return sub.eq(ys_check)
