"""Reed-Solomon encoding over GF(p): the evaluation domain and encode.

Counterpart of ``honeybadgermpc_tpu/ops/rs.py``; decode, interpolation and
the FNT path belong to robust decoding and are not ported yet.
"""

from __future__ import annotations

from functools import lru_cache
from random import Random

from .fparray import FpArray
from .fpmatmul import vandermonde_batch_evaluate
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
        Both domains evaluate through the band matmul at `self.points`;
        the reference evaluates the omega domain with an NTT, which gives
        the same canonical values."""
        if coeffs.shape[-1] > self.n:
            raise ValueError(f"degree+1 = {coeffs.shape[-1]} exceeds "
                             f"n = {self.n}")
        return vandermonde_batch_evaluate(self.points, coeffs)
