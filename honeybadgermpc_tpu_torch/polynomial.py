"""Host-side polynomial algebra over GF(p) — the oracle / control-plane twin
of the device functions in :mod:`honeybadgermpc_tpu_torch.ops`.

Counterpart of ``honeybadgermpc_tpu/polynomial.py``, copied (pure Python).

API mirrors the reference's honeybadgermpc/polynomial.py: the
``polynomials_over`` class factory (:26), Horner evaluation (:56), Lagrange
interpolation (:68-108), FFT eval/interpolate (:111-140), ``get_omega``
(:253) and ``EvalPoint`` (:385). Pure Python ints — device-side batched
equivalents live in ops/ntt.py, ops/fpmatmul.py and ops/rs.py.
"""

from __future__ import annotations

import random
from functools import lru_cache

from .field import GF, GFElement

_poly_cache = {}


def polynomials_over(field):
    if field in _poly_cache:
        return _poly_cache[field]

    class Polynomial:
        _field = field

        def __init__(self, coeffs):
            self.coeffs = [self.coerce(c) for c in coeffs]
            self.field = self._field

        @staticmethod
        def coerce(c):
            if isinstance(c, GFElement):
                return c
            return field(int(c))

        def isZero(self):
            return self.coeffs == [] or all(int(c) == 0 for c in self.coeffs)

        def __len__(self):
            return len(self.coeffs)

        def degree(self):
            if self.isZero():
                return 0
            d = len(self.coeffs) - 1
            while d > 0 and int(self.coeffs[d]) == 0:
                d -= 1
            return d

        def __call__(self, x):
            """Horner evaluation (reference polynomial.py:56-62)."""
            y = field(0)
            xx = self.coerce(x)
            for c in reversed(self.coeffs):
                y = y * xx + c
            return y

        # -- ring ops -------------------------------------------------------
        def __add__(self, other):
            n = max(len(self.coeffs), len(other.coeffs))
            a = self.coeffs + [field(0)] * (n - len(self.coeffs))
            b = other.coeffs + [field(0)] * (n - len(other.coeffs))
            return Polynomial([x + y for x, y in zip(a, b)])

        def __sub__(self, other):
            n = max(len(self.coeffs), len(other.coeffs))
            a = self.coeffs + [field(0)] * (n - len(self.coeffs))
            b = other.coeffs + [field(0)] * (n - len(other.coeffs))
            return Polynomial([x - y for x, y in zip(a, b)])

        def __neg__(self):
            return Polynomial([-c for c in self.coeffs])

        def __mul__(self, other):
            if isinstance(other, (GFElement, int)):
                o = self.coerce(other)
                return Polynomial([c * o for c in self.coeffs])
            if self.isZero() or other.isZero():
                return Polynomial([])
            out = [field(0)] * (len(self.coeffs) + len(other.coeffs) - 1)
            for i, a in enumerate(self.coeffs):
                for j, b in enumerate(other.coeffs):
                    out[i + j] = out[i + j] + a * b
            return Polynomial(out)

        __rmul__ = __mul__

        def __divmod__(self, divisor):
            """Long division (reference polynomial.py:219-234)."""
            if divisor.isZero():
                raise ZeroDivisionError
            q = [field(0)] * max(1, len(self.coeffs) - len(divisor.coeffs) + 1)
            r = list(self.coeffs)
            dd = divisor.degree()
            dlc_inv = ~divisor.coeffs[dd]
            while len(r) - 1 >= dd and not all(int(c) == 0 for c in r):
                d = len(r) - 1
                if int(r[d]) == 0:
                    r.pop()
                    continue
                coef = r[d] * dlc_inv
                q[d - dd] = coef
                for i in range(dd + 1):
                    r[d - dd + i] = r[d - dd + i] - coef * divisor.coeffs[i]
                r.pop()
            return Polynomial(q), Polynomial(r)

        def __floordiv__(self, divisor):
            return divmod(self, divisor)[0]

        def __mod__(self, divisor):
            return divmod(self, divisor)[1]

        def __eq__(self, other):
            a = [int(c) for c in self.coeffs]
            b = [int(c) for c in other.coeffs]
            while a and a[-1] == 0:
                a.pop()
            while b and b[-1] == 0:
                b.pop()
            return a == b

        def __repr__(self):
            return f"Poly({[int(c) for c in self.coeffs]})"

        # -- construction ---------------------------------------------------
        @classmethod
        def random(cls, degree, y0=None, seed=None):
            rng = random.Random(seed)
            coeffs = [field(rng.randrange(field.modulus))
                      for _ in range(degree + 1)]
            if y0 is not None:
                coeffs[0] = cls.coerce(y0)
            return cls(coeffs)

        @classmethod
        def zero(cls):
            return cls([])

        # -- interpolation --------------------------------------------------
        @classmethod
        def interpolate(cls, shares):
            """O(n^2) Lagrange through (x, y) pairs."""
            xs = [cls.coerce(x) for x, _ in shares]
            ys = [cls.coerce(y) for _, y in shares]
            k = len(xs)
            out = cls([])
            for i in range(k):
                num = cls([field(1)])
                den = field(1)
                for j in range(k):
                    if i == j:
                        continue
                    num = num * cls([-xs[j], field(1)])
                    den = den * (xs[i] - xs[j])
                out = out + num * (ys[i] / den)
            return out

        @classmethod
        def interpolate_at(cls, shares, x_recomb=0):
            """Lagrange evaluated at one point without building the poly."""
            x_recomb = field(x_recomb)
            xs = [cls.coerce(x) for x, _ in shares]
            ys = [cls.coerce(y) for _, y in shares]
            total = field(0)
            for i in range(len(xs)):
                num, den = field(1), field(1)
                for j in range(len(xs)):
                    if i == j:
                        continue
                    num = num * (x_recomb - xs[j])
                    den = den * (xs[i] - xs[j])
                total = total + ys[i] * num / den
            return total

        # -- FFT path -------------------------------------------------------
        def evaluate_fft(self, omega, n):
            return fft(self, omega, n)

        @classmethod
        def interpolate_fft(cls, ys, omega):
            """Poly of degree < n through (omega^i, ys[i])."""
            n = len(ys)
            assert n & (n - 1) == 0
            ys = [cls.coerce(y) for y in ys]
            inv_n = ~field(n)
            p = cls(ys)
            evals = fft(p, ~cls.coerce(omega), n)
            return cls([e * inv_n for e in evals])

        @classmethod
        def interp_extrap(cls, xs, omega):
            """Interpolate on even powers of omega, evaluate at all powers
            (reference polynomial.py:142-158)."""
            n = len(xs)
            assert n & (n - 1) == 0
            poly = cls.interpolate_fft(xs, omega * omega)
            return fft(poly, omega, 2 * n)

    _poly_cache[field] = Polynomial
    return Polynomial


def get_omega(field, n, seed=None):
    """n'th root of unity; deterministic for a given seed (reference
    polynomial.py:253-268 — exact draw-sequence parity via GF.random)."""
    assert n & (n - 1) == 0, "n must be a power of 2"
    x = field.random(seed)
    y = pow(x, (field.modulus - 1) // n)
    if y == 1 or pow(y, n // 2) == 1:
        return get_omega(field, n)
    assert pow(y, n) == 1, "omega must be 2n'th root of unity"
    assert pow(y, n // 2) != 1, "omega must be primitive 2n'th root of unity"
    return y


@lru_cache(maxsize=None)
def get_omega_int(modulus: int, n: int, seed=0) -> int:
    """Cached plain-int omega for device twiddle precomputation."""
    return int(get_omega(GF(modulus), n, seed=seed))


def fft_helper(a, omega, field):
    """Recursive radix-2 reference FFT (oracle only)."""
    n = len(a)
    assert not (n & (n - 1))
    if n == 1:
        return a
    b, c = a[0::2], a[1::2]
    b_bar = fft_helper(b, pow(omega, 2), field)
    c_bar = fft_helper(c, pow(omega, 2), field)
    a_bar = [field(1)] * n
    for j in range(n):
        k = j % (n // 2)
        a_bar[j] = b_bar[k] + pow(omega, j) * c_bar[k]
    return a_bar


def fft(poly, omega, n):
    assert n & (n - 1) == 0, "n must be a power of 2"
    assert len(poly.coeffs) <= n
    omega = poly.coerce(omega)
    assert int(pow(omega, n)) == 1
    assert int(pow(omega, n // 2)) != 1
    padded = poly.coeffs + [poly.field(0)] * (n - len(poly.coeffs))
    return fft_helper(padded, omega, poly.field)


class EvalPoint:
    """Evaluation-domain abstraction (reference polynomial.py:385-423).

    FFT mode: party i ↦ omega^i with order = next pow2 >= n, omega drawn
    with seed 0 so all parties agree. Vandermonde mode: party i ↦ i + 1.
    """

    def __init__(self, field, n, use_omega_powers=False):
        self.use_omega_powers = use_omega_powers
        self.field = field
        self.n = n
        order = n
        if use_omega_powers:
            self.order = (
                order if (order & (order - 1) == 0) else 2 ** order.bit_length()
            )
            self.omega2 = field(get_omega_int(field.modulus, 2 * self.order, seed=0))
            self.omega = self.omega2 * self.omega2
        else:
            self.order = order
            self.omega2 = None
            self.omega = None

    def __call__(self, i):
        if self.use_omega_powers:
            return self.field(pow(int(self.omega2), 2 * i, self.field.modulus))
        return self.field(i + 1)

    def zero(self):
        return self.field(0)

    def xs(self):
        """All n evaluation points as plain ints."""
        return [int(self(i)) for i in range(self.n)]
