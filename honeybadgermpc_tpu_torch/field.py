"""Host-side GF(p) scalar field — the control-plane / oracle twin of the
device-side :class:`~honeybadgermpc_tpu_torch.ops.fparray.FpArray`.

Counterpart of ``honeybadgermpc_tpu/field.py``, copied (it is pure Python;
the port imports nothing of the JAX package).

API-compatible with the reference's ``honeybadgermpc/field.py`` (GF multiton
:41, GFElement algebra :68, seeded ``random`` :64) so programs written against
the reference's scalar API keep working, and so tests have a bit-exact oracle.
Pure Python ints (no gmpy2): primality via deterministic Miller-Rabin.
"""

from __future__ import annotations

from random import Random


class FieldsNotIdentical(Exception):
    pass


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (and strong-probable-prime
    beyond; fine for modulus validation)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


class FieldElement:
    def __int__(self):
        return self.value

    __long__ = __int__


class GF:
    """Multiton: one field object per modulus (reference field.py:41-65)."""

    _field_cache: dict = {}

    def __new__(cls, modulus):
        return GF._field_cache.setdefault(modulus, super().__new__(cls))

    def __init__(self, modulus):
        if not _is_prime(modulus):
            raise ValueError(f"{modulus} is not a prime")
        self.modulus = modulus

    def __call__(self, value):
        return GFElement(value, self)

    def __reduce__(self):
        return (GF, (self.modulus,))

    def random(self, seed=None):
        # Exact parity with reference field.py:64-65 (Mersenne-Twister draw);
        # get_omega(seed=0) reproducibility depends on this.
        return GFElement(Random(seed).randint(0, self.modulus - 1), self)


class GFElement(FieldElement):
    def __init__(self, value, gf):
        self.modulus = gf.modulus
        self.field = gf
        self.value = value % self.modulus

    def __add__(self, other):
        if isinstance(other, int):
            return GFElement(self.value + other, self.field)
        if isinstance(other, GFElement):
            if self.field is not other.field:
                raise FieldsNotIdentical
            return GFElement(self.value + other.value, self.field)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, int):
            return GFElement(self.value - other, self.field)
        if isinstance(other, GFElement):
            if self.field is not other.field:
                raise FieldsNotIdentical
            return GFElement(self.value - other.value, self.field)
        return NotImplemented

    def __rsub__(self, other):
        if isinstance(other, int):
            return GFElement(other - self.value, self.field)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, int):
            return GFElement(self.value * other, self.field)
        if isinstance(other, GFElement):
            if self.field is not other.field:
                raise FieldsNotIdentical
            return GFElement(self.value * other.value, self.field)
        return NotImplemented

    __rmul__ = __mul__

    def __pow__(self, exponent):
        return GFElement(pow(self.value, exponent, self.modulus), self.field)

    def __truediv__(self, other):
        if isinstance(other, int):
            other = GFElement(other, self.field)
        return self * ~other

    def __rtruediv__(self, other):
        return ~self * other

    def __invert__(self):
        if self.value == 0:
            raise ZeroDivisionError
        return GFElement(pow(self.value, self.modulus - 2, self.modulus), self.field)

    def __neg__(self):
        return GFElement(-self.value, self.field)

    def sqrt(self):
        """A square root (or raises if none). Uses Tonelli-Shanks."""
        a, p = self.value, self.modulus
        if a == 0:
            return GFElement(0, self.field)
        if pow(a, (p - 1) // 2, p) != 1:
            raise ValueError(f"{a} has no square root mod {p}")
        if p % 4 == 3:
            return GFElement(pow(a, (p + 1) // 4, p), self.field)
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return GFElement(r, self.field)

    def bit(self, index):
        return (self.value >> index) & 1

    def signed(self):
        if self.value > (self.modulus - 1) // 2:
            return self.value - self.modulus
        return self.value

    def unsigned(self):
        return self.value

    def __repr__(self):
        return f"{{{self.value}}}"

    def __eq__(self, other):
        if isinstance(other, GFElement):
            return self.value == other.value and self.field is other.field
        if isinstance(other, int):
            return self.value == other % self.modulus
        return NotImplemented

    def __hash__(self):
        return hash((self.value, self.modulus))


def fake_gf(modulus):
    """No-op benchmark stub field (reference field.py:292-365): all
    arithmetic returns inputs unchanged so communication cost can be
    isolated from field math in benchmarks."""

    class FakeField:
        def __init__(self, m):
            self.modulus = m

        def __call__(self, value):
            return FakeFieldElement(int(value), self)

        def random(self, seed=None):
            return FakeFieldElement(Random(seed).randint(0, self.modulus - 1),
                                    self)

    class FakeFieldElement(FieldElement):
        def __init__(self, value, field):
            self.value = int(value)
            self.field = field
            self.modulus = field.modulus

        def _same(self, other):
            return self

        __add__ = __radd__ = __sub__ = __rsub__ = _same
        __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _same

        def __pow__(self, e):
            return self

        def __invert__(self):
            return self

        def __neg__(self):
            return self

        def __eq__(self, other):
            return isinstance(other, FakeFieldElement) and                 self.value == other.value

        def __hash__(self):
            return hash(("fake", self.value))

    return FakeField(modulus)
