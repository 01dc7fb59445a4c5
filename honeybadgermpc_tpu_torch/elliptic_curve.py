"""Curve constants and host-side Jubjub affine arithmetic.

Counterpart of ``honeybadgermpc_tpu/elliptic_curve.py``, copied (pure
Python).

Mirrors the reference's honeybadgermpc/elliptic_curve.py (Subgroup constant
:4-5, twisted Edwards Jubjub :8-48, affine Point :51-145, Ideal :148). The
host classes are the plaintext oracle for the shared-point MPC programs in
the reference's :mod:`honeybadgermpc_tpu.models.jubjub`; the device path uses
FpArray batches.
"""

from __future__ import annotations

from .field import GF, GFElement


class Subgroup:
    BLS12_381 = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


class Jubjub:
    """Twisted Edwards curve a*x^2 + y^2 = 1 + d*x^2*y^2 over GF(BLS12_381),
    a = -1, d = -(10240/10241)."""

    def __init__(self, field=None):
        self.field = field or GF(Subgroup.BLS12_381)
        self.a = self.field(-1)
        self.d = -self.field(10240) / self.field(10241)
        self.disc = 16 * int(self.a * self.d * (self.a - self.d) ** 4)
        if not self.is_smooth():
            raise ValueError(f"The curve {self} is not smooth!")

    def is_smooth(self):
        return self.disc % self.field.modulus != 0

    def test_point(self, x, y):
        return self.a * x * x + y * y == 1 + self.d * x * x * y * y

    def __repr__(self):
        return f"Jubjub({int(self.a)}, {int(self.d)})"

    def __eq__(self, other):
        return isinstance(other, Jubjub) and (self.a, self.d) == (other.a, other.d)


class Point:
    """Affine point on a twisted Edwards curve (complete addition law)."""

    def __init__(self, x, y, curve=None):
        self.curve = curve or Jubjub()
        f = self.curve.field
        self.x = x if isinstance(x, GFElement) else f(x)
        self.y = y if isinstance(y, GFElement) else f(y)
        if not self.curve.test_point(self.x, self.y):
            raise ValueError(f"({self.x}, {self.y}) is not on {self.curve}")

    def __add__(self, other):
        if isinstance(other, Ideal):
            return self
        x1, y1, x2, y2 = self.x, self.y, other.x, other.y
        a, d = self.curve.a, self.curve.d
        x3 = (x1 * y2 + y1 * x2) / (1 + d * x1 * x2 * y1 * y2)
        y3 = (y1 * y2 - a * x1 * x2) / (1 - d * x1 * x2 * y1 * y2)
        return Point(x3, y3, self.curve)

    def double(self):
        return self + self

    def __neg__(self):
        return Point(-self.x, self.y, self.curve)

    def __sub__(self, other):
        return self + (-other)

    def __mul__(self, n: int):
        if n < 0:
            return -self * -n
        if n == 0:
            return Ideal(self.curve)
        q = self
        r = self if n & 1 else Ideal(self.curve)
        i = 2
        while i <= n:
            q = q.double()
            if n & i:
                r = q + r
            i <<= 1
        return r

    __rmul__ = __mul__

    def __eq__(self, other):
        if isinstance(other, Ideal):
            return False
        return (self.x, self.y) == (other.x, other.y)

    def __repr__(self):
        return f"({int(self.x)}, {int(self.y)})"


class Ideal(Point):
    """Identity element (0, 1) treated as the point at infinity marker."""

    def __init__(self, curve=None):
        self.curve = curve or Jubjub()
        self.x = self.curve.field(0)
        self.y = self.curve.field(1)

    def __add__(self, other):
        return other

    def __neg__(self):
        return self

    def __mul__(self, n: int):
        return self

    __rmul__ = __mul__

    def double(self):
        return self

    def __eq__(self, other):
        return isinstance(other, Ideal)

    def __repr__(self):
        return "Ideal"
