"""Port parity: the host math layer (field.py, polynomial.py,
elliptic_curve.py) against the JAX package's copies, which are pure
Python: the same numpy-seeded values through both, results compared as
ints. Tolerance: exact equality."""

import numpy as np
import pytest

import honeybadgermpc_tpu.elliptic_curve as ref_ec
import honeybadgermpc_tpu.field as ref_field
import honeybadgermpc_tpu.polynomial as ref_poly
import honeybadgermpc_tpu_torch as port
from honeybadgermpc_tpu_torch import elliptic_curve as ec
from honeybadgermpc_tpu_torch import field, polynomial

P = ec.Subgroup.BLS12_381


def _vals(seed, count):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(count)]


def test_package_exports_the_host_types():
    assert port.GF is field.GF and port.GFElement is field.GFElement
    assert port.Subgroup is ec.Subgroup
    assert port.FpArray.__module__ == "honeybadgermpc_tpu_torch.ops.fparray"
    assert ec.Subgroup.BLS12_381 == ref_ec.Subgroup.BLS12_381


@pytest.mark.parametrize("modulus", [P, 97, 2 ** 31 - 1])
def test_field_arithmetic_equals_the_reference(modulus):
    f, rf = field.GF(modulus), ref_field.GF(modulus)
    assert field.GF(modulus) is f
    a, b = (v % modulus for v in _vals(modulus % 1000, 2))
    b = b or 1
    for op in (lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
               lambda x, y: x / y, lambda x, y: x ** 5, lambda x, y: -x,
               lambda x, y: 3 - x, lambda x, y: ~y):
        assert int(op(f(a), f(b))) == int(op(rf(a), rf(b)))
    sq = f(a) * f(a)
    assert int(sq.sqrt()) == int(rf(int(sq)).sqrt())
    assert int(f.random(seed=7)) == int(rf.random(seed=7))
    assert f(a).signed() == rf(a).signed() and f(a).bit(3) == rf(a).bit(3)
    with pytest.raises(ZeroDivisionError):
        ~f(0)
    with pytest.raises(ValueError):
        field.GF(modulus + 1 if modulus > 2 else 4)


def test_polynomials_equal_the_reference():
    f, rf = field.GF(P), ref_field.GF(P)
    poly, rpoly = polynomial.polynomials_over(f), ref_poly.polynomials_over(rf)
    cs, ds = _vals(1, 6), _vals(2, 3)
    a, ra = poly(cs), rpoly(cs)
    b, rb = poly(ds), rpoly(ds)
    ints = lambda p: [int(c) for c in p.coeffs]  # noqa: E731
    assert ints(a * b) == ints(ra * rb) and ints(a - b) == ints(ra - rb)
    q, r = divmod(a, b)
    rq, rr = divmod(ra, rb)
    assert ints(q) == ints(rq) and ints(r) == ints(rr)
    assert int(a(12345)) == int(ra(12345))
    pts = [(x, int(a(x))) for x in range(1, 7)]
    assert ints(poly.interpolate(pts)) == ints(rpoly.interpolate(pts)) == cs
    assert int(poly.interpolate_at(pts, 0)) == cs[0]
    omega = polynomial.get_omega(f, 8, seed=0)
    assert int(omega) == int(ref_poly.get_omega(rf, 8, seed=0))
    assert [int(v) for v in a.evaluate_fft(omega, 8)] == \
        [int(v) for v in ra.evaluate_fft(rf(int(omega)), 8)]
    ys = _vals(3, 8)
    assert ints(poly.interpolate_fft(ys, omega)) == \
        ints(rpoly.interpolate_fft(ys, rf(int(omega))))
    assert [int(v) for v in poly.interp_extrap(ys[:4], omega)] == \
        [int(v) for v in rpoly.interp_extrap(ys[:4], rf(int(omega)))]
    assert ints(poly.random(4, y0=9, seed=3)) == \
        ints(rpoly.random(4, y0=9, seed=3))
    for n, fft_mode in ((4, True), (7, True), (5, False)):
        ep, rep = (polynomial.EvalPoint(f, n, fft_mode),
                   ref_poly.EvalPoint(rf, n, fft_mode))
        assert ep.xs() == rep.xs() and ep.order == rep.order
    assert polynomial.get_omega_int(P, 64) == ref_poly.get_omega_int(P, 64)


def test_jubjub_points_equal_the_reference():
    curve, rcurve = ec.Jubjub(), ref_ec.Jubjub()
    assert int(curve.d) == int(rcurve.d)
    # a point: the first y >= 2 whose x^2 from the curve equation is a
    # square
    f = curve.field
    for yv in range(2, 100):
        y = f(yv)
        x2 = (1 - y * y) / (curve.a - curve.d * y * y)
        if pow(int(x2), (P - 1) // 2, P) == 1:
            break
    x = x2.sqrt()
    pt, rpt = ec.Point(x, y, curve), ref_ec.Point(int(x), int(y), rcurve)
    for n in (0, 1, 2, 7, 12345):
        got, want = pt * n, rpt * n
        assert (int(got.x), int(got.y)) == (int(want.x), int(want.y))
    zero = pt - pt
    assert (int(zero.x), int(zero.y)) == (0, 1)
    assert ec.Ideal(curve) + pt == pt
    with pytest.raises(ValueError):
        ec.Point(1, 1, curve)
