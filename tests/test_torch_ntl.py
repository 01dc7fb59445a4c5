"""Port parity: every function of the NTL-compatible API (ntl.py) against
the JAX package's ntl on the CPU, on the inputs of the reference's own
tests (tests/test_ntl_api.py: the same seeded draws, so the reference's
programs are the ones its tests compile), and against Python ints. The
port runs with device="cpu" (plain versions). Tolerance: exact
equality."""

import random

import pytest

from honeybadgermpc_tpu import ntl as ref_ntl
from honeybadgermpc_tpu_torch import ntl
from honeybadgermpc_tpu_torch.elliptic_curve import Subgroup
from honeybadgermpc_tpu_torch.polynomial import get_omega_int

P = Subgroup.BLS12_381
CPU = "cpu"


@pytest.fixture
def rng():
    return random.Random(31337)


def _poly_eval(coeffs, x, p=P):
    return sum(c * pow(x, i, p) for i, c in enumerate(coeffs)) % p


def test_all_names_are_ported():
    assert ntl.__all__ == ref_ntl.__all__
    for name in ntl.__all__:
        assert hasattr(ntl, name), name


def test_lagrange_interpolate_and_evaluate(rng):
    coeffs = [rng.randrange(P) for _ in range(5)]
    xs = list(range(1, 6))
    ys = [_poly_eval(coeffs, x) for x in xs]
    got = ntl.lagrange_interpolate(xs, ys, P, device=CPU)
    assert got == ref_ntl.lagrange_interpolate(xs, ys, P) == coeffs
    assert ntl.evaluate(coeffs, 7, P) == ref_ntl.evaluate(coeffs, 7, P)
    with pytest.raises(ntl.InterpolationError):
        ntl.lagrange_interpolate([1, 2, 1 + P], ys[:3], P, device=CPU)


def test_vandermonde_batch_and_inverse(rng):
    polys = [[rng.randrange(P) for _ in range(4)] for _ in range(3)]
    xs = list(range(1, 5))
    evals = ntl.vandermonde_batch_evaluate(xs, polys, P, device=CPU)
    assert evals == ref_ntl.vandermonde_batch_evaluate(xs, polys, P)
    assert evals == [[_poly_eval(q, x) for x in xs] for q in polys]
    back = ntl.vandermonde_batch_interpolate(xs, evals, P, device=CPU)
    assert back == ref_ntl.vandermonde_batch_interpolate(xs, evals, P) \
        == polys
    assert ntl.vandermonde_batch_evaluate(xs, [], P, device=CPU) == []
    assert ntl.vandermonde_inverse(xs, P) == ref_ntl.vandermonde_inverse(
        xs, P)
    assert ntl.vandermonde_inverse(xs, 97) == ref_ntl.vandermonde_inverse(
        xs, 97)


def test_fft_partial_fft_and_batch(rng):
    n = 8
    omega = get_omega_int(P, n, seed=0)
    coeffs = [rng.randrange(P) for _ in range(n)]
    out = ntl.fft(coeffs, omega, P, n, device=CPU)
    assert out == ref_ntl.fft(coeffs, omega, P, n)
    assert out == [_poly_eval(coeffs, pow(omega, i, P)) for i in range(n)]
    assert ntl.partial_fft(coeffs, omega, P, n, 3, device=CPU) == out[:3]
    batch = ntl.fft_batch_evaluate([coeffs, coeffs], omega, P, n, n,
                                   device=CPU)
    assert batch == ref_ntl.fft_batch_evaluate([coeffs, coeffs], omega, P,
                                               n, n) == [out, out]
    assert ntl._fft_host(coeffs, omega, P, n) == out


def test_fft_interpolate_and_batch(rng):
    n = 8
    omega = get_omega_int(P, n, seed=0)
    coeffs = [rng.randrange(P) for _ in range(3)]
    zs = [0, 2, 5]
    ys = [_poly_eval(coeffs, pow(omega, z, P)) for z in zs]
    got = ntl.fft_interpolate(zs, ys, omega, P, n, device=CPU)
    assert got == ref_ntl.fft_interpolate(zs, ys, omega, P, n)
    assert got[:3] == coeffs and not any(got[3:])
    gotb = ntl.fft_batch_interpolate(zs, [ys, ys], omega, P, n, device=CPU)
    assert gotb == ref_ntl.fft_batch_interpolate(zs, [ys, ys], omega, P, n)


def test_gao_interpolate_with_errors_and_erasures(rng):
    k, m = 3, 9
    coeffs = [rng.randrange(P) for _ in range(k)]
    xs = list(range(1, m + 1))
    ys = [_poly_eval(coeffs, x) for x in xs]
    ys[1] = (ys[1] + 17) % P
    ys[6] = (ys[6] + 1) % P
    got = ntl.gao_interpolate(xs, ys, k, P, device=CPU)
    assert got == ref_ntl.gao_interpolate(xs, ys, k, P)
    assert got[0][:k] == coeffs
    assert ntl._gao_host(xs, ys, k, P) == (coeffs, [xs[1], xs[6]])
    ys2 = list(ys)
    for i in (0, 2, 3):
        ys2[i] = (ys2[i] + 5) % P
    assert ntl.gao_interpolate(xs, ys2, k, P, device=CPU) == (None, None) \
        == ref_ntl.gao_interpolate(xs, ys2, k, P)


def test_host_fallbacks_for_other_moduli(rng):
    p = 97
    xs = list(range(1, 7))
    ys = [(5 + 11 * x) % p for x in xs]
    ys[2] = (ys[2] + 1) % p
    assert ntl.gao_interpolate(xs, ys, 2, p) == \
        ref_ntl.gao_interpolate(xs, ys, 2, p)
    p = 2 ** 31 - 1
    coeffs = [3, 1, 4]
    pts = [1, 2, 3]
    vals = [_poly_eval(coeffs, x, p) for x in pts]
    assert ntl.lagrange_interpolate(pts, vals, p) == coeffs
    assert ntl.vandermonde_batch_evaluate(pts, [coeffs], p) == [vals]
    assert ntl.vandermonde_batch_interpolate(pts, [vals], p) == [coeffs]
    assert ntl.fft_batch_evaluate([[1, 2]], 1, p, 1, 1) == \
        ref_ntl.fft_batch_evaluate([[1, 2]], 1, p, 1, 1)


def test_sqrt_mod_and_thread_controls(rng):
    for _ in range(4):
        v = rng.randrange(1, P)
        sq = v * v % P
        assert ntl.sqrt_mod(sq, P) == ref_ntl.sqrt_mod(sq, P)
    assert ntl.sqrt_mod(4, 7) == ref_ntl.sqrt_mod(4, 7)
    ntl.SetNumThreads(4)
    ntl.SetNTLNumThreads(4)
    assert ntl.AvailableNTLThreads() == ntl.GetMaxThreads() == 1
