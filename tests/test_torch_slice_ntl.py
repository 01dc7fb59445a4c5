"""Port parity for the slice as a whole, on the CPU: one sequence of calls
through the NTL-compatible API — share polynomials among 9 parties,
correct a lying party with Gao, interpolate from a subset, move to the FFT
domain and back from a subset of its points, refine the result — against
the same sequence through the JAX package's ntl, call by call, and against
the Python-int oracle. The port runs with device="cpu". Tolerance: exact
equality."""

import numpy as np

from honeybadgermpc_tpu import ntl as ref_ntl
from honeybadgermpc_tpu.runtime.refinement import \
    refine_randoms_host as ref_refine_host
from honeybadgermpc_tpu_torch import GF, FpArray, ntl
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.polynomial import get_omega_int
from honeybadgermpc_tpu_torch.runtime.refinement import refine_randoms


def _run(api, **kw):
    """The sequence; returns every intermediate result."""
    rng = np.random.default_rng(2026)
    draw = lambda: int.from_bytes(rng.bytes(40), "little") % P  # noqa: E731
    k, m = 3, 9
    polys = [[draw() for _ in range(k)] for _ in range(3)]
    xs = list(range(1, m + 1))
    shares = api.vandermonde_batch_evaluate(xs, polys, P, **kw)
    lying = list(shares[1])
    lying[4] = (lying[4] + 1) % P
    msg, err = api.gao_interpolate(xs, lying, k, P, **kw)
    sub = api.vandermonde_batch_interpolate(
        xs[:k], [row[:k] for row in shares], P, **kw)
    n = 8
    omega = get_omega_int(P, n, seed=0)
    evals = api.fft_batch_evaluate(sub, omega, P, n, n, **kw)
    zs = [0, 2, 5]
    back = api.fft_batch_interpolate(zs, [[row[z] for z in zs]
                                          for row in evals], omega, P, n,
                                     **kw)
    one = api.lagrange_interpolate(xs[2:5], shares[0][2:5], P, **kw)
    return dict(polys=polys, shares=shares, msg=msg, err=err, sub=sub,
                evals=evals, back=back, one=one)


def test_ntl_sequence_equals_the_reference():
    got = _run(ntl, device="cpu")
    want = _run(ref_ntl)
    assert got == want
    polys = got["polys"]
    assert got["msg"] == polys[1] and got["sub"] == polys
    assert [row[:3] for row in got["back"]] == polys
    assert got["one"] == polys[0]
    assert ntl.evaluate(got["err"], 5, P) == 0


def test_refinement_of_the_opened_values():
    """The refined randoms of the sequence's shares (n=9, t=2) on the
    device path equal the reference's host refinement."""
    shares = _run(ntl, device="cpu")["shares"]
    dev = refine_randoms(9, 2, FpArray.from_ints([row[:7] for row in shares],
                                                 "cpu"))
    want = [ref_refine_host(9, 2, GF(P), row[:7]) for row in shares]
    assert [[int(v) for v in row] for row in dev.to_ints()] == want
