"""Port parity: the batched NTT (ops/ntt.py) and the random refinement
(runtime/refinement.py) against the JAX reference on the CPU and Python
ints.

Shapes are the reference's own (tests/test_ntt_vandermonde.py: n = 16,
batches of 4 and 8, omega drawn with seed 0), so one persistent XLA cache
serves both. Inputs come from a numpy seed and go to both sides;
tolerance: exact equality of every limb."""

import jax.numpy as jnp
import numpy as np
import pytest

from honeybadgermpc_tpu.field import GF as RefGF
from honeybadgermpc_tpu.ops import ntt as ref_ntt
from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.polynomial import polynomials_over as ref_polys
from honeybadgermpc_tpu.runtime import refinement as ref_refine
from honeybadgermpc_tpu_torch.field import GF
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import ntt
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)
from honeybadgermpc_tpu_torch.polynomial import get_omega_int
from honeybadgermpc_tpu_torch.runtime import refinement

OMEGA16 = get_omega_int(P, 16, seed=0)
RINV = pow(R_MOD_P, P - 2, P)


def _ints(seed, rows, cols):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(cols)]
            for _ in range(rows)]


def _limbs(vals):
    """Montgomery limbs np.uint32 [L, rows, cols] of plain ints."""
    return ints_to_limbs(np.array([[v * R_MOD_P % P for v in row]
                                   for row in vals], object))


def _port(x_limbs):
    return FpArray(from_reference_limbs(x_limbs, "cpu"))


def _plain(arr: FpArray):
    return [[int(v) for v in row] for row in arr.to_ints()]


def _evals(coeffs, omega, n):
    return [[sum(c * pow(omega, i * j, P) for i, c in enumerate(row)) % P
             for j in range(n)] for row in coeffs]


def test_omega_is_the_references():
    from honeybadgermpc_tpu.polynomial import get_omega_int as ref_omega
    for n in (2, 8, 16, 256, 2 ** 14):
        assert get_omega_int(P, n, seed=0) == ref_omega(P, n, seed=0)


@pytest.mark.parametrize("fn,batch", [("ntt", 4), ("intt", 8)])
def test_ntt_and_intt_word_equal_to_the_reference(fn, batch):
    """One reference program each, at its own test's batch."""
    x = _limbs(_ints(batch, batch, 16))
    got = getattr(ntt, fn)(_port(x), OMEGA16)
    want = getattr(ref_ntt, fn)(RefFpArray(jnp.asarray(x)), OMEGA16)
    assert np.array_equal(to_reference_limbs(got.limbs),
                          np.asarray(want.limbs))
    inverse = ntt.intt if fn == "ntt" else ntt.ntt
    assert np.array_equal(to_reference_limbs(inverse(got, OMEGA16).limbs), x)


def test_ntt_vs_ints_with_extra_batch_axes():
    vals = _ints(3, 6, 16)
    x = FpArray(from_reference_limbs(_limbs(vals), "cpu").reshape(16, 2, 3,
                                                                    16))
    got = _plain(FpArray(ntt.ntt(x, OMEGA16).limbs.reshape(16, 6, 16)))
    assert got == _evals(vals, OMEGA16, 16)


def test_fft_evaluate_partial_and_interp_extrap():
    f = GF(P)
    cs = _ints(5, 1, 5)
    got = ntt.fft_evaluate(_port(_limbs(cs)), OMEGA16, 16, k=7)
    assert got.shape == (1, 7)
    assert _plain(got) == [_evals(cs, OMEGA16, 16)[0][:7]]
    full = ntt.fft_evaluate(_port(_limbs(cs)), OMEGA16, 16)
    part = ntt.partial_fft(_port(_limbs(cs)), OMEGA16, 16, 5)
    assert _plain(part) == [_plain(full)[0][:5]]
    ys = _ints(6, 1, 16)
    coeffs = ntt.fft_interpolate(_port(_limbs(ys)), OMEGA16)
    poly = ref_polys(RefGF(P))
    want = poly.interpolate_fft(ys[0], RefGF(P)(OMEGA16))
    assert _plain(coeffs)[0] == [int(c) for c in want.coeffs]
    xs = _ints(7, 1, 8)
    ext = ntt.interp_extrap(_port(_limbs(xs)), OMEGA16)
    assert _plain(ext)[0] == [int(v) for v in
                              poly.interp_extrap(xs[0], RefGF(P)(OMEGA16))]
    assert f(OMEGA16) ** 16 == 1


def test_ntt_checks_its_input():
    with pytest.raises(ValueError):
        ntt.ntt(_port(_limbs(_ints(1, 1, 12))), OMEGA16)
    with pytest.raises(ValueError):
        ntt.ntt(_port(_limbs(_ints(1, 1, 16))), OMEGA16 * OMEGA16 % P)
    with pytest.raises(ValueError):
        ntt.fft_evaluate(_port(_limbs(_ints(1, 1, 17))), OMEGA16, 16)


@pytest.mark.parametrize("n,t", [(4, 1), (16, 5)])
def test_refine_randoms_word_equal_to_the_reference(n, t):
    """The device refinement and the host one against each other and the
    reference's host refinement; the reference's device refinement (one
    jitted program) at the smaller shape."""
    vals = _ints(n, 3, n - t)
    x = _limbs(vals)
    got = refinement.refine_randoms(n, t, _port(x))
    if n == 4:
        want = ref_refine.refine_randoms(n, t, RefFpArray(jnp.asarray(x)))
        assert np.array_equal(to_reference_limbs(got.limbs),
                              np.asarray(want.limbs))
    host = [refinement.refine_randoms_host(n, t, GF(P), row) for row in vals]
    assert _plain(got) == host
    assert host == [ref_refine.refine_randoms_host(n, t, RefGF(P), row)
                    for row in vals]
    with pytest.raises(ValueError):
        refinement.refine_randoms(n, t, _port(_limbs(_ints(1, 1, n))))


def test_twiddles_are_montgomery_powers():
    tw = limbs_to_ints(ntt._twiddles_np(OMEGA16, 16))
    for s in range(4):
        m = 2 << s
        w = pow(OMEGA16, 16 // m, P)
        assert [int(v) * RINV % P for v in tw[m // 2 - 1:m - 1]] == \
            [pow(w, j, P) for j in range(m // 2)]
