"""Port parity: the Gao robust decoder (ops/gao.py) against the JAX
reference on the CPU, word for word (coeffs, re-encoded codeword, ok), at
the reference's own test shapes (tests/test_gao.py), and at the open
path's n=64, k=22 with 21 errors against a Python-int oracle only (no live
reference compile at m=64). Inputs come from a numpy seed and go to both
sides; the reference's outputs are committed golden vectors
(tests/_golden.py), each test has a slow twin that runs the reference
live. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.ops.gao import gao_robust_decode as ref_gao
from honeybadgermpc_tpu.ops.rs import Encoding as RefEncoding
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.gao import (gao_decode_with_errors,
                                              gao_robust_decode)
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)
from honeybadgermpc_tpu_torch.ops.rs import Encoding

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def _codewords(seed, n, k, batch, bad, zs=None):
    """Random degree<k polynomials, their shares at points 1..n (or the
    subset zs), with the shares of bad[b] replaced by other values.
    Returns (coeff ints [batch][k], share limbs np.uint32 [L, batch, m])."""
    rng = np.random.default_rng(seed)
    draw = lambda: int.from_bytes(rng.bytes(40), "little") % P  # noqa: E731
    zs = list(range(n)) if zs is None else list(zs)
    coeffs = [[draw() for _ in range(k)] for _ in range(batch)]
    shares = []
    for b in range(batch):
        row = [sum(c * pow(z + 1, i, P) for i, c in enumerate(coeffs[b])) % P
               for z in zs]
        for pos in bad[b]:
            row[pos] = (row[pos] + 1 + draw() % 1000) % P
        shares.append([v * R_MOD_P % P for v in row])
    return coeffs, ints_to_limbs(np.array(shares, object))


# (n, k, seed, batch, bad shares, subset zs or None) of each case
CASES = {
    "gao_t_errors": (7, 3, 12, 3, [[1, 4], [0, 6], [2, 3]], None),
    "gao_partial_subset": (10, 3, 20, 2, [[1, 4], []],
                           (0, 2, 3, 5, 7, 8, 9)),
    "gao_too_many_errors": (7, 3, 30, 1, [[0, 1, 2, 3]], None),
}


def _case(name):
    """(n, k, coeffs, limbs, zs) of a case."""
    n, k, seed, batch, bad, zs = CASES[name]
    coeffs, limbs = _codewords(seed, n, k, batch, bad, zs=zs)
    return n, k, coeffs, limbs, tuple(range(n)) if zs is None else zs


def _ref_case(name):
    """The reference's gao_robust_decode of a case's words."""
    n, k, _, limbs, zs = _case(name)
    rc, rr, rok = ref_gao(RefEncoding(n), zs, RefFpArray(jnp.asarray(limbs)),
                          k)
    return {"coeffs": np.asarray(rc.limbs), "reenc": np.asarray(rr.limbs),
            "ok": np.asarray(rok)}


def _port_case(name, ref):
    """The port's decode of a case, word for word equal to `ref`."""
    n, k, coeffs, limbs, zs = _case(name)
    c, r, ok = gao_robust_decode(Encoding(n), zs, FpArray(
        from_reference_limbs(limbs, "cpu")), k)
    assert np.array_equal(to_reference_limbs(c.limbs), ref["coeffs"])
    assert np.array_equal(to_reference_limbs(r.limbs), ref["reenc"])
    assert np.array_equal(ok.numpy(), ref["ok"])
    return coeffs, limbs, (c, r, ok)


def _check_t_errors(ref):
    """n=7, k=3: t=2 errors in each of three instances."""
    coeffs, limbs, (f, reenc, ok) = _port_case("gao_t_errors", ref)
    assert ok.all()
    assert FpArray(f.limbs).to_ints().tolist() == coeffs
    err = ~reenc.eq(FpArray(from_reference_limbs(limbs, "cpu")))
    assert [sorted(np.flatnonzero(e).tolist()) for e in err.numpy()] == \
        [sorted(b) for b in CASES["gao_t_errors"][4]]


def _check_partial_subset(ref):
    """m = k + 2e = 7 shares of n = 10 parties, two of them wrong."""
    coeffs, _, (f, _, ok) = _port_case("gao_partial_subset", ref)
    assert ok.all()
    assert FpArray(f.limbs).to_ints().tolist() == coeffs


def _check_too_many_errors(ref):
    """4 > (7-3)//2 errors: the outputs are still the reference's words,
    and the decode does not return the original polynomial with at most
    2 errors."""
    coeffs, limbs, (f, reenc, ok) = _port_case("gao_too_many_errors", ref)
    err = ~reenc.eq(FpArray(from_reference_limbs(limbs, "cpu")))
    if bool(ok[0]):
        assert FpArray(f.limbs).to_ints()[0].tolist() != coeffs[0] \
            or int(err.sum()) > 2


def test_gao_corrects_t_errors_like_the_reference():
    _check_t_errors(golden("gao_t_errors"))


def test_gao_partial_subset_like_the_reference():
    _check_partial_subset(golden("gao_partial_subset"))


def test_gao_too_many_errors_like_the_reference():
    _check_too_many_errors(golden("gao_too_many_errors"))


@pytest.mark.slow
def test_gao_corrects_t_errors_like_the_reference_live_reference():
    _check_t_errors(_ref_case("gao_t_errors"))


@pytest.mark.slow
def test_gao_partial_subset_like_the_reference_live_reference():
    _check_partial_subset(_ref_case("gao_partial_subset"))


@pytest.mark.slow
def test_gao_too_many_errors_like_the_reference_live_reference():
    _check_too_many_errors(_ref_case("gao_too_many_errors"))


GOLDEN = {name: (lambda name=name: _ref_case(name)) for name in CASES}


def test_gao_n64_k22_corrects_21_errors():
    """The open path's shape: 21 wrong shares of 64, against Python ints:
    the decoded coefficients and the error positions."""
    n, k = 64, 22
    bad = [list(range(0, 42, 2)), list(range(43, 64))]
    coeffs, limbs = _codewords(40, n, k, 2, bad)
    ys = FpArray(from_reference_limbs(limbs, "cpu"))
    f, err, ok = gao_decode_with_errors(Encoding(n), tuple(range(n)), ys, k)
    assert ok.tolist() == [True, True]
    assert FpArray(f.limbs).to_ints().tolist() == coeffs
    assert [np.flatnonzero(e).tolist() for e in err.numpy()] == bad
    honest = limbs_to_ints(limbs)
    for b in range(2):
        for z in range(n):
            want = sum(c * pow(z + 1, i, P) for i, c in
                       enumerate(coeffs[b])) % P * R_MOD_P % P
            assert (int(honest[b][z]) == want) == (z not in bad[b])


def test_fnt_decode_is_not_ported():
    """(Name kept from the slices before the FNT decode was ported.) Both
    domains now decode: zeros give zeros, and the omega domain's decode of
    its own encode returns the coefficients."""
    enc = Encoding(8, use_omega_powers=True)
    assert torch.equal(enc.decode(
        tuple(range(8)), FpArray.zeros((1, 8), device="cpu")).limbs,
        torch.zeros((16, 1, 8), dtype=torch.int32))
    coeffs = FpArray.from_ints([[3, 1, 4, 1, 5, 9, 2, 6]], device="cpu")
    assert enc.decode(tuple(range(8)), enc.encode(coeffs)).to_ints() \
        .tolist() == [[3, 1, 4, 1, 5, 9, 2, 6]]
    assert torch.equal(Encoding(8).decode(
        tuple(range(8)), FpArray.zeros((1, 8), device="cpu")).limbs,
        torch.zeros((16, 1, 8), dtype=torch.int32))
