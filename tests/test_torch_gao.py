"""Port parity: the Gao robust decoder (ops/gao.py) against the JAX
reference on the CPU, word for word (coeffs, re-encoded codeword, ok), at
the reference's own test shapes (tests/test_gao.py), and at the open
path's n=64, k=22 with 21 errors against a Python-int oracle only (no live
reference compile at m=64). Inputs come from a numpy seed and go to both
sides; tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
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


def _both(n, k, limbs, zs):
    enc, ref_enc = Encoding(n), RefEncoding(n)
    got = gao_robust_decode(enc, zs, FpArray(from_reference_limbs(limbs,
                                                                   "cpu")), k)
    want = ref_gao(ref_enc, zs, RefFpArray(jnp.asarray(limbs)), k)
    return got, want


def _assert_word_equal(got, want):
    (c, r, ok), (rc, rr, rok) = got, want
    assert np.array_equal(to_reference_limbs(c.limbs), np.asarray(rc.limbs))
    assert np.array_equal(to_reference_limbs(r.limbs), np.asarray(rr.limbs))
    assert np.array_equal(ok.numpy(), np.asarray(rok))


def test_gao_corrects_t_errors_like_the_reference():
    """n=7, k=3: t=2 errors in each of three instances."""
    n, k, batch = 7, 3, 3
    bad = [[1, 4], [0, 6], [2, 3]]
    coeffs, limbs = _codewords(12, n, k, batch, bad)
    got, want = _both(n, k, limbs, tuple(range(n)))
    _assert_word_equal(got, want)
    f, reenc, ok = got
    assert ok.all()
    assert FpArray(f.limbs).to_ints().tolist() == coeffs
    err = ~reenc.eq(FpArray(from_reference_limbs(limbs, "cpu")))
    assert [sorted(np.flatnonzero(e).tolist()) for e in err.numpy()] == \
        [sorted(b) for b in bad]


def test_gao_partial_subset_like_the_reference():
    """m = k + 2e = 7 shares of n = 10 parties, two of them wrong."""
    n, k = 10, 3
    zs = (0, 2, 3, 5, 7, 8, 9)
    coeffs, limbs = _codewords(20, n, k, 2, [[1, 4], []], zs=zs)
    got, want = _both(n, k, limbs, zs)
    _assert_word_equal(got, want)
    assert got[2].all()
    assert FpArray(got[0].limbs).to_ints().tolist() == coeffs


def test_gao_too_many_errors_like_the_reference():
    """4 > (7-3)//2 errors: the outputs are still the reference's words,
    and the decode does not return the original polynomial with at most
    2 errors."""
    n, k = 7, 3
    coeffs, limbs = _codewords(30, n, k, 1, [[0, 1, 2, 3]])
    got, want = _both(n, k, limbs, tuple(range(n)))
    _assert_word_equal(got, want)
    f, reenc, ok = got
    err = ~reenc.eq(FpArray(from_reference_limbs(limbs, "cpu")))
    if bool(ok[0]):
        assert FpArray(f.limbs).to_ints()[0].tolist() != coeffs[0] \
            or int(err.sum()) > 2


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
