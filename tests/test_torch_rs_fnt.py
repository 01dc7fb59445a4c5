"""Port parity: Reed-Solomon on the omega domain (ops/rs.py) — the NTT
encode, the FNT decode (fnt_decode_step1 on the host, step 2 on tensors)
and the encoder selector — against the JAX reference on the CPU and Python
ints.

The party subsets are the reference's own (tests/test_rs.py): n = 7 with
(0, 1, 2), (1, 3, 6), (4, 2, 5), and n = 16 with (15, 0, 7, 3, 9, 12).
The reference's FNT decode is one jitted program per shape; it runs live
at one subset (the others differ only in host tables, which are compared
for every subset). Inputs come from a numpy seed; tolerance: exact
equality of every limb."""

import jax.numpy as jnp
import numpy as np
import pytest

from honeybadgermpc_tpu.ops import rs as ref_rs
from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import rs
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P, R_MOD_P, ints_to_limbs

SUBSETS = [(7, (0, 1, 2)), (7, (1, 3, 6)), (7, (4, 2, 5)),
           (16, (15, 0, 7, 3, 9, 12))]


def _coeffs(seed, batch, k):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]
            for _ in range(batch)]


def _limbs(vals):
    return ints_to_limbs(np.array([[v * R_MOD_P % P for v in row]
                                   for row in vals], object))


def _plain(arr):
    return [[int(v) for v in row] for row in arr.to_ints()]


def _poly(coeffs, x):
    return sum(c * pow(x, i, P) for i, c in enumerate(coeffs)) % P


@pytest.mark.parametrize("n,zs", SUBSETS)
def test_fnt_decode_recovers_the_coefficients(n, zs):
    enc = rs.Encoding(n, use_omega_powers=True)
    k = len(zs)
    coeffs = _coeffs(n + sum(zs), 4, k)
    shares = enc.encode(FpArray(from_reference_limbs(_limbs(coeffs), "cpu")))
    assert _plain(shares) == [[_poly(c, x) for x in enc.points]
                              for c in coeffs]
    got = enc.decode(zs, shares.take(list(zs), axis=1))
    assert _plain(got) == coeffs


@pytest.mark.parametrize("n,zs", SUBSETS)
def test_fnt_step1_tables_equal_the_reference(n, zs):
    enc, ref_enc = rs.Encoding(n, True), ref_rs.Encoding(n, True)
    assert (enc.order, enc.omega, enc.omega2, enc.points) == \
        (ref_enc.order, ref_enc.omega, ref_enc.omega2, ref_enc.points)
    a_evals, ai_inv, xs = ref_rs._fnt_step1(enc.order, enc.omega2, zs)
    assert np.array_equal(rs._fnt_a_evals(enc.order, enc.omega2, zs),
                          a_evals)
    assert np.array_equal(rs._fnt_ai_inv(enc.order, enc.omega2, zs), ai_inv)
    assert rs._fnt_step1(enc.order, enc.omega2, zs)[2] == xs
    assert np.array_equal(rs._scatter_matrix(enc.order, zs),
                          ref_rs._scatter_matrix(enc.order, zs))


def test_encode_and_fnt_decode_word_equal_to_the_reference():
    """The reference's NTT encode and its jitted FNT decode at n = 7,
    subset (1, 3, 6), word for word."""
    n, zs = 7, (1, 3, 6)
    x = _limbs(_coeffs(11, 4, 3))
    enc, ref_enc = rs.Encoding(n, True), ref_rs.Encoding(n, True)
    shares = enc.encode(FpArray(from_reference_limbs(x, "cpu")))
    ref_shares = ref_enc.encode(RefFpArray(jnp.asarray(x)))
    assert np.array_equal(to_reference_limbs(shares.limbs),
                          np.asarray(ref_shares.limbs))
    got = enc.decode(zs, shares.take(list(zs), axis=1))
    want = ref_enc.decode(zs, ref_shares.take(list(zs), axis=1))
    assert np.array_equal(to_reference_limbs(got.limbs),
                          np.asarray(want.limbs))


def test_selectors_choose_as_the_reference():
    for n in range(1, 300):
        assert rs.EncoderSelector.select(n) == ref_rs.EncoderSelector.select(n)
        assert rs.DecoderSelector.get(n).use_omega_powers == \
            ref_rs.DecoderSelector.get(n).use_omega_powers


def test_decode_checks_its_input():
    enc = rs.Encoding(7, True)
    ys = FpArray(from_reference_limbs(_limbs(_coeffs(2, 1, 3)), "cpu"))
    with pytest.raises(ValueError):
        enc.decode((0, 1), ys)
    with pytest.raises(ValueError):
        enc.encode(FpArray(from_reference_limbs(_limbs(_coeffs(2, 1, 8)),
                                                "cpu")))
