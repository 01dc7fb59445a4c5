"""Port parity: Berlekamp-Welch robust decoding (ops/welch_berlekamp.py)
against the JAX reference on the CPU and Python ints: the host linear
algebra on the same points (numpy-seeded messages, wrong shares at chosen
parties), and wb_robust_decode's FpArrays word for word. Tolerance: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest

from honeybadgermpc_tpu.ops import welch_berlekamp as ref_wb
from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.ops.rs import Encoding as RefEncoding
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import welch_berlekamp as wb
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P, R_MOD_P, ints_to_limbs
from honeybadgermpc_tpu_torch.ops.rs import Encoding


def _draw(rng):
    return int.from_bytes(rng.bytes(40), "little") % P


def _codeword(seed, n, k, bad):
    rng = np.random.default_rng(seed)
    coeffs = [_draw(rng) for _ in range(k)]
    xs = list(range(1, n + 1))
    ys = [wb._horner(coeffs, x) for x in xs]
    for pos in bad:
        ys[pos] = (ys[pos] + 1 + _draw(rng) % 997) % P
    return coeffs, xs, ys


@pytest.mark.parametrize("n,k,bad", [
    (7, 3, ()), (7, 3, (1, 5)), (10, 4, (0, 9, 4)), (7, 3, (0, 2, 4)),
    (4, 4, ()), (4, 4, (2,)),
])
def test_wb_decode_equals_the_reference(n, k, bad):
    """Within (n-k)//2 errors the message comes back; beyond, both give
    None (or the same wrong-but-consistent answer)."""
    coeffs, xs, ys = _codeword(n * 10 + len(bad), n, k, bad)
    got = wb.wb_decode(xs, ys, k)
    assert got == ref_wb.wb_decode(xs, ys, k)
    if len(bad) <= (n - k) // 2:
        assert got == coeffs
    solve = [[1, 2, 3], [4, 5, 6 % P]]
    assert wb._rref_solve(solve, 2) == ref_wb._rref_solve(solve, 2)


def test_wb_robust_decode_word_equal_to_the_reference():
    n, k = 7, 3
    rows, want_coeffs = [], []
    for b, bad in enumerate(((), (1, 5), (0, 2, 4), (6,))):
        coeffs, _, ys = _codeword(100 + b, n, k, bad)
        rows.append([y * R_MOD_P % P for y in ys])
        want_coeffs.append(coeffs)
    limbs = ints_to_limbs(np.array(rows, object))
    zs = list(range(n))
    c, r, ok = wb.wb_robust_decode(Encoding(n), zs, FpArray(
        from_reference_limbs(limbs, "cpu")), k)
    rc, rr, rok = ref_wb.wb_robust_decode(RefEncoding(n), zs,
                                          RefFpArray(jnp.asarray(limbs)), k)
    assert c.device.type == "cpu" and r.device.type == "cpu"
    assert np.array_equal(to_reference_limbs(c.limbs), np.asarray(rc.limbs))
    assert np.array_equal(to_reference_limbs(r.limbs), np.asarray(rr.limbs))
    assert ok.tolist() == list(np.asarray(rok)) == [True, True, False, True]
    got = [[int(v) for v in row] for row in c.to_ints()]
    assert [got[i] for i in (0, 1, 3)] == [want_coeffs[i] for i in (0, 1, 3)]


def test_make_wb_encoder_decoder_like_the_reference():
    enc, dec, _ = wb.make_wb_encoder_decoder(7, 3, P)
    ref_enc, ref_dec, _ = ref_wb.make_wb_encoder_decoder(7, 3, P)
    coeffs, _, _ = _codeword(5, 7, 3, ())
    word = enc(coeffs)
    assert word == ref_enc(coeffs)
    word[2] = (word[2] + 9) % P
    word[4] = None
    assert dec(word) == ref_dec(word) == coeffs
