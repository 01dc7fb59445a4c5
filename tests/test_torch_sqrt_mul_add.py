"""Port parity: the constant-structure Tonelli-Shanks square root
(ops/montgomery.py::sqrt_mod, FpArray.sqrt) and the flat packed finish
``mul_add_packed`` (ops/field_kernels.py; on a card csrc/packed_arith.cu).

sqrt_mod: the root it returns decides generate_bits' bit, so the port must
land on the reference's root, not on any root. It is held word for word
against the reference's ``FpArray.sqrt`` on the shape the reference's own
tests/test_offline.py::test_generate_bits gives it ([4, 16], one compile
for both), and against a Python-int transcription of the same algorithm
on edge values (0, 1, -1, squares and non-squares). mul_add_packed: Python
ints, edge values included, and the reference's plain Montgomery
functions on the same numpy-seeded words. Tolerance: exact."""

import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import montgomery as ref_mont
from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.ops.fused_open import pack_limbs as ref_pack
from honeybadgermpc_tpu.ops.fused_open import unpack_limbs as ref_unpack
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops import montgomery as mont
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.fused_open import pack_limbs, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)
EDGE = [0, 1, 2, P - 1, P - 2, 4, 5, (P - 1) // 2]


def _draw(rng, count):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(count)]


def _mont_limbs(vals, shape):
    """Plain ints -> np.uint32 Montgomery limbs [L, *shape]."""
    return ints_to_limbs(np.array([v * R_MOD_P % P for v in vals],
                                  object).reshape(shape))


def _plain(limbs):
    """int32 limb tensor -> plain ints (out of Montgomery form)."""
    return [int(v) * RINV % P for v in
            limbs_to_ints(limbs.numpy().view(np.uint32)).ravel()]


def _ts_int(a):
    """The reference's sqrt_mod transcribed to Python ints: (root, ok)."""
    s = 32
    q = (P - 1) >> s
    t, r, c = pow(a, q, P), pow(a, (q + 1) // 2, P), pow(5, q, P)
    for idx in range(s - 1):
        i = s - idx
        b = t
        for _ in range(i - 2):
            b = b * b % P
        c2 = c * c % P
        if b != 1:
            r, t = r * c % P, t * c2 % P
        c = c2
    return r, r * r % P == a or a == 0


def _sqrt_input():
    rng = np.random.default_rng(61)
    return _mont_limbs(EDGE + _draw(rng, 64 - len(EDGE)), (4, 16))


def _ref_sqrt():
    """The reference's FpArray.sqrt on the [4, 16] input."""
    ref_r, ref_ok = RefFpArray(_sqrt_input()).sqrt()
    return {"root": np.asarray(ref_r.limbs), "ok": np.asarray(ref_ok)}


def _check_sqrt(ref):
    r, ok = FpArray(from_reference_limbs(_sqrt_input(), "cpu")).sqrt()
    assert np.array_equal(to_reference_limbs(r.limbs), ref["root"])
    assert ok.tolist() == ref["ok"].tolist()
    assert ok.dtype == torch.bool and tuple(ok.shape) == (4, 16)


def test_sqrt_word_equal_to_the_reference():
    """Against the reference's roots (golden vectors, tests/_golden.py)."""
    _check_sqrt(golden("sqrt_4_16"))


@pytest.mark.slow
def test_sqrt_word_equal_to_the_reference_live_reference():
    _check_sqrt(_ref_sqrt())


GOLDEN = {"sqrt_4_16": _ref_sqrt}


@pytest.mark.parametrize("seed", [1, 2])
def test_sqrt_vs_python_int_tonelli_shanks(seed):
    rng = np.random.default_rng(seed)
    vals = _draw(rng, 6) + [x * x % P for x in _draw(rng, 3)] + EDGE
    r, ok = mont.sqrt_mod(from_reference_limbs(_mont_limbs(vals, (len(vals),)),
                                               "cpu"))
    roots = _plain(r)
    for v, root, o in zip(vals, roots, ok.tolist()):
        want_root, want_ok = _ts_int(v)
        assert (root, o) == (want_root, want_ok)
        assert o == (pow(v, (P - 1) // 2, P) != P - 1)
        if o:
            assert root * root % P == v


def test_fparray_square_and_pow_static():
    rng = np.random.default_rng(9)
    vals = _draw(rng, 5) + EDGE
    x = FpArray(from_reference_limbs(_mont_limbs(vals, (len(vals),)), "cpu"))
    assert _plain(x.square().limbs) == [v * v % P for v in vals]
    for e in (0, 1, 5, P - 2):
        assert _plain(x.pow_static(e).limbs) == [pow(v, e, P) for v in vals]


def _packed(vals, shape):
    """Plain ints -> int32 packed words [PL, *shape] of Montgomery form."""
    return pack_limbs(from_reference_limbs(_mont_limbs(vals, shape), "cpu"))


@pytest.mark.parametrize("B", [1, 777])
def test_mul_add_packed_vs_python_ints_and_reference(B):
    rng = np.random.default_rng(B)
    a, b, c = (_draw(rng, B) for _ in range(3))
    if B >= len(EDGE) ** 2:                        # every edge pair once
        pairs = [(x, y) for x in EDGE for y in EDGE]
        a[:len(pairs)] = [x for x, _ in pairs]
        b[:len(pairs)] = [y for _, y in pairs]
        c[:len(pairs)] = EDGE * len(EDGE)
    pa, pb, pc = (_packed(v, (B,)) for v in (a, b, c))
    got = fk.mul_add_packed(pa, pb, pc)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, B)
    assert _plain(unpack_limbs(got)) == [(x * y + z) % P
                                         for x, y, z in zip(a, b, c)]
    ref = ref_pack(ref_mont.add_mod(
        ref_mont.mont_mul(ref_unpack(to_reference_packed(pa)),
                          ref_unpack(to_reference_packed(pb))),
        ref_unpack(to_reference_packed(pc))))
    assert np.array_equal(to_reference_packed(got), np.asarray(ref))


def test_mul_add_packed_checks_its_operands():
    x = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.mul_add_packed(x, x, x[:, :3].contiguous())
    with pytest.raises(ValueError):
        fk.mul_add_packed(x, x.to(torch.int64), x)
    with pytest.raises(ValueError):
        fk.mul_add_packed(x[:, ::2], x[:, ::2], x[:, ::2])
    with pytest.raises(ValueError):
        fk.mul_add_packed(x[:7], x[:7], x[:7])
    assert not bool(fk.mul_add_packed(x, x, x).any())
