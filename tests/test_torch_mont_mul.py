"""Port parity: the elementwise Montgomery multiply (row 9 of PERF.md's
kernel table) and the field helpers of ops/montgomery.py that the robust
open adds (inv_mod, pow_const, select, eq_mask, is_zero_mask, neg_mod),
against the JAX reference on the CPU and Python ints. Inputs come from a
numpy seed and go to both sides; tolerance: exact equality of every limb.

On the CPU ``mont_mul`` takes its plain version (``_mont_mul_plain``); the
kernel it replaces on the card is held against that plain version there
(chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import montgomery as ref_mont
from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.ops.pallas_field import mont_mul_pallas as ref_mul
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops import montgomery as mont
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)


def _ints(seed, count):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(count)]


def _mont_np(vals, shape=None):
    """Python ints -> np.uint32 Montgomery limbs [L, *shape]."""
    arr = np.array([v * R_MOD_P % P for v in vals], object)
    if shape is not None:
        arr = arr.reshape(shape)
    return ints_to_limbs(arr)


def _plain(limbs_np):
    """np.uint32 Montgomery limbs -> Python ints (plain values)."""
    return [int(v) * RINV % P for v in limbs_to_ints(limbs_np).reshape(-1)]


def _mont_mul_inputs():
    edge = [0, 1, P - 1, P - 2, (P - 1) // 2, 0xFFFF, 1 << 254]
    xs = edge + _ints(1, 1500 - len(edge))
    return xs, _ints(2, 1500)


def _ref_mont_mul():
    """The reference's mont_mul_pallas (interpret mode) at its test's
    unaligned n=1500."""
    xs, ys = _mont_mul_inputs()
    return {"out": np.asarray(ref_mul(jnp.asarray(_mont_np(xs)),
                                      jnp.asarray(_mont_np(ys))))}


def _check_mont_mul(ref):
    xs, ys = _mont_mul_inputs()
    want = ref["out"]
    got = fk.mont_mul_pallas(from_reference_limbs(_mont_np(xs), "cpu"),
                             from_reference_limbs(_mont_np(ys), "cpu"))
    assert np.array_equal(to_reference_limbs(got), want)
    assert _plain(want)[:64] == [x * y % P for x, y in zip(xs, ys)][:64]


def test_mont_mul_vs_reference_pallas_kernel():
    """The reference's own Pallas kernel (interpret mode; golden vectors,
    tests/_golden.py) at its test's unaligned n=1500, against the port's
    plain version and Python ints."""
    _check_mont_mul(golden("mont_mul_1500"))


@pytest.mark.slow
def test_mont_mul_vs_reference_pallas_kernel_live_reference():
    _check_mont_mul(_ref_mont_mul())


GOLDEN = {"mont_mul_1500": _ref_mont_mul}


def test_mont_mul_broadcasts_like_the_reference():
    """[L, 5, 1] x [L, 1, 7] and [L, 7] x [L, 5, 7] (limb-leading
    alignment), through the dispatching mont_mul."""
    a = _mont_np(_ints(3, 5), (5, 1))
    b = _mont_np(_ints(4, 7), (1, 7))
    c = _mont_np(_ints(5, 35), (5, 7))
    d = _mont_np(_ints(6, 7))
    for x, y in ((a, b), (d, c)):
        want = np.asarray(jax.jit(ref_mont.mont_mul)(jnp.asarray(x),
                                                     jnp.asarray(y)))
        got = mont.mont_mul(from_reference_limbs(x, "cpu"),
                            from_reference_limbs(y, "cpu"))
        assert np.array_equal(to_reference_limbs(got), want)


def test_mont_mul_wrapper_checks_its_input():
    a = from_reference_limbs(_mont_np(_ints(7, 4)), "cpu")
    with pytest.raises(ValueError):
        fk.mont_mul_pallas(a, a[:, :3])
    with pytest.raises(ValueError):
        fk.mont_mul_pallas(a.to(torch.int64), a)


def test_inv_mod_vs_reference_and_ints():
    """Fermat inverse (inv(0) = 0) at the reference's cached 64-element
    shape."""
    xs = [1, P - 1, 0] + _ints(8, 61)
    a = _mont_np(xs)
    want = np.asarray(RefFpArray(jnp.asarray(a)).inv().limbs)
    got = mont.inv_mod(from_reference_limbs(a, "cpu"))
    assert np.array_equal(to_reference_limbs(got), want)
    assert _plain(want) == [pow(x, P - 2, P) if x else 0 for x in xs]


def test_pow_const_small_exponents():
    xs = _ints(9, 6)
    a = FpArray(from_reference_limbs(_mont_np(xs), "cpu"))
    for e in (0, 1, 3, 65537):
        got = FpArray(mont.pow_const(a.limbs, e)).to_ints().tolist()
        assert got == [pow(x, e, P) for x in xs]


def test_select_eq_zero_neg_vs_reference():
    xs = [0, 1, P - 1] + _ints(10, 13)
    ys = [0, 2, P - 1] + _ints(10, 13)[:6] + _ints(11, 7)
    a, b = _mont_np(xs, (4, 4)), _mont_np(ys, (4, 4))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = from_reference_limbs(a, "cpu"), from_reference_limbs(b, "cpu")
    eq_ref = np.asarray(jax.jit(ref_mont.eq_mask)(ja, jb))
    eq = mont.eq_mask(ta, tb)
    assert np.array_equal(eq.numpy(), eq_ref)
    assert eq.sum() == 8                  # 0, P-1 and 6 shared values
    assert np.array_equal(mont.is_zero_mask(ta).numpy(),
                          np.asarray(jax.jit(ref_mont.is_zero_mask)(ja)))
    sel_ref = np.asarray(jax.jit(ref_mont.select)(jnp.asarray(eq_ref), ja,
                                                  jb))
    sel = mont.select(eq, ta, tb)
    assert np.array_equal(to_reference_limbs(sel), sel_ref)
    neg_ref = np.asarray(jax.jit(ref_mont.neg_mod)(ja))
    assert np.array_equal(to_reference_limbs(mont.neg_mod(ta)), neg_ref)
    assert (-FpArray(ta)).to_ints().reshape(-1).tolist() == \
        [(-x) % P for x in xs]


def test_plain_calls_on_the_cpu_are_not_counted():
    """The counter of plain multiplies on CUDA tensors moves only for CUDA
    tensors (chip_smoke.py holds the card's paths to 0)."""
    before = mont.plain_calls_on_cuda
    a = from_reference_limbs(_mont_np(_ints(12, 3)), "cpu")
    mont.mont_mul(a, a)
    assert mont.plain_calls_on_cuda == before


def test_fparray_methods_of_the_robust_open():
    """take, __getitem__, at_set, broadcast_to, ones, inv, is_zero, eq and
    select on FpArray, against Python ints."""
    xs = [0, 5, P - 1] + _ints(13, 9)
    a = FpArray(from_reference_limbs(_mont_np(xs, (3, 4)), "cpu"))
    rows = a.to_ints().tolist()
    assert a.take([3, 0], axis=1).to_ints().tolist() == \
        [[r[3], r[0]] for r in rows]
    assert a[1].to_ints().tolist() == rows[1]
    assert a[:, 2].to_ints().tolist() == [r[2] for r in rows]
    b = a.at_set((2, 1), FpArray.from_int(7, device="cpu"))
    assert b.to_ints()[2][1] == 7 and a.to_ints().tolist() == rows
    assert a[0].broadcast_to((2, 4)).to_ints().tolist() == [rows[0]] * 2
    assert FpArray.ones((2,), device="cpu").to_ints().tolist() == [1, 1]
    assert a.inv().to_ints().reshape(-1).tolist() == \
        [pow(x, P - 2, P) for x in xs]
    assert a.is_zero().reshape(-1).tolist() == [x == 0 for x in xs]
    assert a.eq(b).reshape(-1).tolist() == [True] * 9 + [False] + [True] * 2
    sel = FpArray.select(a.eq(b), FpArray.zeros((3, 4), device="cpu"), a)
    assert sel.to_ints().reshape(-1).tolist() == [0] * 9 + [xs[9], 0, 0]
