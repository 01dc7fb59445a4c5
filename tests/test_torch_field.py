"""Port parity: limb helpers and Montgomery arithmetic of
honeybadgermpc_tpu_torch against the JAX reference (jnp path on the CPU)
and against Python ints. Inputs come from a numpy seed and go to both
sides; tolerance: exact equality of every limb (integer arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import limbs as ref_limbs
from honeybadgermpc_tpu.ops import montgomery as ref_mont
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import limbs as port_limbs
from honeybadgermpc_tpu_torch.ops import montgomery as port_mont
from honeybadgermpc_tpu_torch.ops.fparray import FpArray

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

P = port_limbs.P
NUM = 48


def _rand_ints(seed, count, bound=P):
    rng = np.random.default_rng(seed)
    nbytes = (bound.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % bound
            for _ in range(count)]


def _edge_and_random(seed):
    vals = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, 0xFFFF, 1 << 255 % P]
    return [v % P for v in vals] + _rand_ints(seed, NUM - len(vals))


@pytest.fixture(scope="module")
def operands():
    a = ref_limbs.ints_to_limbs(np.array(_edge_and_random(11), object))
    b = ref_limbs.ints_to_limbs(
        np.array(list(reversed(_edge_and_random(12))), object))
    return a, b


@pytest.mark.parametrize("name", ["P", "W", "L", "MASK", "R_MOD_P", "N0"])
def test_constants_match_reference(name):
    assert getattr(port_limbs, name) == getattr(ref_limbs, name)


@pytest.mark.parametrize("name", ["P_LIMBS", "R_MOD_P_LIMBS",
                                  "R2_MOD_P_LIMBS"])
def test_limb_constants_match_reference(name):
    got, want = getattr(port_limbs, name), getattr(ref_limbs, name)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_limb_helpers_roundtrip():
    vals = _edge_and_random(3)
    arr = np.array(vals, object).reshape(6, 8)
    limbs = port_limbs.ints_to_limbs(arr)
    assert np.array_equal(limbs, ref_limbs.ints_to_limbs(arr))
    assert limbs.shape == (16, 6, 8)
    assert port_limbs.limbs_to_ints(limbs).tolist() == arr.tolist()
    assert port_limbs.limbs_to_int(port_limbs.int_to_limbs(vals[9])) == vals[9]


def test_interop_limbs_roundtrip(operands):
    a, _ = operands
    t = from_reference_limbs(a, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == a.shape
    back = to_reference_limbs(t)
    assert back.dtype == np.uint32 and np.array_equal(back, a)
    with pytest.raises(ValueError):
        from_reference_limbs(a.astype(np.int64), "cpu")


@pytest.mark.parametrize("op", ["add_mod", "sub_mod", "mont_mul"])
def test_binary_ops_vs_reference_and_ints(operands, op):
    a, b = operands
    want_ref = np.asarray(jax.jit(getattr(ref_mont, op))(
        jnp.asarray(a), jnp.asarray(b)))
    got = to_reference_limbs(getattr(port_mont, op)(
        from_reference_limbs(a, "cpu"), from_reference_limbs(b, "cpu")))
    assert np.array_equal(got, want_ref)
    ai, bi = ref_limbs.limbs_to_ints(a), ref_limbs.limbs_to_ints(b)
    rinv = pow(port_limbs.R_MOD_P, P - 2, P)
    oracle = {"add_mod": lambda x, y: (x + y) % P,
              "sub_mod": lambda x, y: (x - y) % P,
              "mont_mul": lambda x, y: x * y * rinv % P}[op]
    assert port_limbs.limbs_to_ints(got).tolist() == \
        [oracle(int(x), int(y)) for x, y in zip(ai, bi)]


def test_mont_mul_broadcasts_like_reference(operands):
    """[L, k] against [L, B, k] aligns as [L, 1, k] (limb-leading rule)."""
    a, b = operands
    a2 = from_reference_limbs(a, "cpu").reshape(16, 6, 8)
    b1 = from_reference_limbs(b, "cpu")[:, :8]
    got = port_mont.mont_mul(b1, a2)
    want = port_mont.mont_mul(b1[:, None, :].expand(16, 6, 8), a2)
    assert torch.equal(got, want)


def test_to_from_mont_vs_reference_and_ints(operands):
    a, _ = operands
    mul = jax.jit(ref_mont.mont_mul)
    shape = a.shape[1:]
    r2 = np.broadcast_to(ref_limbs.R2_MOD_P_LIMBS[:, None], a.shape)
    one = np.broadcast_to(ref_limbs.int_to_limbs(1)[:, None], a.shape)
    ta = from_reference_limbs(a, "cpu")
    to_m = port_mont.to_mont(ta)
    assert np.array_equal(to_reference_limbs(to_m),
                          np.asarray(mul(jnp.asarray(a), jnp.asarray(r2))))
    back = port_mont.from_mont(to_m)
    assert np.array_equal(
        to_reference_limbs(back),
        np.asarray(mul(jnp.asarray(to_reference_limbs(to_m)),
                       jnp.asarray(one))))
    assert torch.equal(back, ta) and shape == (NUM,)
    ints = ref_limbs.limbs_to_ints(a)
    assert port_limbs.limbs_to_ints(to_reference_limbs(to_m)).tolist() == \
        [int(x) * port_limbs.R_MOD_P % P for x in ints]


def test_redc384_vs_reference_and_ints():
    ts = _rand_ints(21, 32, 1 << 384) + \
        [0, 1, P - 1, P, 1 << 256, (1 << 384) - 1]
    arr = np.zeros((24, len(ts)), np.uint32)
    for i, t in enumerate(ts):
        for j in range(24):
            arr[j, i] = (t >> (16 * j)) & 0xFFFF
    got = to_reference_limbs(port_mont.redc384(
        torch.from_numpy(arr.view(np.int32))))
    want = np.asarray(jax.jit(ref_mont.redc384)(jnp.asarray(arr)))
    assert np.array_equal(got, want)
    inv = pow(pow(2, 144, P), P - 2, P)
    assert port_limbs.limbs_to_ints(got).tolist() == \
        [t * inv % P for t in ts]


def test_fparray_arithmetic_and_shapes():
    xs, ys = _rand_ints(31, 12), _rand_ints(32, 12)
    a = FpArray.from_ints(np.array(xs, object).reshape(3, 4), device="cpu")
    b = FpArray.from_ints(np.array(ys, object).reshape(3, 4), device="cpu")
    assert a.shape == (3, 4) and a.limbs.dtype == torch.int32
    flat = lambda f: f.to_ints().reshape(-1).tolist()   # noqa: E731
    assert flat(a + b) == [(x + y) % P for x, y in zip(xs, ys)]
    assert flat(a - b) == [(x - y) % P for x, y in zip(xs, ys)]
    assert flat(a * b) == [x * y % P for x, y in zip(xs, ys)]
    assert flat(a * 3 + 1) == [(3 * x + 1) % P for x in xs]
    assert flat(5 - a) == [(5 - x) % P for x in xs]
    assert a.transpose((1, 0)).shape == (4, 3)
    assert a.transpose((1, 0)).to_ints().tolist() == \
        np.array(xs, object).reshape(3, 4).T.tolist()
    assert FpArray.concatenate([a, b], axis=1).shape == (3, 8)
    assert FpArray.stack([a, b], axis=0).shape == (2, 3, 4)
    assert a.reshape(12).to_ints().tolist() == xs
    z = FpArray.zeros((2, 2), device="cpu")
    assert z.to_ints().reshape(-1).tolist() == [0] * 4
    assert FpArray.from_int(7, (3,), device="cpu").to_ints().tolist() == [7] * 3
