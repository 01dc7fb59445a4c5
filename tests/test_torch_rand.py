"""Port parity: the field sampler. The port's plain `rand_limbs` must be
bit-identical to the reference's Pallas sampler kernel (interpret mode on
the CPU) for the same key data; tolerance: exact equality of every limb."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.pallas_field import rand_limbs_pallas
from honeybadgermpc_tpu_torch.interop import to_reference_limbs
from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P, limbs_to_ints

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

KEY = (0x1234ABCD, 0x9E3779B9)
NUMEL = 5000          # not a multiple of the reference kernel's 4096 tile


@pytest.fixture(scope="module")
def port_draw():
    return to_reference_limbs(fk.rand_limbs(KEY, NUMEL, device="cpu"))


def test_rand_limbs_bit_exact_vs_pallas_interpret(port_draw):
    want = np.asarray(jax.device_get(
        rand_limbs_pallas(jnp.asarray(KEY, jnp.uint32), NUMEL)))
    assert port_draw.shape == want.shape == (16, NUMEL)
    assert np.array_equal(port_draw, want)


def test_threefry_int_and_tensor_agree_with_jax():
    from jax._src.prng import threefry_2x32
    c0 = np.arange(64, dtype=np.uint32)
    c1 = c0 + np.uint32(7)
    ref = np.asarray(threefry_2x32(
        jnp.asarray(KEY, jnp.uint32),
        jnp.concatenate([jnp.asarray(c0), jnp.asarray(c1)])))
    x0, x1 = fk._threefry2x32(
        KEY[0], KEY[1], torch.from_numpy(c0.astype(np.int64)),
        torch.from_numpy(c1.astype(np.int64)))
    got = np.concatenate([x0.numpy(), x1.numpy()]).astype(np.uint32)
    assert np.array_equal(got, ref)
    for i in (0, 5, 63):
        assert fk._threefry2x32(KEY[0], KEY[1], int(c0[i]), int(c1[i])) == \
            (int(ref[i]), int(ref[64 + i]))


def test_rand_limbs_is_redc_of_the_draw(port_draw):
    """Element e = (384-bit Threefry draw at counters (s, e)) * 2^-144."""
    inv = pow(pow(2, 144, P), P - 2, P)
    vals = limbs_to_ints(port_draw)
    for e in (0, 1, 4095, 4096, NUMEL - 1):
        t = 0
        for s in range(6):
            w0, w1 = fk._threefry2x32(KEY[0], KEY[1], s, e)
            t |= (w0 | (w1 << 32)) << (64 * s)
        assert int(vals[e]) == t * inv % P


def test_rand_limbs_properties(port_draw):
    vals = [int(v) for v in limbs_to_ints(port_draw)]
    assert all(v < P for v in vals) and len(set(vals)) == NUMEL
    assert 0.45 < sum(vals) / NUMEL / P < 0.55
    again = to_reference_limbs(fk.rand_limbs(KEY, NUMEL, device="cpu"))
    assert np.array_equal(again, port_draw)
    other = to_reference_limbs(fk.rand_limbs((KEY[0], 3), NUMEL, device="cpu"))
    assert not np.array_equal(other, port_draw)
    # a shorter draw is a prefix: the counter is the element index
    short = to_reference_limbs(fk.rand_limbs(KEY, 100, device="cpu"))
    assert np.array_equal(short, port_draw[:, :100])


def test_fparray_rand_uses_sampler_layout(port_draw):
    a = FpArray.rand(KEY, (50, 100), device="cpu")
    assert a.shape == (50, 100) and a.limbs.dtype == torch.int32
    assert np.array_equal(to_reference_limbs(a.limbs).reshape(16, NUMEL),
                          port_draw)
    kd = torch.tensor([KEY[0] - (1 << 32), KEY[1] - (1 << 32)],
                      dtype=torch.int64)          # key data as a tensor
    b = FpArray.rand(kd, (NUMEL,), device="cpu")
    assert np.array_equal(to_reference_limbs(b.limbs), port_draw)
    assert FpArray.rand(KEY, (0,), device="cpu").shape == (0,)


def test_split_key_is_deterministic_and_distinct():
    ks = fk.split_key(KEY, 5)
    assert ks == fk.split_key(np.asarray(KEY, np.uint32), 5)
    assert len(set(ks)) == 5 and KEY not in ks
    assert ks[:3] == fk.split_key(KEY, 3)
    assert all(0 <= w < (1 << 32) for k in ks for w in k)
    assert fk.split_key((KEY[0], KEY[1] ^ 1), 5) != ks


def test_rand_limbs_default_device_needs_cuda():
    """No silent CPU default: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(Exception):
        fk.rand_limbs(KEY, 16)
    with pytest.raises(ValueError):
        fk.rand_limbs(KEY, 0, device="cpu")
