"""Port parity for the dealer (runtime/preprocessing.py): every kind the
reference deals, and the state carried across between the packages.

Every kind, the port alone at n=4, t=1 and n=7, t=2 on the CPU, each
dealt pool opened through the port's context against Python ints: ab ==
a*b for triples; r, r^2, r^3 for cubes; one secret at degree t and 2t for
double_shares; zeros open to 0; bits lie in {0, 1} and one_minus_ones in
{1, p-1}; share_bits recompose r; powers are x^1..x^k; a share opens to
its value at its degree. An honest open validates every share against the
degree (nerr 0), so each pool's sharings have the right degree.

State both ways: pools of every kind and every pool shape ([n, k, 3],
[n, k, 2], [n, k, 256], [n, x_count, k], [n, 1, 1], [n, k, 1]), part of
each consumed, saved by the JAX package load into the port word-equal,
and the port's saved pools load into the JAX package word-equal. The port
draws its own values (runtime/preprocessing.py's docstring), so the
packages are compared on shared files, not on a shared seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import NT, plain
from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.runtime.preprocessing import \
    PreProcessedElements as RefPre
from honeybadgermpc_tpu_torch.interop import to_reference_limbs
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import (
    PreProcessedElements, preprocessing_done, wait_for_preprocessing)

K = 6


def _ctx(n, t, seed=3):
    pre = PreProcessedElements(n, t, seed=seed, device="cpu")
    return MpcContext(n, t, preproc=pre, device="cpu")


def _open(ctx, fp, degree=None):
    """Party 0's opened ints of a dealt [n, ...] tensor (every party's
    view equal, no error)."""
    out = ctx.open_share_array(ctx.ShareArray(fp, degree))
    lim = out.limbs
    assert torch.equal(lim, lim[:, :1].expand_as(lim))
    return plain(to_reference_limbs(lim[:, 0]))


@pytest.mark.parametrize("n,t", NT)
def test_triples_cubes_and_double_shares(n, t):
    ctx = _ctx(n, t)
    pre = ctx.preproc
    pre.generate_triples(K)
    pre.generate_cubes(K)
    pre.generate_double_shares(K)
    a, b, ab = (_open(ctx, x) for x in pre.get_triples(K))
    assert ab == [u * v % P for u, v in zip(a, b)]
    assert len(set(a)) == K and a != b
    r, r2, r3 = (_open(ctx, x) for x in pre.get_cubes(K))
    assert r2 == [v * v % P for v in r] and r3 == [v ** 3 % P for v in r]
    r_t, r_2t = pre.get_double_shares(K)
    assert _open(ctx, r_t) == _open(ctx, r_2t, 2 * t)
    assert ctx.nerr_total.tolist() == [0] * n


@pytest.mark.parametrize("n,t", NT)
def test_zeros_bits_and_one_minus_ones(n, t):
    ctx = _ctx(n, t)
    pre = ctx.preproc
    pre.generate_zeros(K)
    pre.generate_bits(64)
    pre.generate_one_minus_ones(64)
    assert _open(ctx, pre.get_zeros(K)) == [0] * K
    bits = _open(ctx, pre.get_bits(64))
    assert set(bits) == {0, 1}
    pm = _open(ctx, pre.get_one_minus_ones(64))
    assert set(pm) == {1, P - 1}
    assert ctx.nerr_total.tolist() == [0] * n


@pytest.mark.parametrize("n,t", NT)
def test_share_bits_powers_and_share(n, t):
    ctx = _ctx(n, t)
    pre = ctx.preproc
    pre.generate_share_bits(3)
    pre.generate_powers(2, 5)
    pre.generate_share(1234)
    pre.generate_share(99, 2 * t)
    r, bits = pre.get_share_bits(3)
    assert tuple(bits.shape) == (n, 3, 255)
    rv = _open(ctx, r)
    bv = _open(ctx, bits.reshape(n, 3 * 255))
    for i, v in enumerate(rv):
        row = bv[i * 255:(i + 1) * 255]
        assert set(row) <= {0, 1}
        assert sum(bit << j for j, bit in enumerate(row)) == v
    pw = pre.get_powers(2)
    assert tuple(pw.shape) == (n, 2, 5)
    vals = _open(ctx, pw.reshape(n, 10))
    for i in range(2):
        x = vals[i * 5]
        assert vals[i * 5:(i + 1) * 5] == [pow(x, e, P) for e in range(1, 6)]
    assert _open(ctx, pre.get_share().reshape(n, 1)) == [1234]
    assert _open(ctx, pre.get_share(2 * t).reshape(n, 1), 2 * t) == [99]
    assert ctx.nerr_total.tolist() == [0] * n


def test_dealer_is_reproducible_and_keyed():
    """One seed deals the same words; the dealer programs take explicit
    key data, and another key deals other words."""
    one, two = (PreProcessedElements(4, 1, seed=8, device="cpu")
                for _ in range(2))
    for pre in (one, two):
        pre.generate_triples(3)
        pre.generate_bits(5)
    for x, y in zip(one.get_triples(3) + (one.get_bits(5),),
                    two.get_triples(3) + (two.get_bits(5),)):
        assert torch.equal(x.limbs, y.limbs)
    one.generate_cubes(3, key_data=(1, 2))
    two.generate_cubes(3, key_data=(1, 3))
    c1, c2 = one.get_cubes(3), two.get_cubes(3)
    assert not torch.equal(c1[0].limbs, c2[0].limbs)


def test_ready_barrier(tmp_path):
    with pytest.raises(TimeoutError):
        wait_for_preprocessing(str(tmp_path), timeout=0.05, poll=0.01)
    preprocessing_done(str(tmp_path))
    wait_for_preprocessing(str(tmp_path), timeout=1.0)


# -- state carried across -----------------------------------------------------

# kind -> (pool limbs shape after [L, n]: (capacity, parts), consumed)
POOLS = {"triples": ((9, 3), 2), "cubes": ((5, 3), 0),
         "rands": ((7, 1), 3), "zeros": ((4, 1), 1), "bits": ((6, 1), 2),
         "one_minus_ones": ((5, 1), 0), "double_shares": ((8, 2), 5),
         "share_bits": ((3, 256), 1), "powers": ((4, 6), 1),
         "share_d1": ((2, 1), 1), "share_d2": ((1, 1), 0)}


def _take(pre, kind, k):
    """The same consumer on either package's dealer -> list of np.uint32."""
    if kind == "powers":
        out = [pre.get_powers(k)]
    elif kind.startswith("share_d"):
        out = [pre.get_share(int(kind[7:])) for _ in range(k)]
    else:
        got = getattr(pre, f"get_{kind}")(k)
        out = list(got) if isinstance(got, tuple) else [got]
    words = []
    for fp in out:
        lim = fp.limbs
        words.append(to_reference_limbs(lim) if isinstance(lim, torch.Tensor)
                     else np.asarray(lim))
    return words


def _random_pool(rng, n, shape):
    return rng.integers(0, 1 << 16, (16, n) + shape, dtype=np.uint32)


def test_reference_pools_load_into_the_port(tmp_path):
    n, t = 4, 1
    rng = np.random.default_rng(44)
    ref = RefPre(n, t, seed=0)
    for kind, (shape, used) in POOLS.items():
        ref._pool(kind).put(RefFpArray(jnp.asarray(_random_pool(rng, n,
                                                                shape))))
        if used:
            _take(ref, kind, used)
    ref.save(str(tmp_path))
    port = PreProcessedElements(n, t, device="cpu")
    port.load(str(tmp_path))
    again = RefPre(n, t, seed=0)
    again.load(str(tmp_path))
    for kind, (shape, used) in POOLS.items():
        left = shape[0] - used
        assert port._pool(kind).remaining() == left, kind
        if left:
            for got, want in zip(_take(port, kind, left),
                                 _take(again, kind, left)):
                assert got.dtype == np.uint32
                assert np.array_equal(got, want), kind


def test_port_pools_load_into_the_reference(tmp_path):
    n, t = 4, 1
    port = PreProcessedElements(n, t, seed=6, device="cpu")
    port.generate_triples(3)
    port.generate_cubes(2)
    port.generate_rands(4)
    port.generate_zeros(2)
    port.generate_bits(3)
    port.generate_one_minus_ones(2)
    port.generate_double_shares(3)
    port.generate_share_bits(2)
    port.generate_powers(3, 4)
    port.generate_share(5)
    port.generate_share(6, 2)
    port.generate_share(7)
    for kind, k in (("triples", 1), ("rands", 2), ("share_d1", 1),
                    ("powers", 1), ("share_bits", 1)):
        _take(port, kind, k)
    port.save(str(tmp_path))
    ref = RefPre(n, t, seed=0)
    ref.load(str(tmp_path))
    again = PreProcessedElements(n, t, device="cpu")
    again.load(str(tmp_path))
    for kind, pool in again._pools.items():
        left = pool.remaining()
        assert ref._pool(kind).remaining() == left, kind
        for got, want in zip(_take(ref, kind, left),
                             _take(again, kind, left)):
            assert np.array_equal(np.asarray(got), want), kind
    assert sorted(again._pools) == sorted(
        ["triples", "cubes", "rands", "zeros", "bits", "one_minus_ones",
         "double_shares", "share_bits", "powers", "share_d1", "share_d2"])
