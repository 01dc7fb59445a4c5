"""Port parity: the flat broadcast subtract sub_bcast_packed
(ops/field_kernels.py; on a card csrc/packed_arith.cu), the port of
ops/pallas_field.py::sub_bcast_packed, which the port's flat triple finish
(runtime/offline.py::fused_generate_triples(packed=False)) runs.

The port's plain version against (a) the JAX package's plain
ops/montgomery.py::sub_mod on the unpacked words, at column counts that are
multiples of nothing (the reference pads B to its TPU tile; the port takes
B as it is), and (b) Python ints, edge values included. The reference's
Pallas kernel compiles for many minutes in interpret mode on a CPU, like
its 4D sibling, so the one test that runs it is in the slow tier.
Tolerance: exact equality of every packed word."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import montgomery as ref_mont
from honeybadgermpc_tpu.ops.fused_open import pack_limbs as ref_pack
from honeybadgermpc_tpu_torch.interop import to_reference_packed
from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops.fused_open import pack_limbs, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

EDGE = [0, 1, P - 1, P - 2, R_MOD_P, (1 << 255) % P, 0xFFFF, P >> 1]


def packed_of(ints):
    """Object array of ints (< 2^256) -> int32 packed tensor [PL, *shape]."""
    limbs = ints_to_limbs(np.asarray(ints, object))
    return pack_limbs(torch.from_numpy(limbs.view(np.int32)))


def ints_of(packed):
    return limbs_to_ints(unpack_limbs(packed).numpy().view(np.uint32))


def draw(rng, shape):
    flat = [int.from_bytes(rng.bytes(40), "little") % P
            for _ in range(int(np.prod(shape)))]
    return np.array(flat, object).reshape(shape)


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("B", [1, 77, 1031])
def test_vs_reference_sub_mod_and_python_ints(n, B):
    rng = np.random.default_rng(1000 * n + B)
    a, b = draw(rng, (B,)), draw(rng, (n, B))
    b[0, : B // 2] = a[: B // 2]                    # a == b -> 0
    got = fk.sub_bcast_packed(packed_of(a), packed_of(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, n, B)
    want = ref_pack(ref_mont.sub_mod(jnp.asarray(ints_to_limbs(a))[:, None],
                                     jnp.asarray(ints_to_limbs(b))))
    assert np.array_equal(to_reference_packed(got), np.asarray(want))
    vals = ints_of(got)
    for idx in np.ndindex((n, B)):
        assert int(vals[idx]) == (int(a[idx[1]]) - int(b[idx])) % P, idx


def test_edge_values_python_ints():
    a = np.array([x for x in EDGE for _ in EDGE], object)
    b = np.array([[y for _ in EDGE for y in EDGE],
                  [y for y in EDGE for _ in EDGE]], object)
    got = ints_of(fk.sub_bcast_packed(packed_of(a), packed_of(b)))
    for idx in np.ndindex(b.shape):
        assert int(got[idx]) == (int(a[idx[1]]) - int(b[idx])) % P, idx
    assert not got[1].any()                         # b[1] == a


def test_equals_the_4d_subtract_on_the_same_words():
    rng = np.random.default_rng(5)
    a, b = draw(rng, (3, 40)), draw(rng, (4, 3, 40))
    flat = fk.sub_bcast_packed(packed_of(a.reshape(-1)),
                               packed_of(b.reshape(4, -1)))
    four = fk.sub_bcast_packed4(packed_of(a), packed_of(b))
    assert torch.equal(flat, four.reshape(8, 4, 120))


def test_takes_row_strided_views():
    """The minuend may be a prefix of a longer opened tensor [PL, B'], and
    the subtrahend a column slice of a wider tensor, as the flat triple
    finish passes them; the result is dense."""
    rng = np.random.default_rng(6)
    a, b = draw(rng, (91,)), draw(rng, (5, 100))
    view = packed_of(a)[:, :77]
    bview = packed_of(b)[:, :, 3:80]
    assert not view.is_contiguous() and not bview.is_contiguous()
    got = fk.sub_bcast_packed(view, bview)
    assert got.is_contiguous()
    assert torch.equal(got, fk.sub_bcast_packed(view.contiguous(),
                                                bview.contiguous()))


def test_checks_its_input():
    a = packed_of(np.array(EDGE, object))
    b = packed_of(np.array([EDGE, EDGE], object))
    with pytest.raises(ValueError):
        fk.sub_bcast_packed(a[:, :4], b)
    with pytest.raises(ValueError):
        fk.sub_bcast_packed(a, b.to(torch.int64))
    with pytest.raises(ValueError):
        fk.sub_bcast_packed(a[:, :4], b[..., ::2])
    with pytest.raises(ValueError):
        fk.sub_bcast_packed(a.t().contiguous().t(), b)


@pytest.mark.slow
def test_vs_reference_pallas_kernel():
    """SLOW tier: the reference's own sub_bcast_packed (Pallas interpret
    mode, one tile of SUBS*512 columns; its compile takes many minutes on a
    CPU, as its 4D sibling's does) at its smallest shape, n = 1, B = 1."""
    from honeybadgermpc_tpu.ops.pallas_field import \
        sub_bcast_packed as ref_sub_bcast
    a = packed_of(np.array([EDGE[1]], object))
    b = packed_of(np.array([[EDGE[2]]], object))
    want = np.asarray(ref_sub_bcast(jnp.asarray(to_reference_packed(a)),
                                    jnp.asarray(to_reference_packed(b))))
    assert np.array_equal(to_reference_packed(fk.sub_bcast_packed(a, b)),
                          want)
    assert int(ints_of(fk.sub_bcast_packed(a, b))[0, 0]) == 2
