"""Port parity: the packed 4D finish arithmetic, mul_add_packed4 and
sub_bcast_packed4 (ops/field_kernels.py; on a card csrc/packed_arith.cu).

The port's plain versions against (a) Python ints, edge values included,
and (b) the JAX package on the same numpy-seeded words at [8, 8, 8, 128].
On the CPU the reference's two Pallas kernels take many minutes each to
compile in interpret mode (its own tests keep them in the slow tier), so
the port is held against the reference's plain versions of the same
functions (ops/montgomery.py: mont_mul, add_mod, sub_mod around
unpack/pack), which the reference's own slow tests hold its kernels to;
one slow-tier test here runs the two Pallas kernels themselves on the same
words. Tolerance: exact equality of every packed word."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import montgomery as ref_mont
from honeybadgermpc_tpu.ops.fused_open import pack_limbs as ref_pack
from honeybadgermpc_tpu.ops.fused_open import unpack_limbs as ref_unpack
from honeybadgermpc_tpu_torch.interop import (from_reference_packed,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops.fused_open import pack_limbs, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)
SHAPE = (8, 8, 128)                       # n, R, S


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


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(404)
    a, b, c = (draw(rng, SHAPE) for _ in range(3))
    m = draw(rng, SHAPE[1:])
    return a, b, c, m


@pytest.fixture(scope="module")
def reference(operands):
    """The JAX package's plain versions on the same words."""
    a, b, c, m = operands
    la, lb, lc, lm = (jnp.asarray(ints_to_limbs(v)) for v in (a, b, c, m))
    z = ref_pack(ref_mont.add_mod(ref_mont.mont_mul(la, lb), lc))
    d = ref_pack(ref_mont.sub_mod(lm[:, None], lb))
    return np.asarray(z), np.asarray(d)


def test_mul_add_packed4_vs_reference_plain(operands, reference):
    a, b, c, _ = operands
    got = fk.mul_add_packed4(packed_of(a), packed_of(b), packed_of(c))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8,) + SHAPE
    assert np.array_equal(to_reference_packed(got), reference[0])


def test_sub_bcast_packed4_vs_reference_plain(operands, reference):
    _, b, _, m = operands
    got = fk.sub_bcast_packed4(packed_of(m), packed_of(b))
    assert tuple(got.shape) == (8,) + SHAPE
    assert np.array_equal(to_reference_packed(got), reference[1])


@pytest.mark.slow
def test_packed4_vs_reference_pallas_kernels(operands, reference):
    """SLOW tier: the reference's own mul_add_packed4 and sub_bcast_packed4
    (ops/pallas_field.py, Pallas interpret mode; each compiles for ten
    minutes or more on a CPU and is cached thereafter) on the same words:
    equal to the reference's plain versions and to the port."""
    from honeybadgermpc_tpu.ops.pallas_field import \
        mul_add_packed4 as ref_mul_add4
    from honeybadgermpc_tpu.ops.pallas_field import \
        sub_bcast_packed4 as ref_sub_bcast4
    pa, pb, pc, pm = (packed_of(v) for v in operands)
    ja, jb, jc, jm = (jnp.asarray(to_reference_packed(x))
                      for x in (pa, pb, pc, pm))
    z = np.asarray(ref_mul_add4(ja, jb, jc))
    d = np.asarray(ref_sub_bcast4(jm, jb))
    assert np.array_equal(z, reference[0])
    assert np.array_equal(d, reference[1])
    assert np.array_equal(to_reference_packed(fk.mul_add_packed4(pa, pb, pc)),
                          z)
    assert np.array_equal(to_reference_packed(fk.sub_bcast_packed4(pm, pb)),
                          d)


def test_reference_words_round_trip_4d(reference):
    """4D packed tensors cross the boundary unchanged, both ways."""
    t = from_reference_packed(reference[0], "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (8,) + SHAPE
    assert np.array_equal(to_reference_packed(t), reference[0])
    assert np.array_equal(np.asarray(ref_unpack(jnp.asarray(reference[0]))),
                          unpack_limbs(t).numpy().view(np.uint32))


EDGE = [0, 1, P - 1, P - 2, R_MOD_P, (1 << 255) % P, 0xFFFF, P >> 1]


@pytest.mark.parametrize("shape", [(1, 1, len(EDGE) ** 2), (3, 5, 7)])
def test_mul_add_packed4_vs_python_ints(shape):
    rng = np.random.default_rng(11)
    if shape[0] == 1:                       # every pair of edge values
        a = np.array([x for x in EDGE for _ in EDGE], object).reshape(shape)
        b = np.array([y for _ in EDGE for y in EDGE], object).reshape(shape)
        c = np.array([EDGE[(i * 3) % len(EDGE)]
                      for i in range(len(EDGE) ** 2)], object).reshape(shape)
    else:
        a, b, c = (draw(rng, shape) for _ in range(3))
        b[0] = a[0]                          # a == b
    got = ints_of(fk.mul_add_packed4(packed_of(a), packed_of(b),
                                     packed_of(c)))
    for idx in np.ndindex(shape):
        want = (int(a[idx]) * int(b[idx]) * RINV + int(c[idx])) % P
        assert int(got[idx]) == want, idx


def test_sub_bcast_packed4_vs_python_ints():
    rng = np.random.default_rng(12)
    n, R, S = 3, 2, len(EDGE)
    m = np.array([EDGE, EDGE[::-1]], object)
    b = draw(rng, (n, R, S))
    b[0] = m                                 # a == b -> 0
    b[1, 0] = np.array(EDGE[1:] + EDGE[:1], object)
    got = ints_of(fk.sub_bcast_packed4(packed_of(m), packed_of(b)))
    for idx in np.ndindex((n, R, S)):
        assert int(got[idx]) == (int(m[idx[1:]]) - int(b[idx])) % P, idx
    assert not got[0].any()


def test_mul_add_packed4_padded_flat_form(operands):
    """mul_add_packed4_flat: the same values flat, with a zero tail of
    `pad` columns per party (none at pad=0)."""
    a, b, c = (packed_of(v[:2, :3]) for v in operands[:3])
    z4 = fk.mul_add_packed4(a, b, c)
    assert tuple(z4.shape) == (8, 2, 3, 128)
    zf = fk.mul_add_packed4_flat(a, b, c, pad=5)
    assert tuple(zf.shape) == (8, 2, 3 * 128 + 5)
    assert torch.equal(zf[:, :, :384], z4.reshape(8, 2, 384))
    assert not zf[:, :, 384:].any()
    assert torch.equal(fk.mul_add_packed4_flat(a, b, c),
                       z4.reshape(8, 2, 384))


def test_sub_bcast_packed4_takes_a_prefix_view(operands):
    """The minuend may be a prefix of a longer opened tensor [PL, B]."""
    _, b, _, m = operands
    pm, pb = packed_of(m), packed_of(b)
    cnt = SHAPE[1] * SHAPE[2]
    longer = torch.cat([pm.reshape(8, cnt), pm.reshape(8, cnt)[:, :37]], -1)
    view = longer[:, :cnt].reshape(8, SHAPE[1], SHAPE[2])
    assert not view.is_contiguous()
    assert torch.equal(fk.sub_bcast_packed4(view, pb),
                       fk.sub_bcast_packed4(pm, pb))


def test_packed4_wrappers_check_their_input(operands):
    a = packed_of(operands[0])
    m = packed_of(operands[3])
    with pytest.raises(ValueError):
        fk.mul_add_packed4(a, a, a[:, :4])
    with pytest.raises(ValueError):
        fk.mul_add_packed4(a, a, a.to(torch.int64))
    with pytest.raises(ValueError):
        fk.mul_add_packed4(a[..., ::2], a[..., ::2], a[..., ::2])
    with pytest.raises(ValueError):
        fk.sub_bcast_packed4(m[:, :4], a)
    with pytest.raises(ValueError):
        fk.sub_bcast_packed4(m.transpose(1, 2).contiguous().transpose(1, 2),
                             a)
