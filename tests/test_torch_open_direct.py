"""Port parity: the direct n-party open. The port's plain version against
the reference's Pallas direct-open kernel (interpret mode on the CPU, as
tests/test_fused_open.py runs it) and against Python-int Lagrange
interpolation. Same numpy-seeded shares on both sides; tolerance: exact
equality of every packed word and of the per-party error vector (same
path on both sides, so per-party counts are comparable)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.fused_open_direct import \
    sim_open_direct_packed as ref_open
from honeybadgermpc_tpu_torch.interop import (from_reference_packed,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod
from honeybadgermpc_tpu_torch.ops.fused_open import pack_limbs, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)
from honeybadgermpc_tpu_torch.parallel.reconstruct import \
    _sim_reconstruct_packed_jit

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def deal_packed(seed, n, deg, B, points=None):
    """Python-int dealer: B random secrets shared with degree-`deg`
    polynomials at `points` -> (secrets, np.uint32 packed [PL, n, B])."""
    rng = np.random.default_rng(seed)
    points = points or list(range(1, n + 1))
    draw = lambda: int.from_bytes(rng.bytes(40), "little") % P  # noqa: E731
    coeffs = [[draw() for _ in range(deg + 1)] for _ in range(B)]
    shares = [[sum(c * pow(x, i, P) for i, c in enumerate(cs)) % P
               * R_MOD_P % P for cs in coeffs] for x in points]
    limbs = ints_to_limbs(np.array(shares, object))          # [L, n, B]
    packed = pack_limbs(torch.from_numpy(limbs.view(np.int32)))
    return [cs[0] for cs in coeffs], to_reference_packed(packed)


def opened_ints(sec_packed):
    rinv = pow(R_MOD_P, P - 2, P)
    limbs = unpack_limbs(sec_packed).numpy().view(np.uint32)
    return [int(v) * rinv % P for v in limbs_to_ints(limbs).reshape(-1)]


N, T, B = 8, 2, 9
POINTS = tuple(range(1, N + 1))


@pytest.fixture(scope="module")
def honest():
    return deal_packed(77, N, T, B)


@pytest.mark.parametrize("replicate", [True, False])
def test_open_bit_exact_vs_pallas_interpret(honest, replicate):
    secrets, packed = honest
    s_ref, e_ref = ref_open(jnp.asarray(packed), N, T, POINTS,
                            replicate=replicate)
    s, e = fod.sim_open_direct_packed(
        from_reference_packed(packed, "cpu"), N, T, POINTS,
        replicate=replicate)
    assert tuple(s.shape) == ((8, N, B) if replicate else (8, B))
    assert np.array_equal(to_reference_packed(s.contiguous()),
                          np.asarray(s_ref))
    assert e.dtype == torch.int32
    assert e.tolist() == np.asarray(e_ref).tolist() == [0] * N
    one = s[:, 0] if replicate else s
    assert opened_ints(one) == secrets


@pytest.mark.parametrize("party,word,b", [(N - 1, 0, 3), (4, 7, 0),
                                          (0, 3, 5)])
def test_open_fault_counts_vs_pallas_interpret(honest, party, word, b):
    """A share off the degree-t polynomial trips the predicate; counts are
    charged to the source party, exactly as the reference kernel does."""
    _, packed = honest
    bad = packed.copy()
    bad[word, party, b] ^= 0x2482
    s_ref, e_ref = ref_open(jnp.asarray(bad), N, T, POINTS, replicate=False)
    s, e = fod.sim_open_direct_packed(
        from_reference_packed(bad, "cpu"), N, T, POINTS, replicate=False)
    assert e.tolist() == np.asarray(e_ref).tolist()
    assert np.array_equal(to_reference_packed(s), np.asarray(s_ref))
    assert int(e.sum()) > 0 and e[:T + 1].tolist() == [0] * (T + 1)
    if party >= T + 1:
        assert int(e[party]) > 0
        assert int(e.sum()) == int(e[party])


@pytest.mark.parametrize("n,t,b", [(7, 2, 12), (4, 1, 8), (70, 65, 66)])
def test_open_vs_python_ints(n, t, b):
    """Unaligned party counts and a contraction longer than 64 (the
    balanced scheme's bias grows with k), against Python ints only."""
    secrets, packed = deal_packed(100 + n, n, t, b)
    run = _sim_reconstruct_packed_jit(n, t, False, True, fallback=False,
                                      replicate=False)
    sec, nerr = run(from_reference_packed(packed, "cpu"))
    assert nerr.tolist() == [0] * n
    assert opened_ints(sec) == secrets
    bad = packed.copy()
    bad[2, n - 1, b - 1] ^= 1
    _, nerr2 = run(from_reference_packed(bad, "cpu"))
    assert nerr2.tolist() == [0] * (n - 1) + [1]


def test_open_degree_2t_shape():
    """k = 2t+1 (the degree-2t open the triples path needs)."""
    n, t = 8, 2
    secrets, packed = deal_packed(5, n, 2 * t, 10)
    sec, nerr = fod.sim_open_direct_packed(
        from_reference_packed(packed, "cpu"), n, 2 * t, POINTS,
        replicate=False)
    assert nerr.tolist() == [0] * n and opened_ints(sec) == secrets


def test_open_k43_batch_off_the_tile_with_zero_tail():
    """The triple finish's open, scaled down: n=64, k = 2t+1 = 43, a batch
    that is a multiple of 43 but not of 128 (there 98,341 = 24*4096 + 37
    columns), whose last columns are the zero sharings that pad it."""
    n, t2, real, pad = 64, 42, 43 * 4 - 37, 37
    secrets, packed = deal_packed(43, n, t2, real)
    assert (real + pad) % 43 == 0 and (real + pad) % 128 != 0
    padded = np.concatenate(
        [packed, np.zeros((8, n, pad), np.uint32)], axis=-1)
    run = _sim_reconstruct_packed_jit(n, t2, False, True, fallback=False,
                                      replicate=False)
    sec, nerr = run(from_reference_packed(padded, "cpu"))
    assert tuple(sec.shape) == (8, real + pad)
    assert nerr.tolist() == [0] * n
    assert opened_ints(sec) == secrets + [0] * pad
    bad = padded.copy()
    bad[6, n - 2, real + 5] ^= 0x100          # a fault inside the zero tail
    _, nerr2 = run(from_reference_packed(bad, "cpu"))
    assert nerr2.tolist() == [0] * (n - 2) + [1, 0]


def test_open_checks_its_input_and_unported_branches(honest):
    _, packed = honest
    good = from_reference_packed(packed, "cpu")
    # robust=True on honest shares: the detect-only result, no redo
    sec_r, nerr_r = fod.sim_open_direct_packed(good, N, T, POINTS,
                                               robust=True)
    sec_d, nerr_d = fod.sim_open_direct_packed(good, N, T, POINTS)
    assert torch.equal(sec_r, sec_d) and torch.equal(nerr_r, nerr_d)
    # the other branches are the three-kernel open (same secrets; on
    # honest shares no count, no fallback)
    for args, kw in (((N, T, False, True), {}),
                     ((N, T, False, False), {"fallback": False})):
        sec_f, nerr_f = _sim_reconstruct_packed_jit(*args, **kw)(good)
        assert torch.equal(sec_f, sec_d) and nerr_f.tolist() == [0] * N
    with pytest.raises(ValueError):
        fod.sim_open_direct_packed(good.to(torch.int64), N, T, POINTS)
    with pytest.raises(ValueError):
        fod.sim_open_direct_packed(good[:, :, ::3], N, T, POINTS)
    with pytest.raises(ValueError):
        fod.sim_open_direct_packed(good[:, :, :8].contiguous(), N, T, POINTS)
    with pytest.raises(ValueError):
        fod.sim_open_direct_packed(good, N, T, POINTS[:-1])
    assert fod.direct_fits(64, 22) and fod.direct_fits(64, 43)
    assert not fod.direct_fits(8, 8) and not fod.direct_fits(200, 129)
