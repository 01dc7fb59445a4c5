"""Port parity for the third slice: the robust batch open under faults.

The same faulty shares, built with numpy from a seed (neither package's
FpArray.rand draws them), go through the reference (JAX on the CPU) and
the port (plain versions on the CPU): host_robust_redo (also in forced
small segments), batch_reconstruct with its Gao fallback,
robust_open_single, sim_open_direct_packed(robust=True) and the two-phase
sim_batch_reconstruct. Secrets and per-party error counts must be equal
word for word, and the secrets equal to the dealt ones (Python ints).
Error counts are compared only between the same path of both packages:
the direct open charges the source party, the Gao paths the destination.

Shapes are the reference's own tests' (tests/test_reconstruct.py,
tests/test_offline.py, tests/test_fused_open.py), so one persistent XLA
cache serves both. The reference's results come from committed golden
vectors (tests/_golden.py, made by tests/make_golden.py); each such test
has a twin in the slow tier that runs the reference live."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.ops.fused_open import pack_limbs as ref_pack
from honeybadgermpc_tpu.ops.fused_open_direct import \
    sim_open_direct_packed as ref_direct
from honeybadgermpc_tpu.parallel import reconstruct as ref_rec
from honeybadgermpc_tpu.parallel.mesh import SimBackend as RefSimBackend
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              from_reference_packed,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.fused_open import unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)
from honeybadgermpc_tpu_torch.parallel import reconstruct as rec
from honeybadgermpc_tpu_torch.parallel.mesh import SimBackend

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)


def _deal(seed, n, t, B, bad):
    """B random secrets, degree-t shares [n, B] at points 1..n, with the
    shares of the parties in `bad` replaced by other field elements.
    Returns (secrets, honest limbs, faulty limbs) as np.uint32 [L, n, B]."""
    rng = np.random.default_rng(seed)
    draw = lambda: int.from_bytes(rng.bytes(40), "little") % P  # noqa: E731
    secrets = [draw() for _ in range(B)]
    polys = [[s] + [draw() for _ in range(t)] for s in secrets]
    sh = [[sum(c * pow(j + 1, i, P) for i, c in enumerate(f)) % P
           for f in polys] for j in range(n)]
    bad_sh = [[draw() if j in bad else v for v in row]
              for j, row in enumerate(sh)]
    to_l = lambda m: ints_to_limbs(np.array(  # noqa: E731
        [[v * R_MOD_P % P for v in row] for row in m], object))
    return secrets, to_l(sh), to_l(bad_sh)


def _plain_rows(limbs_np):
    """np.uint32 Montgomery limbs [L, n, B] -> plain ints [n][B]."""
    return [[int(v) * RINV % P for v in row]
            for row in limbs_to_ints(limbs_np).tolist()]


def _mat_limbs(seed, shape):
    """np.uint32 limbs [L, *shape] of uniform field elements."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % P
            for _ in range(int(np.prod(shape)))]
    return ints_to_limbs(np.array(vals, object).reshape(shape))


def _port_fp(limbs_np):
    return FpArray(from_reference_limbs(limbs_np, "cpu"))


def _mont_words(vals):
    """Python ints -> np.uint32 Montgomery limbs."""
    return ints_to_limbs(np.array([[v * R_MOD_P % P for v in row]
                                   for row in vals], object))


def _ref_sim_batch():
    """The reference's host_robust_redo and its CPU sim_batch_reconstruct
    (the generic program with the in-graph Gao fallback) at n=7, t=2 with
    party 2 faulty; the two agree."""
    n, t, B = 7, 2, 9
    _, _, faulty = _deal(1, n, t, B, [2])
    ref_sec, ref_nerr = ref_rec.host_robust_redo(faulty, n, t)
    ref_sec2, ref_nerr2 = ref_rec.sim_batch_reconstruct(
        RefFpArray(jnp.asarray(faulty)), n, t)
    assert np.array_equal(np.asarray(ref_sec2.limbs), ref_sec)
    assert np.asarray(ref_nerr2).tolist() == ref_nerr.tolist()
    return {"sec": np.asarray(ref_sec), "nerr": np.asarray(ref_nerr)}


def _check_sim_batch(ref):
    n, t, B = 7, 2, 9
    secrets, honest, faulty = _deal(1, n, t, B, [2])
    ref_sec, ref_nerr = ref["sec"], ref["nerr"]
    assert ref_nerr.tolist() == [3] * n

    sec, nerr = rec.sim_batch_reconstruct(_port_fp(faulty), n, t)
    assert np.array_equal(to_reference_limbs(sec.limbs), ref_sec)
    assert nerr.tolist() == ref_nerr.tolist()
    assert np.array_equal(ref_sec, _mont_words([secrets] * n))

    sec_h, nerr_h = rec.sim_batch_reconstruct(_port_fp(honest), n, t)
    assert np.array_equal(to_reference_limbs(sec_h.limbs), ref_sec)
    assert nerr_h.tolist() == [0] * n


def test_sim_batch_reconstruct_and_redo_word_equal_to_the_reference():
    """The two-phase open at n=7, t=2 with party 2 faulty: the port's
    sim_batch_reconstruct (direct open, then host_robust_redo) against the
    reference's host_robust_redo and its CPU sim_batch_reconstruct (the
    generic program with the in-graph Gao fallback): same secrets, same
    per-destination counts (C*|S| = 3 at every party). Honest shares open
    with nerr == 0."""
    _check_sim_batch(golden("robust_sim_batch"))


@pytest.mark.slow
def test_sim_batch_reconstruct_and_redo_vs_the_live_reference():
    _check_sim_batch(_ref_sim_batch())


def test_host_robust_redo_does_not_depend_on_segments():
    """Forced 4-instance Gao segments (7 decodes per round in 2 segments,
    the last zero-padded) give the words of the dealt secrets and the
    per-destination counts (C*|S| = 1 at every party)."""
    n, t, B = 7, 2, 3
    secrets, _, faulty = _deal(8, n, t, B, [2])
    old = rec._REDO_SEG
    try:
        rec._REDO_SEG = 4
        sec, nerr = rec.host_robust_redo(faulty, n, t, device="cpu")
    finally:
        rec._REDO_SEG = old
    assert sec.dtype == np.uint32 and nerr.dtype == np.int32
    assert np.array_equal(sec, _mont_words([secrets] * n))
    assert nerr.tolist() == [1] * n


def _ref_batch():
    n, t, B = 7, 2, 6
    _, _, faulty = _deal(2, n, t, B, [0, 5])
    ref_sec, ref_nerr = ref_rec.batch_reconstruct(
        RefSimBackend(n), RefFpArray(jnp.asarray(faulty)), n, t)
    return {"sec": np.asarray(ref_sec.limbs), "nerr": np.asarray(ref_nerr)}


def _check_batch(ref):
    n, t, B = 7, 2, 6
    secrets, _, faulty = _deal(2, n, t, B, [0, 5])
    sec, nerr = rec.batch_reconstruct(SimBackend(n), _port_fp(faulty), n, t)
    assert np.array_equal(to_reference_limbs(sec.limbs), ref["sec"])
    assert nerr.tolist() == ref["nerr"].tolist() == [4] * n
    assert _plain_rows(to_reference_limbs(sec.limbs)) == [secrets] * n


def test_batch_reconstruct_with_faults_word_equal_to_the_reference():
    """n=7, t=2, parties 0 and 5 faulty: R1 falls back to Gao."""
    _check_batch(golden("robust_batch"))


@pytest.mark.slow
def test_batch_reconstruct_with_faults_vs_the_live_reference():
    _check_batch(_ref_batch())


def _ref_single():
    n, t, S = 7, 2, 3
    _, _, faulty = _deal(3, n, t, S, [1, 6])
    ref_vals, ref_errs = ref_rec.robust_open_single(
        RefSimBackend(n), RefFpArray(jnp.asarray(faulty)), n, t)
    return {"vals": np.asarray(ref_vals.limbs), "errs": np.asarray(ref_errs)}


def _check_single(ref):
    n, t, S = 7, 2, 3
    secrets, _, faulty = _deal(3, n, t, S, [1, 6])
    vals, errs = rec.robust_open_single(SimBackend(n), _port_fp(faulty), n, t)
    assert np.array_equal(to_reference_limbs(vals.limbs), ref["vals"])
    assert np.array_equal(errs.numpy(), ref["errs"])
    assert _plain_rows(to_reference_limbs(vals.limbs)) == [secrets] * n
    assert errs.tolist() == [[2] * S] * n


def test_robust_open_single_word_equal_to_the_reference():
    _check_single(golden("robust_single"))


@pytest.mark.slow
def test_robust_open_single_vs_the_live_reference():
    _check_single(_ref_single())


def _ref_direct():
    n, t, B = 8, 2, 6
    points = tuple(range(1, n + 1))
    _, honest, faulty = _deal(4, n, t, B, [5])
    packed = np.asarray(jax.jit(ref_pack)(jnp.asarray(faulty)))
    ref_sec, ref_nerr = jax.jit(lambda p: ref_direct(
        p, n, t, points, robust=True))(jnp.asarray(packed))
    return {"packed": packed, "sec": np.asarray(ref_sec),
            "nerr": np.asarray(ref_nerr),
            "packed_honest": np.asarray(jax.jit(ref_pack)(
                jnp.asarray(honest)))}


def _check_direct(ref):
    n, t, B = 8, 2, 6
    points = tuple(range(1, n + 1))
    secrets, _, _ = _deal(4, n, t, B, [5])
    sec, nerr = fod.sim_open_direct_packed(
        from_reference_packed(ref["packed"], "cpu"), n, t, points,
        robust=True)
    assert np.array_equal(sec.numpy().view(np.uint32), ref["sec"])
    assert nerr.tolist() == ref["nerr"].tolist()
    assert sum(nerr.tolist()) > 0
    assert _plain_rows(to_reference_limbs(unpack_limbs(sec))) == \
        [secrets] * n
    # honest shares: the detect-only result, no redo
    hp = from_reference_packed(ref["packed_honest"], "cpu")
    sec_h, nerr_h = fod.sim_open_direct_packed(hp, n, t, points, robust=True)
    want_h, _ = fod.sim_open_direct_packed(hp, n, t, points)
    assert torch.equal(sec_h, want_h) and nerr_h.tolist() == [0] * n


def test_direct_open_robust_fallback_word_equal_to_the_reference():
    """sim_open_direct_packed(robust=True) at n=8, t=2 with party 5
    faulty: the detect-only kernel sees the fault, batch_reconstruct
    corrects it; packed secrets and counts as the reference's. The packed
    shares are the reference's pack_limbs of the dealt limbs (the golden
    file holds them; the port's pack is compared with the reference's in
    test_torch_bands.py)."""
    _check_direct(golden("robust_direct"))


@pytest.mark.slow
def test_direct_open_robust_fallback_vs_the_live_reference():
    _check_direct(_ref_direct())


GOLDEN = {"robust_sim_batch": _ref_sim_batch, "robust_batch": _ref_batch,
          "robust_single": _ref_single, "robust_direct": _ref_direct}


def test_inject_share_faults_replaces_only_the_listed_parties():
    n, t, B = 7, 2, 6
    _, honest, _ = _deal(5, n, t, B, [])
    shares = _port_fp(honest)
    ids = SimBackend(n).my_ids("cpu")
    faulty = rec.inject_share_faults(shares, ids, [1, 4], (9, 10))
    draw = FpArray.rand((9, 10), (n, B), device="cpu")
    for j in range(n):
        want = draw if j in (1, 4) else shares
        assert torch.equal(faulty.limbs[:, j], want.limbs[:, j])


def test_simbackend_collectives_match_the_reference():
    n = 4
    x = _mat_limbs(6, (n, 3, n))
    ref, port = RefSimBackend(n), SimBackend(n)
    pairs = ((ref.all_to_all(RefFpArray(jnp.asarray(x))),
              port.all_to_all(_port_fp(x))),
             (ref.all_gather(RefFpArray(jnp.asarray(x[:, :, 0]))),
              port.all_gather(_port_fp(x[:, :, 0]))),
             (ref.broadcast_from(RefFpArray(jnp.asarray(x)), 2),
              port.broadcast_from(_port_fp(x), 2)))
    for want, got in pairs:
        assert np.array_equal(to_reference_limbs(got.limbs.contiguous()),
                              np.asarray(want.limbs))
    assert port.my_ids("cpu").tolist() == list(range(n))


def test_generic_open_serves_shapes_the_direct_open_does_not():
    """n = t+1 = 3 leaves the direct open no validating party: the generic
    two-round program opens the batch."""
    n, t, B = 3, 2, 6
    secrets, honest, _ = _deal(7, n, t, B, [])
    run = rec._sim_reconstruct_jit(n, t, False, True)
    assert not getattr(run, "packed", False)
    limbs, nerr = run(from_reference_limbs(honest, "cpu"))
    assert _plain_rows(to_reference_limbs(limbs)) == [secrets] * n
    assert nerr.tolist() == [0] * n


@pytest.mark.parametrize("robust", [True, False])
def test_unported_branches_raise(robust):
    with pytest.raises(NotImplementedError):
        rec._sim_reconstruct_jit(8, 7, False, robust)   # no direct open
    with pytest.raises(NotImplementedError):
        rec.batch_reconstruct(object(), FpArray.zeros((4, 2), device="cpu"),
                              4, 1, robust=robust)
