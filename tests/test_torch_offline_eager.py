"""Port parity for the fourth slice: the eager per-column offline programs
(runtime/offline.py: randousha, generate_triples, generate_bits) and their
routes through ``sim_offline_jit``.

Randomness: the reference draws its secrets and dealing coefficients with
``jax.random.split(key, 4)`` and ``FpArray.rand`` (jax.random.bits on the
CPU); the port takes those very values through its ``draws=`` hook, so
both programs run on the same numbers. The reference runs eagerly on the
CPU with ``in_graph_fallback=False`` (its generic detect-only opens; on
honest shares every open route gives the same values); the port runs its
accelerator routes on the CPU: the direct open, the three-kernel open with
its fallback (n % 8 == 0), and the host redo. Tolerance: exact equality of
every limb word and of ok. generate_triples is word-equal in the slow tier
(the reference's own test_generate_triples is slow); in the fast tier its
triples are checked in Python ints. The reference's randousha and
generate_bits results, and the draws the port takes from it, come from
committed golden vectors (tests/_golden.py) in the fast tier; a slow twin
of each test computes them live."""

import jax
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.parallel.mesh import SimBackend as RefSimBackend
from honeybadgermpc_tpu.runtime import offline as ref_off
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.fused_open import _lam_int
from honeybadgermpc_tpu_torch.ops.limbs import P, R_MOD_P, limbs_to_ints
from honeybadgermpc_tpu_torch.parallel.mesh import SimBackend
from honeybadgermpc_tpu_torch.runtime import offline

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)
SHAPES = [(4, 1), (7, 2)]


def reference_draws(seed, n, t, slots):
    """The values the reference's randousha(key = PRNGKey(seed)) draws, as
    the port's draws=(secrets, hi_t, hi_2t) on the CPU."""
    _, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 4)
    vals = (RefFpArray.rand(k1, (n, slots)),
            RefFpArray.rand(k2, (n, slots, t)),
            RefFpArray.rand(k3, (n, slots, 2 * t)))
    return tuple(FpArray(from_reference_limbs(np.asarray(v.limbs), "cpu"))
                 for v in vals)


def draws_of(ref):
    """The port's draws= from a reference result's stored draws."""
    return tuple(FpArray(from_reference_limbs(ref[f"draw{i}"], "cpu"))
                 for i in range(3))


def stored_draws(seed, n, t, slots):
    """reference_draws as numpy arrays, for the golden vectors."""
    return {f"draw{i}": to_reference_limbs(d.limbs)
            for i, d in enumerate(reference_draws(seed, n, t, slots))}


def words(x):
    return to_reference_limbs(x.limbs)


def secrets_of(x, t, parties=None):
    """Plain secrets of shares [n, m] by Python-int Lagrange at 0 from the
    given t+1 parties (default: the last t+1)."""
    n = x.shape[0]
    parties = list(parties or range(n - t - 1, n))
    lam = _lam_int([j + 1 for j in parties], 0)
    v = limbs_to_ints(words(x))
    return [sum(l * int(v[j, c]) for l, j in zip(lam, parties)) * RINV % P
            for c in range(v.shape[1])]


# slots: (n, t) -> k of generate_bits, whose randousha has 2k slots; the
# randousha test draws 2k too, so both share the reference's op compiles.
# (4, 1, 8) is the reference's own test_generate_bits shape.
BITS_K = {(4, 1): 8, (7, 2): 3}


def _ref_randousha(n, t):
    k = 2 * BITS_K[n, t]
    ref = ref_off.randousha(RefSimBackend(n), n, t, k, jax.random.PRNGKey(1),
                            in_graph_fallback=False)
    return {"rt": np.asarray(ref[0].limbs), "r2t": np.asarray(ref[1].limbs),
            "ok": np.asarray(bool(ref[2])), **stored_draws(1, n, t, k)}


def _check_randousha(ref, n, t):
    k = 2 * BITS_K[n, t]
    draws = draws_of(ref)
    eager = offline.randousha(SimBackend(n), n, t, k, draws=draws,
                              device="cpu")
    prog = offline.sim_offline_jit("randousha", n, t, k, True,
                                   device="cpu")(draws=draws)
    for got in (eager, prog):
        assert got[0].shape == got[1].shape == (n, k * (n - 2 * t))
        assert np.array_equal(words(got[0]), ref["rt"])
        assert np.array_equal(words(got[1]), ref["r2t"])
        assert bool(got[2]) is bool(ref["ok"]) is True
    assert secrets_of(eager[0], t) == secrets_of(eager[1], 2 * t)


@pytest.mark.parametrize("n,t", SHAPES)
def test_randousha_word_equal_to_the_reference(n, t):
    _check_randousha(golden(f"randousha_{n}_{t}"), n, t)


@pytest.mark.slow
@pytest.mark.parametrize("n,t", SHAPES)
def test_randousha_vs_the_live_reference(n, t):
    _check_randousha(_ref_randousha(n, t), n, t)


def _ref_bits(n, t):
    k = BITS_K[n, t]
    ref_bits, ref_ok = ref_off.generate_bits(
        RefSimBackend(n), n, t, k, jax.random.PRNGKey(3),
        in_graph_fallback=False)
    return {"bits": np.asarray(ref_bits.limbs),
            "ok": np.asarray(bool(ref_ok)), **stored_draws(3, n, t, 2 * k)}


def _check_bits(ref, n, t):
    k = BITS_K[n, t]
    bits, ok = offline.generate_bits(SimBackend(n), n, t, k,
                                     draws=draws_of(ref), device="cpu")
    assert bits.shape == (n, k * (n - 2 * t))
    assert np.array_equal(words(bits), ref["bits"])
    assert bool(ok) is bool(ref["ok"]) is True
    vals = secrets_of(bits, t)
    assert set(vals) == {0, 1}


@pytest.mark.parametrize("n,t", SHAPES)
def test_generate_bits_word_equal_to_the_reference(n, t):
    _check_bits(golden(f"bits_{n}_{t}"), n, t)


@pytest.mark.slow
@pytest.mark.parametrize("n,t", SHAPES)
def test_generate_bits_vs_the_live_reference(n, t):
    _check_bits(_ref_bits(n, t), n, t)


GOLDEN = {**{f"randousha_{n}_{t}": (lambda n=n, t=t: _ref_randousha(n, t))
             for n, t in SHAPES},
          **{f"bits_{n}_{t}": (lambda n=n, t=t: _ref_bits(n, t))
             for n, t in SHAPES}}


@pytest.mark.slow
@pytest.mark.parametrize("n,t", SHAPES)
def test_generate_triples_word_equal_to_the_reference(n, t):
    """SLOW tier, as the reference's own test_generate_triples."""
    k = 4
    ref = ref_off.generate_triples(RefSimBackend(n), n, t, k,
                                   jax.random.PRNGKey(2),
                                   in_graph_fallback=False)
    got = offline.generate_triples(SimBackend(n), n, t, k,
                                   draws=reference_draws(2, n, t, 3 * k),
                                   device="cpu")
    for mine, theirs in zip(got[:3], ref[:3]):
        assert np.array_equal(words(mine), np.asarray(theirs.limbs))
    assert bool(got[3]) is bool(ref[3]) is True


@pytest.mark.parametrize("n,t,mode", [(4, 1, "eager"), (8, 2, "program"),
                                      (8, 2, "program_fallback")])
def test_generate_triples_multiply(n, t, mode):
    """ab = a*b for every triple, in Python ints, opened from two disjoint
    sets of t+1 parties; eager, as a detect-only program, and as a program
    with the three-kernel open and its fallback."""
    k = 4
    if mode == "eager":
        a, b, ab, ok = offline.generate_triples(SimBackend(n), n, t, k,
                                                (5, 6), device="cpu")
    else:
        a, b, ab, ok = offline.sim_offline_jit(
            "generate_triples", n, t, k, mode == "program_fallback",
            device="cpu")((5, 6))
    assert bool(ok) and a.shape == b.shape == ab.shape == (n, k * (n - 2 * t))
    for parties in (range(t + 1), None):
        va, vb, vab = (secrets_of(x, t, parties) for x in (a, b, ab))
        assert vab == [x * y % P for x, y in zip(va, vb)]
    assert len(set(va)) == len(va)


def test_unpacked_fused_triples_multiply():
    """sim_offline_jit("generate_triples") without the fallback is the
    fused pipeline with the flat mul_add_packed finish (packed=False)."""
    n, t, k = 8, 2, 128
    fn = offline.sim_offline_jit("generate_triples", n, t, k, device="cpu")
    a, b, ab, ok = fn((7, 8))
    assert bool(ok) and ab.shape == (n, k * (n - 2 * t))
    cols = list(range(0, k * (n - 2 * t), 37))
    sub = [FpArray(x.limbs[:, :, cols]) for x in (a, b, ab)]
    va, vb, vab = (secrets_of(x, t) for x in sub)
    assert vab == [x * y % P for x, y in zip(va, vb)]


BAD_DEALER_MODES = [(False, True), (True, False), (True, True)]


@pytest.mark.parametrize("in_program,fallback", BAD_DEALER_MODES)
def test_randousha_detects_bad_dealer(monkeypatch, in_program, fallback):
    """A dealer sharing different secrets at 2t than at t flips ok (the
    reference's test of the same name), eagerly and in a program, with and
    without the robust open."""
    n, t, k = 8, 2, 2
    orig = offline._deal_own

    def evil(enc, secrets, degree, key, hi=None):
        out = orig(enc, secrets, degree, key, hi)
        if degree == 2 * t:            # dealer 0 shares other secrets at 2t
            out = out.at_set((0,), FpArray(out.limbs[:, 0])
                             + FpArray.from_int(1, device="cpu"))
        return out

    honest = offline.randousha(SimBackend(n), n, t, k, (9, 9), fallback,
                               in_program, device="cpu")
    monkeypatch.setattr(offline, "_deal_own", evil)
    bad = offline.randousha(SimBackend(n), n, t, k, (9, 9), fallback,
                            in_program, device="cpu")
    assert bool(honest[2]) and not bool(bad[2])


def test_in_program_fallback_corrects_a_faulty_open():
    """A party sending wrong shares of a*b + r: the program with the
    robust three-kernel open returns the honest run's values (the Gao
    fallback corrected them) and still flips ok; detect-only flips ok."""
    n, t, k = 8, 2, 2

    def tamper(name, cols):
        if name != "ab_plus_r":
            return cols
        limbs = cols.limbs.clone()                # party 5's shares + 1
        limbs[:, 5] = (FpArray(limbs[:, 5])
                       + FpArray.from_int(1, device="cpu")).limbs
        return FpArray(limbs)

    fn = offline.sim_offline_jit("generate_triples", n, t, k, True,
                                 device="cpu")
    honest = fn((4, 4))
    faulty = fn((4, 4), tamper=tamper)
    assert bool(honest[3]) and not bool(faulty[3])
    for x, y in zip(honest[:3], faulty[:3]):
        assert torch.equal(x.limbs, y.limbs)
    eager = offline.generate_triples(SimBackend(n), n, t, k, (4, 4),
                                     device="cpu", tamper=tamper)
    assert not bool(eager[3])
    assert torch.equal(eager[2].limbs, honest[2].limbs)   # the host redo


def test_sim_offline_jit_routes_and_caches():
    n, t, k = 8, 2, 128
    fused = offline.sim_offline_jit("randousha", n, t, k, device="cpu")
    rt, r2, ok = fused((1, 1))
    assert bool(ok) and rt.shape == (n, k * (n - 2 * t))
    assert offline.sim_offline_jit("generate_bits", n, t, k,
                                   device="cpu").__name__ == "generate_bits"
    assert offline.sim_offline_jit("randousha", n, t, k, True,
                                   device="cpu").__name__ == "randousha"
    assert fused is offline.sim_offline_jit("randousha", n, t, k,
                                            device="cpu")
    with pytest.raises(KeyError):
        offline.sim_offline_jit("no_such_program", n, t, k, device="cpu")
    with pytest.raises(NotImplementedError):
        offline.randousha(object(), n, t, 1, (1, 1), device="cpu")
