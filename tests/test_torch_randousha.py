"""Port parity: the fused RanSha / RanDouSha pipeline, stage by stage and as
a whole (ops/fused_randousha.py), against the JAX package on the CPU — its
Pallas kernels in interpret mode, as tests/test_fused_randousha.py runs
them (n=8, t=2, 128 slots) — and against Python-int Lagrange interpolation.
The reference's receive tensor is permuted into the port's layout
(interop.from_reference_receive). Tolerance: exact equality of every word,
padding rows included, and of the ok flag. The reference's stage outputs
are committed golden vectors (tests/_golden.py) in the fast tier; a slow
test computes them live and holds them equal to the stored ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fused_randousha as ref_fr
from honeybadgermpc_tpu_torch.interop import (from_reference_receive,
                                              to_reference_key,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
from honeybadgermpc_tpu_torch.ops.fused_open import _lam_int, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import P, limbs_to_ints

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

N, T, K = 8, 2, 128
N_OUT, N_OUTP = N - 2 * T, 8
POINTS = tuple(range(1, N + 1))
KEY = (5, 6)
CPU = torch.device("cpu")


def ints_of(packed):
    """Packed int32 [PL, ...] -> object array of Python ints (Montgomery
    form; interpolation is linear, so degree and secret checks work on
    Montgomery-form values directly)."""
    return limbs_to_ints(unpack_limbs(packed).numpy().view(np.uint32))


def interpolate(shares, parties, x0=0):
    """Python-int Lagrange: value at x0 of the polynomial through the given
    parties' shares (party j sits at point j+1)."""
    lam = _lam_int([j + 1 for j in parties], x0)
    return sum(l * int(shares[j]) for l, j in zip(lam, parties)) % P


def _ref_stages():
    """Every stage of the reference, and its two entry points."""
    run = ref_fr._randousha_calls(N, T, K, POINTS, aggregate=True)
    kd_t, kd_2, ke, _, _, e1w, e2w, *_ = run.parts
    key = jnp.asarray(to_reference_key(KEY))
    cols_t = kd_t(key.reshape(1, 2), e1w)
    cols_2t = kd_2(key.reshape(1, 2), e2w)
    band = run.folded_band(key)
    keep_t, z_t = ke(cols_t, band)
    keep_2t, z_2t = ke(cols_2t, band)
    rt, r2, ok2 = ref_fr.sim_randousha_fused(key, N, T, K)
    ra, oka = ref_fr.sim_ransha_fused(key, N, T, K)
    out = {"cols_t": cols_t, "cols_2t": cols_2t, "keep_t": keep_t,
           "z_t": z_t, "keep_2t": keep_2t, "z_2t": z_2t, "rt": rt,
           "r2t": r2, "ok_randousha": bool(ok2), "ra": ra,
           "ok_ransha": bool(oka)}
    return {name: np.asarray(v) for name, v in out.items()}


@pytest.fixture(scope="module")
def ref():
    """Every stage of the reference (golden vectors)."""
    return golden("randousha_stages")


@pytest.mark.slow
def test_golden_stages_equal_the_live_reference(ref):
    live = _ref_stages()
    assert sorted(live) == sorted(ref)
    for name, arr in live.items():
        assert np.array_equal(arr, ref[name]), name


GOLDEN = {"randousha_stages": _ref_stages}


@pytest.fixture(scope="module")
def port():
    run = fr._randousha_calls(N, T, K, POINTS, device=CPU)
    kd_t, kd_2, ke = run.parts
    cols_t, cols_2t = kd_t(KEY), kd_2(KEY)
    band = run.folded_band(KEY)
    keep_t, z_t = ke(cols_t, band)
    keep_2t, z_2t = ke(cols_2t, band)
    return {"run": run, "cols_t": cols_t, "cols_2t": cols_2t, "band": band,
            "keep_t": keep_t, "z_t": z_t, "keep_2t": keep_2t, "z_2t": z_2t}


@pytest.mark.parametrize("deg", ["t", "2t"])
def test_deal_word_equal_after_the_layout_permutation(ref, port, deg):
    want = from_reference_receive(ref["cols_" + deg], "cpu")
    got = port["cols_" + deg]
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, N, N, K)
    assert torch.equal(got, want)


def test_deal_slot_window_equals_the_slice(port):
    """The plain deal over a slot window is that slice of the full tensor
    (how the kernel is compared at full width on a card)."""
    for degree, name in ((T, "cols_t"), (2 * T, "cols_2t")):
        win = fr._randousha_deal_plain(KEY, N, T, degree, K, POINTS, CPU,
                                       slot0=37, nslot=11)
        assert torch.equal(win, port[name][..., 37:48])


@pytest.mark.parametrize("deg", ["t", "2t"])
def test_extract_word_equal_pad_rows_included(ref, port, deg):
    keep, z = port["keep_" + deg], port["z_" + deg]
    assert tuple(keep.shape) == (8, N, N_OUTP, K)
    assert tuple(z.shape) == (8, N, K)
    assert np.array_equal(to_reference_packed(keep), ref["keep_" + deg])
    assert np.array_equal(to_reference_packed(z), ref["z_" + deg])
    assert torch.equal(keep[:, :, N_OUT], z)          # the check sharing
    assert not keep[:, :, N_OUT + 1:].any()           # zero sharings


def test_extract_of_the_reference_receive_tensor(ref, port):
    """The port's extraction fed the REFERENCE's dealt columns."""
    cols = from_reference_receive(ref["cols_t"], "cpu")
    keep, z = fr.randousha_extract(cols, port["band"][0], N_OUT, N_OUTP)
    assert np.array_equal(to_reference_packed(keep), ref["keep_t"])
    assert np.array_equal(to_reference_packed(z), ref["z_t"])


def test_dealt_polynomials_python_ints(port):
    """Degree bounds and the shared secret: dealer src's shares to the n
    parties lie on a polynomial of degree t (resp. 2t), and both degrees
    share the same value at 0."""
    ct, c2 = ints_of(port["cols_t"]), ints_of(port["cols_2t"])
    for src, slot in ((0, 0), (3, 17), (7, 127)):
        st, s2 = ct[:, src, slot], c2[:, src, slot]       # over dst
        base_t, base_2 = list(range(T + 1)), list(range(2 * T + 1))
        for z in range(T + 1, N):
            assert interpolate(st, base_t, z + 1) == int(st[z])
        for z in range(2 * T + 1, N):
            assert interpolate(s2, base_2, z + 1) == int(s2[z])
        # degree 2t is not degree t (the high part is random)
        assert interpolate(s2, base_t, N) != int(s2[N - 1])
        assert interpolate(st, base_t) == interpolate(s2, base_2)


def test_extracted_sharings_python_ints(port):
    """Every extracted column is a degree-t (2t) sharing with the same
    secret at both degrees; the zero rows are zero sharings."""
    kt, k2 = ints_of(port["keep_t"]), ints_of(port["keep_2t"])
    secrets = set()
    for row, slot in ((0, 0), (1, 5), (N_OUT - 1, 127), (N_OUT, 64)):
        st, s2 = kt[:, row, slot], k2[:, row, slot]
        sec = interpolate(st, list(range(T + 1)))
        assert interpolate(st, list(range(N - T - 1, N))) == sec
        assert interpolate(s2, list(range(2 * T + 1))) == sec
        assert interpolate(s2, list(range(N - 2 * T - 1, N))) == sec
        secrets.add(sec)
    assert len(secrets) == 4


@pytest.fixture(scope="module")
def ref_outputs(ref):
    return (ref["rt"], ref["r2t"], bool(ref["ok_randousha"]), ref["ra"],
            bool(ref["ok_ransha"]))


def test_sim_randousha_fused_vs_reference(ref, ref_outputs):
    rt, r2, ok = fr.sim_randousha_fused(KEY, N, T, K, device=CPU)
    assert tuple(rt.shape) == (8, N, N_OUT * K)
    assert ok.dtype == torch.bool and ok.dim() == 0
    assert bool(ok) is ref_outputs[2] is True
    assert np.array_equal(to_reference_packed(rt), ref_outputs[0])
    assert np.array_equal(to_reference_packed(r2), ref_outputs[1])
    pt, p2, okp = fr.sim_randousha_fused(KEY, N, T, K, padded=True,
                                         device=CPU)
    assert bool(okp)
    assert np.array_equal(to_reference_packed(pt), ref["keep_t"])
    assert np.array_equal(to_reference_packed(p2), ref["keep_2t"])


def test_sim_ransha_fused_vs_reference(ref, ref_outputs):
    ra, ok = fr.sim_ransha_fused(KEY, N, T, K, device=CPU)
    assert bool(ok) is ref_outputs[4] is True
    assert np.array_equal(to_reference_packed(ra), ref_outputs[3])
    pa, okp = fr.sim_ransha_fused(KEY, N, T, K, padded=True, device=CPU)
    assert bool(okp)
    assert np.array_equal(to_reference_packed(pa), ref["keep_t"])


def test_slot_count_not_a_multiple_of_the_tile():
    """k = 100 runs on sp = 128 slots; the flat outputs keep the first 100
    of every stripe; the padded form is refused."""
    rt, r2, ok = fr.sim_randousha_fused(KEY, N, T, 100, device=CPU)
    full, _, _ = fr.sim_randousha_fused(KEY, N, T, K, device=CPU)
    assert bool(ok) and tuple(rt.shape) == (8, N, N_OUT * 100)
    assert torch.equal(rt.reshape(8, N, N_OUT, 100),
                       full.reshape(8, N, N_OUT, K)[..., :100])
    with pytest.raises(AssertionError):
        fr.sim_ransha_fused(KEY, N, T, 100, padded=True, device=CPU)


@pytest.mark.parametrize("degree,word,dst,src,slot",
                         [(T, 0, 1, 3, 17), (2 * T, 7, 6, 0, 127),
                          (T, 4, 0, 7, 0)])
def test_flipped_receive_word_flips_ok(degree, word, dst, src, slot):
    def tamper(cols, deg):
        if deg == degree:
            cols[word, dst, src, slot] ^= 1
        return cols

    *_, ok = fr.sim_randousha_fused(KEY, N, T, K, device=CPU, tamper=tamper)
    assert not bool(ok)
    if degree == T:
        _, ok1 = fr.sim_ransha_fused(KEY, N, T, K, device=CPU, tamper=tamper)
        assert not bool(ok1)


def test_cross_degree_inequality_flips_ok(port):
    """Degree-valid dealings whose secrets differ between the degrees pass
    both degree checks and are caught by the cross-degree comparison: the
    2t dealing is replaced by another key's (valid) one."""
    other = port["run"].parts[1]((9, 9))

    def tamper(cols, deg):
        return other if deg == 2 * T else cols

    run = port["run"]
    keep_t, keep_2t, nerr = run(KEY, tamper=tamper)
    assert int(nerr) > 0
    _, _, nerr0 = run(KEY)
    assert int(nerr0) == 0 and nerr0.dim() == 0


def test_deal_and_extract_check_their_input(port):
    with pytest.raises(ValueError):
        fr.randousha_deal(KEY, N, T, 3, K, POINTS, CPU)        # degree
    with pytest.raises(ValueError):
        fr.randousha_deal(KEY, N, T, T, 100, POINTS, CPU)      # sp
    cols, band = port["cols_t"], port["band"][0]
    with pytest.raises(ValueError):
        fr.randousha_extract(cols[..., ::2], band, N_OUT, N_OUTP)
    with pytest.raises(ValueError):
        fr.randousha_extract(cols, band.to(torch.int32), N_OUT, N_OUTP)
    with pytest.raises(ValueError):
        fr.randousha_extract(cols, band[:32 * N_OUT], N_OUT, N_OUTP)
