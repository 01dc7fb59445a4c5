"""Port parity: the per-column verification of the fused RanSha / RanDouSha
pipeline (ops/fused_randousha.py, ``_randousha_calls(aggregate=False)``:
the full-band extraction and the per-column check) against the JAX package
on the CPU — its Pallas kernels ``_ke_kernel`` (agg=False) and
``_kc_kernel`` in interpret mode, at the shape tests/test_fused_randousha.py
runs them (n=8, t=2, 128 slots) — and against Python-int interpolation.
The reference's receive and check tensors are permuted into the port's
layout (interop.from_reference_receive, from_reference_check). Tolerance:
exact equality of every word, keep padding rows and check padding columns
included, and of every error count. The reference's stage outputs are
committed golden vectors (tests/_golden.py) in the fast tier; a slow test
computes them live and holds them equal to the stored ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fused_randousha as ref_fr
from honeybadgermpc_tpu_torch.interop import (from_reference_check,
                                              from_reference_receive,
                                              to_reference_key,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.fused_open import (_lam_int, pack_limbs,
                                                     unpack_limbs)
from honeybadgermpc_tpu_torch.ops.limbs import L, P, W, limbs_to_ints

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

N, T, K = 8, 2, 128
N_OUT, N_OUTP, NCHECK, NCHECKP = N - 2 * T, 8, 2 * T, 8
POINTS = tuple(range(1, N + 1))
KEY = (5, 6)
CPU = torch.device("cpu")
FLIP = (0, 1, 3, 17)        # word 0 of dealer 3's share for party 1, slot 17


def ints_of(packed):
    """Packed int32 [PL, ...] -> object array of Python ints (Montgomery
    form; interpolation is linear, so it works on these directly)."""
    return limbs_to_ints(unpack_limbs(packed).numpy().view(np.uint32))


def interpolate(shares, parties, x0=0):
    lam = _lam_int([j + 1 for j in parties], x0)
    return sum(l * int(shares[j]) for l, j in zip(lam, parties)) % P


def flip(cols, degree):
    """The port's twin of tests/test_fused_randousha.py:63-64's fault: add
    1 to one receive word at degree t."""
    if degree == T:
        cols = cols.clone()
        w, dst, src, slot = FLIP
        cols[w, dst, src, slot] += 1
    return cols


def _ref_stages():
    """The reference's per-column stages, honest and with the flip of
    tests/test_fused_randousha.py:63-64 (reference layout
    [nblk, njt, PL, n, JT, TBW]), flat: "meta" and "<name>.<stage>"."""
    run = ref_fr._randousha_calls(N, T, K, POINTS, aggregate=False)
    kd_t, kd_2, ke, kc_t, kc_2, e1w, e2w, enw, r1w, r2w = run.parts
    key = jnp.asarray(to_reference_key(KEY)).reshape(1, 2)
    out = {"meta": np.asarray(run.meta)}
    cols = {"t": kd_t(key, e1w), "2t": kd_2(key, e2w)}
    cols["bad"] = cols["t"].at[0, 0, 0, 3, 1, 17].add(jnp.uint32(1))
    for name, c in cols.items():
        keep, chk = ke(c, enw)
        vals, errs = (kc_2 if name == "2t" else kc_t)(
            chk, r2w if name == "2t" else r1w)
        for k, v in (("cols", c), ("keep", keep), ("chk", chk),
                     ("vals", vals), ("errs", errs)):
            out[f"{name}.{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's per-column stages (golden vectors), nested:
    ref["meta"], ref[name][stage]."""
    flat = golden("per_column_stages")
    out = {"meta": tuple(int(v) for v in flat.pop("meta"))}
    for key, arr in flat.items():
        name, stage = key.split(".")
        out.setdefault(name, {})[stage] = arr
    return out


@pytest.mark.slow
def test_golden_stages_equal_the_live_reference():
    live, stored = _ref_stages(), golden("per_column_stages")
    assert sorted(live) == sorted(stored)
    for key, arr in live.items():
        assert np.array_equal(arr, stored[key]), key


GOLDEN = {"per_column_stages": _ref_stages}


def ref_nerr(ref, deg_t="t", single=False):
    """The reference run's nerr (fused_randousha.py:510-521) from its
    stages: real check columns' errors, plus the cross-degree pairs."""
    et, e2 = ref[deg_t]["errs"], ref["2t"]["errs"]
    if single:
        return int(et[0, :NCHECK].sum())
    neq = int(np.any(ref[deg_t]["vals"][:, :NCHECK]
                     != ref["2t"]["vals"][:, :NCHECK], axis=0).sum())
    return int(et[0, :NCHECK].sum()) + int(e2[0, :NCHECK].sum()) + neq


@pytest.fixture(scope="module")
def port():
    run = fr._randousha_calls(N, T, K, POINTS, aggregate=False, device=CPU)
    kd_t, kd_2, ke, kc_t, kc_2 = run.parts
    cols = {"t": kd_t(KEY), "2t": kd_2(KEY)}
    cols["bad"] = flip(cols["t"], T)
    out = {"run": run}
    for name, c in cols.items():
        keep, chk = ke(c)
        vals, errs = (kc_2 if name == "2t" else kc_t)(chk)
        out[name] = {"cols": c, "keep": keep, "chk": chk, "vals": vals,
                     "errs": errs}
    return out


def test_meta_and_stages(ref, port):
    run = port["run"]
    assert run.meta == ref["meta"] == (N_OUT, N_OUTP, NCHECK, NCHECKP)
    assert len(run.parts) == 5 and run.folded_band is None


@pytest.mark.parametrize("deg", ["t", "2t", "bad"])
def test_receive_word_equal(ref, port, deg):
    assert torch.equal(port[deg]["cols"],
                       from_reference_receive(ref[deg]["cols"], "cpu"))


@pytest.mark.parametrize("deg", ["t", "2t", "bad"])
def test_extract_word_equal_padding_included(ref, port, deg):
    keep, chk = port[deg]["keep"], port[deg]["chk"]
    assert keep.dtype == chk.dtype == torch.int32
    assert tuple(keep.shape) == (8, N, N_OUTP, K)
    assert tuple(chk.shape) == (8, N, NCHECKP, K)
    assert np.array_equal(to_reference_packed(keep), ref[deg]["keep"])
    assert torch.equal(chk, from_reference_check(ref[deg]["chk"], "cpu"))
    # the two traps: keep padding rows are the first check columns, check
    # padding columns are zero
    assert torch.equal(keep[:, :, N_OUT:], chk[:, :, :N_OUTP - N_OUT])
    assert not chk[:, :, NCHECK:].any()


@pytest.mark.parametrize("deg", ["t", "2t", "bad"])
def test_check_word_equal(ref, port, deg):
    vals, errs = port[deg]["vals"], port[deg]["errs"]
    assert vals.dtype == errs.dtype == torch.int32
    assert tuple(vals.shape) == (8, NCHECKP, K)
    assert tuple(errs.shape) == (NCHECKP, K)
    assert np.array_equal(to_reference_packed(vals), ref[deg]["vals"])
    assert np.array_equal(errs.numpy(), ref[deg]["errs"][0])
    # padding columns decode to zero with zero errors
    assert not vals[:, NCHECK:].any() and not errs[NCHECK:].any()


def test_check_localizes_the_flipped_word(port):
    """Party 1 < k interpolates, so its wrong shares of slot 17 throw every
    validating party off in every real check column of that slot, and
    nothing else."""
    errs = port["bad"]["errs"]
    want = torch.zeros_like(errs)
    want[:NCHECK, 17] = N - (T + 1)
    assert torch.equal(errs, want)
    assert not port["t"]["errs"].any() and not port["2t"]["errs"].any()


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("tampered", [False, True])
def test_run_nerr_equals_the_reference(ref, port, single, tampered):
    run = fr._randousha_calls(N, T, K, POINTS, aggregate=False,
                              single=single, device=CPU)
    out = run(KEY, tamper=flip if tampered else None)
    nerr = out[-1]
    assert nerr.dim() == 0
    assert int(nerr) == ref_nerr(ref, "bad" if tampered else "t", single)
    assert (int(nerr) > 0) == tampered
    assert torch.equal(out[0], port["bad" if tampered else "t"]["keep"])
    if not single:
        assert torch.equal(out[1], port["2t"]["keep"])


def test_keep_rows_equal_the_aggregate_run(port):
    """The deal is the same in both modes, so the extracted sharings are
    too; only the rows above n_out differ."""
    agg = fr._randousha_calls(N, T, K, POINTS, aggregate=True, device=CPU)
    kt, k2, nerr = agg(KEY)
    assert int(nerr) == 0
    assert torch.equal(kt[:, :, :N_OUT], port["t"]["keep"][:, :, :N_OUT])
    assert torch.equal(k2[:, :, :N_OUT], port["2t"]["keep"][:, :, :N_OUT])


@pytest.mark.parametrize("deg", ["t", "2t"])
def test_check_values_python_ints(port, deg):
    """vals is the value at 0 of each check column, from the first k and
    from the last k parties alike; both degrees open the same values."""
    k = T + 1 if deg == "t" else 2 * T + 1
    chk, vals = ints_of(port[deg]["chk"]), ints_of(port[deg]["vals"])
    for c, s in ((0, 0), (1, 17), (NCHECK - 1, K - 1)):
        sh = chk[:, c, s]
        want = interpolate(sh, list(range(k)))
        assert int(vals[c, s]) == want
        assert interpolate(sh, list(range(N - k, N))) == want
    assert torch.equal(port["t"]["vals"][:, :NCHECK],
                       port["2t"]["vals"][:, :NCHECK])


def test_randousha_extract_of_the_reference_receive_tensor(ref, port):
    """The entry point fed the REFERENCE's dealt columns and the full band."""
    band = fr._encode_band_device(POINTS, N, CPU)[0]
    cols = from_reference_receive(ref["2t"]["cols"], "cpu")
    keep, chk = fr.randousha_extract(cols, band, N_OUT, N_OUTP, NCHECKP)
    assert np.array_equal(to_reference_packed(keep), ref["2t"]["keep"])
    assert torch.equal(chk, from_reference_check(ref["2t"]["chk"], "cpu"))
    vals, errs = fr.randousha_check(chk, 2 * T + 1, POINTS)
    assert np.array_equal(to_reference_packed(vals), ref["2t"]["vals"])
    assert np.array_equal(errs.numpy(), ref["2t"]["errs"][0])


def test_from_reference_check_is_the_layout_permutation():
    nblk, njt, jt, ncp, tbw = 2, 3, 8, 8, 4
    arr = np.arange(nblk * njt * 8 * jt * ncp * tbw, dtype=np.uint32)
    arr = arr.reshape(nblk, njt, 8, jt, ncp, tbw)
    got = from_reference_check(arr, "cpu")
    assert tuple(got.shape) == (8, njt * jt, ncp, nblk * tbw)
    for b, g, w, j, c, s in ((0, 0, 0, 0, 0, 0), (1, 2, 7, 5, 3, 2),
                             (1, 0, 4, 7, 7, 3)):
        assert int(got[w, g * jt + j, c, b * tbw + s]) == int(
            arr[b, g, w, j, c, s])


def _shift_dealer(cols, dealer, delta):
    """Add delta to every share dealer `dealer` dealt (port layout
    [PL, dst, src, sp]): the dealing of secret + delta with the same valid
    high part."""
    lim = unpack_limbs(cols[:, :, dealer])
    dv = FpArray.from_int(delta, device=CPU).limbs
    shifted = (FpArray(lim) + FpArray(dv.reshape((L,) + (1,) * (lim.dim()
                                                               - 1)))).limbs
    cols = cols.clone()
    cols[:, :, dealer] = pack_limbs(shifted)
    return cols


def test_known_rho_bypass_caught_per_column():
    """tests/test_fused_randousha.py:173-270 on the port: two colluding
    dealers who know rho shift their degree-2t secrets by delta1, delta2
    with delta1*S(d1) + delta2*S(d2) = 0, S(d) = sum_c rho_c x_c^d. The
    aggregated check passes the dealing; the per-column check catches it."""
    rho_limbs = fr._rho_plain(KEY, CPU)[:, :NCHECK].numpy().astype(np.int64)
    rho = [sum(int(rho_limbs[j, c]) << (W * j) for j in range(L))
           for c in range(NCHECK)]
    d1, d2 = 2, 5
    S = [sum(r * pow(POINTS[N_OUT + c], d, P) for c, r in enumerate(rho)) % P
         for d in (d1, d2)]
    assert S[0] and S[1]
    delta1 = 12345
    delta2 = (-delta1 * S[0] * pow(S[1], P - 2, P)) % P

    def collude(cols, degree):
        if degree == 2 * T:
            cols = _shift_dealer(_shift_dealer(cols, d1, delta1), d2, delta2)
        return cols

    agg = fr._randousha_calls(N, T, K, POINTS, aggregate=True, device=CPU)
    pc = fr._randousha_calls(N, T, K, POINTS, aggregate=False, device=CPU)
    assert int(agg(KEY)[2]) == 0 and int(pc(KEY)[2]) == 0
    assert int(agg(KEY, tamper=collude)[2]) == 0, \
        "bypass failed: the aggregate check caught the crafted dealing"
    assert int(pc(KEY, tamper=collude)[2]) > 0, \
        "the per-column check must catch the inconsistent secrets"
