"""Port parity for power-sum mixing (models/powermixing.py) at n=4, t=1 on
the CPU.

``compute_power_shares`` at k = 8 and ``power_mix`` run as programs
(tests/_runtime_parity.py) on pools dealt by the JAX package and loaded
into the port: the power shares' words and the mixed roots equal the JAX
package's (golden vectors ``rt_pm_*``; slow ``*_live_reference`` twins)
and the opened powers equal m^j in Python ints. The port alone: the
chunked coefficient rows give the same words at every chunk width, with
products and tree sums per chunk of j (at most k chunks), not per (j, l)
pair; the root finder built from ``native/hbmpc_native.cpp`` into the port's build
directory against its pure-Python twin ``find_roots_plain`` and both
against ``newton_inversion`` on known roots (k <= 16), the reference's
``newton_inversion`` and ``find_roots`` on the same sums; a failed build
raises."""

import os

import numpy as np
import pytest
import torch

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import ints, opened, port_run, ref_run, share_words
from honeybadgermpc_tpu_torch import _build
from honeybadgermpc_tpu_torch.models import powermixing as pm
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements

N, T = 4, 1
PK = 8
MSGS = ints(80, PK)


def prog_power_shares(ctx, api):
    m = api.share(share_words(1, ctx.n, ctx.t, MSGS))
    bp = ctx.from_preproc(ctx.preproc.get_powers(PK))
    mp = api.powermixing.compute_power_shares(ctx, m, bp)
    flat = ctx.ShareArray(mp.v.reshape(ctx.n, PK * PK), mp.t)
    return {"mp": mp, "open": ctx.open_share_array(flat)}


def check_power_shares(out):
    got = opened(out["open"])
    assert got == [pow(m, j, P) for m in MSGS for j in range(1, PK + 1)]


def prog_power_mix(ctx, api):
    m = api.share(share_words(2, ctx.n, ctx.t, MSGS))
    bp = ctx.from_preproc(ctx.preproc.get_powers(PK))
    return {"roots": api.powermixing.power_mix(ctx, m, bp)}


def check_power_mix(out):
    got = [int(sum(int(w) << (16 * i) for i, w in enumerate(out[k])))
           for k in sorted(out, key=lambda s: int(s.split(".")[1]))]
    assert got == sorted(MSGS)


CASES = {"power_shares": (prog_power_shares, check_power_shares),
         "power_mix": (prog_power_mix, check_power_mix)}


def _ref(op):
    return ref_run(N, T, lambda pre: pre.generate_powers(PK, PK),
                   CASES[op][0])


GOLDEN = {f"rt_pm_{op}_{N}_{T}": (lambda op=op: _ref(op)) for op in CASES}


def _check(ref, op, path):
    out, ctx = port_run(ref, N, T, CASES[op][0], path)
    CASES[op][1](out)
    assert ctx.nerr_total.tolist() == [0] * N


@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference(op, tmp_path):
    _check(golden(f"rt_pm_{op}_{N}_{T}"), op, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference_live_reference(op, tmp_path):
    _check(_ref(op), op, tmp_path)


# -- the port alone -----------------------------------------------------------

def _mix_inputs(k, seed):
    pre = PreProcessedElements(N, T, seed=seed, device="cpu")
    pre.generate_powers(k, k)
    ctx = MpcContext(N, T, preproc=pre, device="cpu")
    msgs = ints(seed, k)
    m = ctx.ShareArray(pre._share_values(FpArray.from_ints(msgs,
                                                           device="cpu")))
    return ctx, m, ctx.from_preproc(pre.get_powers(k)), msgs


@pytest.mark.parametrize("width", [1, 7, 40, 1 << 20])
def test_power_shares_equal_at_every_chunk_width(width, monkeypatch):
    """One j per chunk (width 1), ragged chunks and one chunk: the same
    words, the powers right, one open."""
    ctx, m, bp, msgs = _mix_inputs(9, 81)
    monkeypatch.setattr(pm, "CHUNK_ELEMENTS", width * N * 9)
    got = pm.compute_power_shares(ctx, m, bp)
    assert ctx.opened_count == 9
    monkeypatch.setattr(pm, "CHUNK_ELEMENTS", 1 << 25)
    want = pm.compute_power_shares(ctx, m, bp)
    assert torch.equal(got.v.limbs, want.v.limbs)
    vals = FpArray(got.open().limbs[:, 0]).to_ints()
    assert vals.tolist() == [[pow(x, j, P) for j in range(1, 10)]
                             for x in msgs]


@pytest.mark.parametrize("width", [1, 1 << 20])
def test_products_and_sums_grow_with_k_not_k_squared(width, monkeypatch):
    """Outside its one open, compute_power_shares multiplies and tree-sums
    per chunk of j: at most 2 products and one tree sum per chunk (k
    chunks at most) plus 2 per doubling of the powers of e, where the
    reference multiplies twice per (j, l) pair, k(k+1) times."""
    k = 16
    ctx, m, bp, _ = _mix_inputs(k, 85)
    monkeypatch.setattr(pm, "CHUNK_ELEMENTS", width * N * k)
    counts = {"mul": 0, "sum": 0}
    opening = [False]
    real_mul, real_sum, real_open = (FpArray.__mul__, pm._sum_last,
                                     ctx.open_share_array)

    def mul(a, b):
        counts["mul"] += not opening[0]
        return real_mul(a, b)

    def tree_sum(v):
        counts["sum"] += 1
        return real_sum(v)

    def open_(sa):
        opening[0] = True
        try:
            return real_open(sa)
        finally:
            opening[0] = False

    monkeypatch.setattr(FpArray, "__mul__", mul)
    monkeypatch.setattr(pm, "_sum_last", tree_sum)
    monkeypatch.setattr(ctx, "open_share_array", open_)
    pm.compute_power_shares(ctx, m, bp)
    chunks = len(list(pm._chunks(k, width)))
    assert chunks == (k if width == 1 else 1)
    assert counts["sum"] == chunks
    assert counts["mul"] <= 2 * chunks + 2 * 4


def test_chunks_cover_the_triangle():
    for k, width in ((1, 1), (9, 1), (9, 7), (64, 300), (256, 2048)):
        spans = list(pm._chunks(k, width))
        assert [j for a, b in spans for j in range(a, b + 1)] == \
            list(range(1, k + 1))
        assert all(a == b or (b - a + 1) * b <= width for a, b in spans)


def test_power_mix_uses_the_first_k_powers():
    """k messages against k powers-tuples of 2k powers: the mix takes the
    first k of each tuple (power_mix's slice)."""
    pre = PreProcessedElements(N, T, seed=82, device="cpu")
    pre.generate_powers(5, 10)
    ctx = MpcContext(N, T, preproc=pre, device="cpu")
    msgs = ints(82, 5)
    m = ctx.ShareArray(pre._share_values(FpArray.from_ints(msgs,
                                                           device="cpu")))
    assert pm.power_mix(ctx, m, ctx.from_preproc(pre.get_powers(5))) == \
        sorted(msgs)


@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_native_roots_equal_the_plain_twin(k):
    msgs = ints(83 + k, k)
    psums = [sum(pow(x, j, P) for x in msgs) % P for j in range(1, k + 1)]
    elem = pm.newton_inversion(psums, k)
    assert pm.find_roots(elem) == pm.find_roots_plain(elem) == sorted(msgs)


def test_roots_against_the_reference():
    """The reference's newton_inversion gives the same coefficients and its
    find_roots the same roots."""
    from honeybadgermpc_tpu.models import powermixing as ref
    msgs = ints(84, 12)
    psums = [sum(pow(x, j, P) for x in msgs) % P for j in range(1, 13)]
    elem = pm.newton_inversion(psums, 12)
    assert elem == ref.newton_inversion(psums, 12)
    assert pm.find_roots(elem) == ref.find_roots(elem) == sorted(msgs)


def test_native_is_built_into_the_port():
    """The root finder is the extension compiled into the port's build
    directory, not the JAX package's library."""
    mod = _build.native()
    assert os.path.dirname(os.path.abspath(mod.__file__)) == \
        os.path.abspath(_build.BUILD)
    assert "honeybadgermpc_tpu" + os.sep + "native" not in mod.__file__


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_SRC", str(bad))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_native", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        pm.find_roots([1])
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))
    np.testing.assert_equal(pm.find_roots_plain([5]), [5])
