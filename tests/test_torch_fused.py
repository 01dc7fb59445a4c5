"""Port parity for the fused program runner (runtime/fused.py) at n=4, t=1
with robust=False on the CPU, as the reference's own fixture runs it
(tests/test_fused_program.py).

Each case is a program (tests/_runtime_parity.py) run on pools dealt by
the JAX package and loaded into the port: the fused result, the eager one
and the demand words equal the JAX package's word for word (golden vectors
``rt_fu_*``; slow ``*_live_reference`` twins), and the opened values equal
Python ints. The cases are those of ``test_fused_program.py``: a
polynomial (fused against eager), a division, a Jubjub double, the scan's
squaring chain and cache reuse. The port alone: the counting pass takes
nothing from the dealer, the outer context's counters do not move, and at
robust=True a call whose argument shares one party falsified is replayed
detect-only, then redone eagerly with robust opens (``fused_redos``)."""

import numpy as np
import pytest
import torch

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import (ints, mont_words, opened, port_run, ref_run,
                             scalar, share_words)
from honeybadgermpc_tpu_torch.elliptic_curve import Point
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.parallel import reconstruct as rec
from honeybadgermpc_tpu_torch.parallel.mesh import SimBackend
from honeybadgermpc_tpu_torch.runtime import fused
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements

N, T = 4, 1
B = 8
STEPS = 5
XS = ints(80, B)
XS2 = ints(81, B)
YS = [v or 1 for v in ints(82, B)]
GP = (5, 6846412461894745224441235558443359243034138132682534265960483512729196124138)  # noqa: E501


def _poly(c, x):
    # x**3 + 2x (two sequential Beaver multiplies) opened at the end
    x2 = x * x
    x3 = x2 * x
    return (x3 + x * 2).open()


def _div(c, x, y):
    return (x / y).open()


def _want_poly(xs):
    return [(pow(v, 3, P) + 2 * v) % P for v in xs]


def _demand(api, ctx, prog, *args):
    d = api.fused.fused_demand(ctx, prog, *args)
    return [d.get(k, 0) for k in ("triples", "rands")]


def prog_poly(ctx, api):
    x = api.share(share_words(1, ctx.n, ctx.t, XS))
    before = ctx.opened_count
    demand = _demand(api, ctx, _poly, x)
    out_f = api.fused.run_fused(ctx, _poly, x)
    after = ctx.opened_count
    out_e = _poly(ctx, api.share(share_words(2, ctx.n, ctx.t, XS)))
    return {"fused": out_f, "eager": out_e, "demand": demand,
            "opened_count": [before, after]}


def check_poly(out):
    assert opened(out["fused"]) == _want_poly(XS)
    assert opened(out["eager"]) == _want_poly(XS)
    # the replay runs on an inner context: the outer one opened nothing
    assert scalar(out["opened_count.0"]) == scalar(out["opened_count.1"]) \
        == 0
    assert [scalar(out[f"demand.{i}"]) for i in (0, 1)] == [2 * B, 0]


def prog_division(ctx, api):
    x = api.share(share_words(3, ctx.n, ctx.t, XS))
    y = api.share(share_words(4, ctx.n, ctx.t, YS))
    return {"div": api.fused.run_fused(ctx, _div, x, y),
            "demand": _demand(api, ctx, _div, x, y)}


def check_division(out):
    assert opened(out["div"]) == [a * pow(b, P - 2, P) % P
                                  for a, b in zip(XS, YS)]


def prog_jubjub_double(ctx, api):
    SharedPoint = api.jubjub.SharedPoint

    def double(c, px, py):
        pt = SharedPoint(c, c.ShareArray(px.v, px.t),
                         c.ShareArray(py.v, py.t))
        out = pt.double()                 # 2 fused secure divisions
        return out.xs, out.ys

    px = api.share(share_words(5, ctx.n, ctx.t, [GP[0]] * B))
    py = api.share(share_words(6, ctx.n, ctx.t, [GP[1]] * B))
    ox, oy = api.fused.run_fused(ctx, double, px, py)
    return {"x": ox, "y": oy, "open": ctx.open_share_arrays([ox, oy])}


def check_jubjub_double(out):
    want = Point(*GP).double()
    assert opened(out["open.0"]) == [int(want.x)] * B
    assert opened(out["open.1"]) == [int(want.y)] * B


def _chain(api):
    def step(c, carry, ctr):
        (x,) = carry
        x2 = x * x
        return (x2 + api.FpArray(ctr[:, None]),)
    return step


def prog_scan_chain(ctx, api):
    x = api.share(share_words(7, ctx.n, ctx.t, XS))
    per_step = api.raw(np.ascontiguousarray(
        mont_words(list(range(1, STEPS + 1))).T))          # [STEPS, L]
    out, = api.fused.run_fused_scan(ctx, _chain(api), (x,), STEPS,
                                    per_step=per_step, auto_deal=True)
    return {"x": out, "open": out.open()}


def check_scan_chain(out):
    want = list(XS)
    for c in range(1, STEPS + 1):
        want = [(v * v + c) % P for v in want]
    assert opened(out["open"]) == want


def prog_cache_reuse(ctx, api):
    # a second call with the same shapes hits the cache and consumes
    # fresh preprocessing
    a = api.fused.run_fused(ctx, _poly,
                            api.share(share_words(8, ctx.n, ctx.t, XS)))
    b = api.fused.run_fused(ctx, _poly,
                            api.share(share_words(9, ctx.n, ctx.t, XS2)))
    return {"a": a, "b": b}


def check_cache_reuse(out):
    assert opened(out["a"]) == _want_poly(XS)
    assert opened(out["b"]) == _want_poly(XS2)


def _deal(pre):
    pre.generate_triples(256)
    pre.generate_rands(64)


CASES = {
    "poly": (prog_poly, check_poly),
    "division": (prog_division, check_division),
    "jubjub_double": (prog_jubjub_double, check_jubjub_double),
    "scan_chain": (prog_scan_chain, check_scan_chain),
    "cache_reuse": (prog_cache_reuse, check_cache_reuse),
}


def _ref(op):
    return ref_run(N, T, _deal, CASES[op][0], robust=False)


GOLDEN = {f"rt_fu_{op}_{N}_{T}": (lambda op=op: _ref(op)) for op in CASES}


def _check(ref, op, path):
    out, ctx = port_run(ref, N, T, CASES[op][0], path, robust=False)
    CASES[op][1](out)
    # the runner's inner contexts: the outer one's counters do not move
    assert ctx.nerr_total.tolist() == [0] * N
    if op == "cache_reuse":                 # both calls: one cache entry
        assert sum(k[0] is _poly for k in fused._CACHE) == 1


@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference(op, tmp_path):
    _check(golden(f"rt_fu_{op}_{N}_{T}"), op, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference_live_reference(op, tmp_path):
    _check(_ref(op), op, tmp_path)


# -- the port alone -----------------------------------------------------------

def _port_ctx(robust, seed=3):
    pre = PreProcessedElements(N, T, seed=seed, device="cpu")
    pre.generate_triples(64)
    return MpcContext(N, T, preproc=pre, device="cpu", robust=robust)


def _port_share(ctx, vals):
    return ctx.ShareArray(ctx.preproc._share_values(
        FpArray.from_ints(vals, device="cpu")))


def test_counting_pass_takes_nothing_from_the_dealer():
    ctx = _port_ctx(robust=False)
    x = _port_share(ctx, XS)
    have = ctx.preproc._pool("triples").remaining()
    demand = fused.fused_demand(ctx, _poly, x)
    assert demand == {"triples": 2 * B}
    assert ctx.preproc._pool("triples").remaining() == have
    out = fused.run_fused(ctx, _poly, x)
    assert ctx.preproc._pool("triples").remaining() == have - 2 * B
    assert opened_ints(out) == _want_poly(XS)
    assert ctx.opened_count == 0
    assert ctx.nerr_total.tolist() == [0] * N


def opened_ints(fp):
    return [int(v) for v in fp.to_ints()[0]]


def _mul_open(c, x, y):
    return (x * y).open()


def test_a_lying_party_is_redone_eagerly_with_robust_opens():
    """robust=True, party 2's argument shares falsified: the replay's
    detect-only opens tally the mismatch, the runner redoes the call with
    robust opens (the Gao redo) from the same tape, and the result equals
    the honest oracle and the eager robust run; an honest call is not
    redone."""
    ctx = _port_ctx(robust=True)
    x, y = _port_share(ctx, XS), _port_share(ctx, YS)
    bad = ctx.ShareArray(rec.inject_share_faults(
        x.v, SimBackend(N).my_ids("cpu"), [2], (18, 1)))
    assert not torch.equal(bad.v.limbs, x.v.limbs)
    want = [a * b % P for a, b in zip(XS, YS)]
    redos = fused.fused_redos
    honest = fused.run_fused(ctx, _mul_open, x, y)
    assert fused.fused_redos == redos
    got = fused.run_fused(ctx, _mul_open, bad, y)
    assert fused.fused_redos == redos + 1
    eager = _mul_open(ctx, bad, y)
    assert opened_ints(honest) == opened_ints(got) == opened_ints(eager) \
        == want
    assert torch.equal(got.limbs, eager.limbs)
    # the replays ran on inner contexts; only the eager run (its Beaver
    # open of 2B and the open of B) counts on the outer one
    assert ctx.opened_count == 3 * B


def _chain_step(c, carry, ctr):
    (x,) = carry
    return (x * x + FpArray(ctr[:, None]),)


def test_one_scan_step_serves_every_number_of_steps():
    """The step is counted (and on the card captured) once per carry
    shape, whatever the number of steps: scans of 2 and 5 steps share one
    cache entry and both equal the chain in Python ints."""
    ctx = _port_ctx(robust=False)
    x = _port_share(ctx, XS)
    ctrs = torch.from_numpy(np.ascontiguousarray(
        mont_words(list(range(1, STEPS + 1))).T).view(np.int32))
    for steps in (2, STEPS):
        out, = fused.run_fused_scan(ctx, _chain_step, (x,), steps,
                                    per_step=ctrs[:steps], auto_deal=True)
        want = list(XS)
        for c in range(1, steps + 1):
            want = [(v * v + c) % P for v in want]
        assert opened_ints(out.open()) == want
    assert sum(k[1] is _chain_step for k in fused._CACHE
               if k[0] == "scan") == 1


def test_pinned_constants_outlive_the_constant_cache():
    """A captured graph reads its public constants by address, and the
    bounded LRU cache of ``scalar_const`` may drop and free them: every
    constant handed out while a capture runs is kept in the dict
    ``pin_constants`` yields (the cache entry holds it as long as its
    graph), and keeps its words after the cache is cleared."""
    from honeybadgermpc_tpu_torch.ops import fparray
    ctx = _port_ctx(robust=False)
    x = _port_share(ctx, XS)
    with fparray.pin_constants() as outer:
        with fparray.pin_constants() as pins:
            _poly(ctx, x)                       # x * 2: the constant 2
        two = fparray.scalar_const(2, ctx.device)
    assert any(t is two for t in pins.values())
    assert set(outer) >= set(pins)              # nested blocks reach out
    assert fparray._pins is None
    fparray._scalar_const.cache_clear()
    assert fparray.scalar_const(2, ctx.device) is not two
    assert two.numpy().view(np.uint32).tolist() == \
        mont_words([2])[:, 0].tolist()
