"""Port parity for secure fixed-point arithmetic (models/fixedpoint.py) at
n=4, t=1 on the CPU.

Each case is a program (tests/_runtime_parity.py) run on pools dealt by
the JAX package and loaded into the port: the port's output shares and
opened words equal the JAX package's word for word (golden vectors
``rt_fx_*``; slow ``*_live_reference`` twins), and the opened values agree
with float and int oracles. The building blocks at odd and even lengths of
the carry tree (``get_carry_bit`` at m = 6 and 7, ``bit_ltl`` at m = 5 and
7, ``div2m`` at m = 17 and 32, ``trunc`` at m = 31 and 63, ``trunc_pr``),
then the seven cases of the reference's ``tests/test_fixedpoint.py``,
mirrored with the same values and tolerances (its random grid drawn from
a numpy seed)."""

import numpy as np
import pytest

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import (ints, mont_words, opened, port_run, ref_run,
                             share_words)
from honeybadgermpc_tpu_torch.models.fixedpoint import (
    F, K, _mod_2m, from_fixed_point_repr, to_fixed_point_repr)
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P

N, T = 4, 1
_rng = np.random.default_rng(70)
SIGNED = [int(v) for v in _rng.integers(-(1 << 62), 1 << 62, 4)]
BITS_A = _rng.integers(0, 2, (4, 7)).tolist()
BITS_B = _rng.integers(0, 2, (4, 7)).tolist()
PUB_A = [int(v) for v in _rng.integers(0, 1 << 7, 4)]
GRID_A = (_rng.random(3) * 100).tolist()
GRID_B = (_rng.random(3) * -100).tolist()
ULP = 2.0 ** -32
EDGES = [5 << 32, (5 << 32) + 1, (6 << 32) - 1]
LT_BOUND = (P - 1) // 2
LT_PAIRS = [(5, 9), (1 << 100, (1 << 100) + 1), (LT_BOUND - 2, 3), (7, 7)]


def _signed(v):
    """An opened field element as a signed int (above p/2: negative)."""
    return v - P if v > P // 2 else v


def floats(words):
    return [from_fixed_point_repr(v) for v in opened(words)]


def _shares(api, ctx, seed, vals):
    return api.share(share_words(seed, ctx.n, ctx.t, [v % P for v in vals]))


# -- the building blocks ------------------------------------------------------

def prog_trunc_pr(ctx, api):
    fx = api.fixedpoint
    prods = [to_fixed_point_repr(a) * to_fixed_point_repr(b)
             for a, b in zip(GRID_A, GRID_B)]
    x = _shares(api, ctx, 1, prods)
    y = _shares(api, ctx, 2, SIGNED)
    p1 = fx.trunc_pr(ctx, x, 2 * K, F)
    p2 = fx.trunc_pr(ctx, y, K, 13)
    return {"p1": p1, "p2": p2, "open": ctx.open_share_arrays([p1, p2])}


def check_trunc_pr(out):
    prods = [to_fixed_point_repr(a) * to_fixed_point_repr(b)
             for a, b in zip(GRID_A, GRID_B)]
    for got, vals, m in ((out["open.0"], prods, F),
                         (out["open.1"], SIGNED, 13)):
        for g, v in zip(opened(got), vals):
            assert _signed(g) - (v >> m) in (0, 1)      # floor or one above


def prog_carry(ctx, api):
    fx = api.fixedpoint
    a = api.share(share_words(3, ctx.n, ctx.t, [r[:6] for r in BITS_A]))
    b = api.share(share_words(4, ctx.n, ctx.t, [r[:6] for r in BITS_B]))
    a7 = api.share(share_words(5, ctx.n, ctx.t, BITS_A))
    b7 = api.share(share_words(6, ctx.n, ctx.t, BITS_B))
    c6 = fx.get_carry_bit(ctx, a, b, 1)               # 7 elements: odd
    c7 = fx.get_carry_bit(ctx, a7, b7, 0)             # 8 elements: even
    return {"c6": c6, "c7": c7, "open": ctx.open_share_arrays([c6, c7])}


def _int(bits):
    return sum(b << i for i, b in enumerate(bits))


def check_carry(out):
    for key, m, low in (("open.0", 6, 1), ("open.1", 7, 0)):
        want = [(_int(a[:m]) + _int(b[:m]) + low) >> m
                for a, b in zip(BITS_A, BITS_B)]
        assert opened(out[key]) == want


def prog_bit_ltl(ctx, api):
    fx = api.fixedpoint
    outs = []
    for seed, m in ((7, 5), (8, 7)):
        b = api.share(share_words(seed, ctx.n, ctx.t,
                                  [r[:m] for r in BITS_B]))
        a = api.fp(mont_words([v % (1 << m) for v in PUB_A]))
        outs.append(fx.bit_ltl(ctx, a, b))
    return {"lt5": outs[0], "lt7": outs[1],
            "open": ctx.open_share_arrays(outs)}


def check_bit_ltl(out):
    for key, m in (("open.0", 5), ("open.1", 7)):
        want = [int(a % (1 << m) < _int(b[:m]))      # [public < shared]
                for a, b in zip(PUB_A, BITS_B)]
        assert opened(out[key]) == want


def prog_div2m(ctx, api):
    fx = api.fixedpoint
    x = _shares(api, ctx, 9, SIGNED)
    r17 = fx.div2m(ctx, x, K, 17)                     # 18 elements
    r32 = fx.div2m(ctx, x, K, 32)                     # 33 elements
    return {"r17": r17, "r32": r32, "open": ctx.open_share_arrays([r17, r32])}


def check_div2m(out):
    assert opened(out["open.0"]) == [v % (1 << 17) for v in SIGNED]
    assert opened(out["open.1"]) == [v % (1 << 32) for v in SIGNED]


def prog_trunc(ctx, api):
    fx = api.fixedpoint
    x = _shares(api, ctx, 10, SIGNED)
    q31 = fx.trunc(ctx, x, K, 31)
    q63 = fx.trunc(ctx, x, K, K - 1)                  # ltz's: 64 elements
    return {"q31": q31, "q63": q63, "open": ctx.open_share_arrays([q31, q63])}


def check_trunc(out):
    assert [_signed(v) for v in opened(out["open.0"])] == \
        [v >> 31 for v in SIGNED]
    assert [_signed(v) for v in opened(out["open.1"])] == \
        [v >> 63 for v in SIGNED]


# -- the reference's tests/test_fixedpoint.py, mirrored -----------------------

def prog_add_sub_mul_open(ctx, api):
    fx = api.fixedpoint
    a = fx.FixedPointArray(ctx, [2.5, -3.8, 0.25])
    b = fx.FixedPointArray(ctx, [-3.8, 1.5, 4.0])
    s, d, m = a + b, a - b, a * b
    return {"a": a.share, "b": b.share, "prod": m.share,
            "open": ctx.open_share_arrays([a.share, s.share, d.share,
                                           m.share])}


def check_add_sub_mul_open(out):
    assert np.allclose(floats(out["open.0"]), [2.5, -3.8, 0.25])
    assert np.allclose(floats(out["open.1"]), [-1.3, -2.3, 4.25])
    assert np.allclose(floats(out["open.2"]), [6.3, -5.3, -3.75])
    # trunc_pr introduces up to 1 ulp of error
    assert np.allclose(floats(out["open.3"]), [-9.5, -5.7, 1.0],
                       atol=2 ** -30)


def prog_neg_div(ctx, api):
    fx = api.fixedpoint
    a = fx.FixedPointArray(ctx, [2.5, -1.25])
    ng, dv = a.neg(), a.div(2)
    return {"neg": ng.share, "div": dv.share,
            "open": ctx.open_share_arrays([ng.share, dv.share])}


def check_neg_div(out):
    assert np.allclose(floats(out["open.0"]), [-2.5, 1.25])
    assert np.allclose(floats(out["open.1"]), [1.25, -0.625], atol=2 ** -30)


def prog_lt(ctx, api):
    fx = api.fixedpoint
    a = fx.FixedPointArray(ctx, [2.5, -3.8])
    b = fx.FixedPointArray(ctx, [-3.8, 1.5])
    ab, ba = a.lt(b), b.lt(a)
    return {"ab": ab, "ba": ba, "open": ctx.open_share_arrays([ab, ba])}


def check_lt(out):
    assert opened(out["open.0"]) == [0, 1]
    assert opened(out["open.1"]) == [1, 0]


def prog_grid(ctx, api):
    fx = api.fixedpoint
    a = fx.FixedPointArray(ctx, GRID_A)
    b = fx.FixedPointArray(ctx, GRID_B)
    d = fx.FixedPointArray(ctx, [10.0, -7.5, 0.375])
    res = [a, b, a + b, a - b, a * b, d.div(4), d.div(-2), d.div(0.5)]
    return {"prod": res[4].share,
            "open": ctx.open_share_arrays([r.share for r in res])}


def check_grid(out):
    a, b = np.array(GRID_A), np.array(GRID_B)
    want = [(a, 1e-4), (b, 1e-4), (a + b, 1e-4), (a - b, 1e-4),
            (a * b, 1e-3), ([2.5, -1.875, 0.09375], 1e-3),
            ([-5.0, 3.75, -0.1875], 1e-3), ([20.0, -15.0, 0.75], 1e-3)]
    for i, (w, atol) in enumerate(want):
        assert np.allclose(floats(out[f"open.{i}"]), w, atol=atol), i


def prog_ltz_boundaries(ctx, api):
    a = api.fixedpoint.FixedPointArray(ctx, [0.0, ULP, -ULP])
    z = a.ltz()
    return {"ltz": z, "open": ctx.open_share_array(z)}


def check_ltz_boundaries(out):
    assert opened(out["open"]) == [0, 0, 1]


def prog_trunc_div2m_edges(ctx, api):
    fx = api.fixedpoint
    zero = ctx.from_preproc(ctx.preproc.get_zeros(len(EDGES)))
    x = ctx.ShareArray(zero.v + api.fp(mont_words(EDGES)), zero.t)
    q, r = fx.trunc(ctx, x, K, 32), fx.div2m(ctx, x, K, 32)
    return {"q": q, "r": r, "open": ctx.open_share_arrays([q, r])}


def check_trunc_div2m_edges(out):
    assert opened(out["open.0"]) == [5, 5, 5]
    assert opened(out["open.1"]) == [0, 1, (1 << 32) - 1]


def prog_less_than_field(ctx, api):
    api.comparison.install(ctx)
    sx = _shares(api, ctx, 11, [a for a, _ in LT_PAIRS])
    sy = _shares(api, ctx, 12, [b for _, b in LT_PAIRS])
    lt = sx < sy
    return {"lt": lt, "open": ctx.open_share_array(lt)}


def check_less_than_field(out):
    assert opened(out["open"]) == [int(a < b) for a, b in LT_PAIRS]


def _deal(pre):
    pre.generate_triples(4096)
    pre.generate_bits(3072)
    pre.generate_zeros(32)
    pre.generate_share_bits(8)


CASES = {
    "trunc_pr": (prog_trunc_pr, check_trunc_pr),
    "carry": (prog_carry, check_carry),
    "bit_ltl": (prog_bit_ltl, check_bit_ltl),
    "div2m": (prog_div2m, check_div2m),
    "trunc": (prog_trunc, check_trunc),
    "add_sub_mul_open": (prog_add_sub_mul_open, check_add_sub_mul_open),
    "neg_div": (prog_neg_div, check_neg_div),
    "lt": (prog_lt, check_lt),
    "grid": (prog_grid, check_grid),
    "ltz_boundaries": (prog_ltz_boundaries, check_ltz_boundaries),
    "trunc_div2m_edges": (prog_trunc_div2m_edges, check_trunc_div2m_edges),
    "less_than_field": (prog_less_than_field, check_less_than_field),
}


def _ref(op):
    return ref_run(N, T, _deal, CASES[op][0])


GOLDEN = {f"rt_fx_{op}_{N}_{T}": (lambda op=op: _ref(op)) for op in CASES}


def _check(ref, op, path):
    out, ctx = port_run(ref, N, T, CASES[op][0], path)
    CASES[op][1](out)
    assert ctx.nerr_total.tolist() == [0] * N


@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference(op, tmp_path):
    _check(golden(f"rt_fx_{op}_{N}_{T}"), op, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference_live_reference(op, tmp_path):
    _check(_ref(op), op, tmp_path)


# -- the port alone -----------------------------------------------------------

@pytest.mark.parametrize("m", [1, 15, 16, 17, 32, 63, 64, 255])
def test_mod_2m_masks_the_plain_limbs(m):
    """_mod_2m keeps the low m bits of the plain value (the limb that holds
    bit m keeps m mod 16 bits) and returns Montgomery words."""
    vals = ints(13, 6)
    got = _mod_2m(FpArray.from_ints(vals, device="cpu"), m).to_ints()
    assert got.tolist() == [v % (1 << m) for v in vals]


def test_fixed_point_repr_round_trip():
    for x in (0.0, 2.5, -3.8, ULP, -ULP, 123456.789):
        v = to_fixed_point_repr(x) % P
        assert abs(from_fixed_point_repr(v) - x) <= 2 ** -F
