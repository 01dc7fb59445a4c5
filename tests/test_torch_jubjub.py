"""Port parity for Jubjub shared-point arithmetic (models/jubjub.py) and the
MiMC-Jubjub public-key cryptosystem (models/mimc_jubjub_pkc.py) at n=4,
t=1 with robust=False on the CPU.

Each case is a program (tests/_runtime_parity.py) run on pools dealt by
the JAX package and loaded into the port: the output shares and opened
words equal the JAX package's word for word (golden vectors ``rt_jj_*``;
slow ``*_live_reference`` twins), and the opened points equal the host
curve oracle. The cases are the Jubjub tests of the reference's
``tests/test_jubjub_comparison.py:42-80`` (add, double, neg and sub;
``mul`` for k in {0, 1, 2, 5, 64}; ``montgomery_mul(13)``; an 8-bit
``share_mul``), ``jubjub_mul_jit`` with a 4-step scalar (13) on two
distinct points, and the PKC round trip of ``test_misc_parity.py:101-117``
with an 8-bit key. The port alone: ``share_mul`` with an odd number of
key bits (which the reference cannot fold, ROADMAP Queue C), and the
CPU's host inversion against the chain of multiplies the card runs."""

import numpy as np
import pytest
import torch

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import (ints, opened, port_run, ref_run, scalar,
                             share_words)
from honeybadgermpc_tpu_torch.elliptic_curve import Point
from honeybadgermpc_tpu_torch.models.jubjub import SharedPoint, share_mul
from honeybadgermpc_tpu_torch.ops import montgomery as mont
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements

N, T = 4, 1
# the reference's standard test point (tests/progs/test_jubjub.py:23-27)
TEST_POINT = (5, 6846412461894745224441235558443359243034138132682534265960483512729196124138)  # noqa: E501
KS = (0, 1, 2, 5, 64)
SCALAR8 = 0b10110101
PKC_MSGS = ints(90, 3)
PKC_EPH = 40503


def _point(api, xy):
    return api.curve.Point(*xy)


def _coords(sp):
    """A SharedPoint opened -> [x, y] as Python ints (party 0's view)."""
    x, y = sp.open()
    return [int(x.to_ints()[0][0]), int(y.to_ints()[0][0])]


def prog_add_double_neg(ctx, api):
    p = _point(api, TEST_POINT)
    sp = api.jubjub.SharedPoint.from_point(ctx, p, (1,))
    outs = {"add": sp.add(sp), "double": sp.double(), "neg": sp.neg(),
            "sub": sp.sub(sp.neg())}
    res = {}
    for name, q in outs.items():
        res[f"{name}_x"], res[f"{name}_y"] = q.xs, q.ys
        res[f"{name}_open"] = _coords(q)
    return res


def check_add_double_neg(out):
    p = Point(*TEST_POINT)
    for name, want in (("add", p.double()), ("double", p.double()),
                       ("neg", -p), ("sub", p.double())):
        got = [scalar(out[f"{name}_open.{i}"]) for i in (0, 1)]
        assert got == [int(want.x), int(want.y)], name


def _prog_mul(k):
    def prog(ctx, api):
        p = _point(api, TEST_POINT)
        got = api.jubjub.SharedPoint.from_point(ctx, p, (1,)).mul(k)
        if isinstance(got, api.jubjub.SharedIdeal):
            return {"ideal": [1]}
        return {"x": got.xs, "y": got.ys, "open": _coords(got)}
    return prog


def _check_mul(k):
    def check(out):
        want = Point(*TEST_POINT) * k
        if k == 0:
            assert scalar(out["ideal.0"]) == 1
            return
        assert [scalar(out[f"open.{i}"]) for i in (0, 1)] == \
            [int(want.x), int(want.y)]
    return check


def prog_montgomery_mul(ctx, api):
    p = _point(api, TEST_POINT)
    q = api.jubjub.SharedPoint.from_point(ctx, p, (1,)).montgomery_mul(13)
    return {"x": q.xs, "y": q.ys, "open": _coords(q)}


def check_montgomery_mul(out):
    want = Point(*TEST_POINT) * 13
    assert [scalar(out[f"open.{i}"]) for i in (0, 1)] == \
        [int(want.x), int(want.y)]


def prog_share_mul(ctx, api):
    p = _point(api, TEST_POINT)
    bits = [(SCALAR8 >> i) & 1 for i in range(8)]
    sbits = api.share(share_words(11, ctx.n, ctx.t, [bits]))    # [1, 8]
    q = api.jubjub.share_mul(ctx, sbits, p)
    return {"x": q.xs, "y": q.ys, "open": _coords(q)}


def check_share_mul(out):
    want = Point(*TEST_POINT) * SCALAR8
    assert [scalar(out[f"open.{i}"]) for i in (0, 1)] == \
        [int(want.x), int(want.y)]


def _two_points():
    p = Point(*TEST_POINT)
    return [p, p.double()]


def prog_mul_jit(ctx, api):
    pts = _two_points()
    xs = api.share(share_words(12, ctx.n, ctx.t, [int(q.x) for q in pts]))
    ys = api.share(share_words(13, ctx.n, ctx.t, [int(q.y) for q in pts]))
    sp = api.jubjub.SharedPoint(ctx, xs, ys)
    q = api.jubjub.jubjub_mul_jit(ctx, sp, 13)
    return {"x": q.xs, "y": q.ys,
            "open": ctx.open_share_arrays([q.xs, q.ys])}


def check_mul_jit(out):
    want = [q * 13 for q in _two_points()]
    assert opened(out["open.0"]) == [int(q.x) for q in want]
    assert opened(out["open.1"]) == [int(q.y) for q in want]


def prog_pkc(ctx, api):
    priv_bits, pub = api.pkc.key_generation(ctx, key_bits=8)
    kg, cts = api.pkc.mimc_encrypt(pub, PKC_MSGS, ephemeral_key=PKC_EPH)
    got = api.pkc.mimc_decrypt(ctx, priv_bits, kg, cts)
    return {"key": priv_bits, "pub": [int(pub.x), int(pub.y)],
            "kg": [int(kg.x), int(kg.y)], "cts": cts, "msgs": got}


def check_pkc(out):
    assert [scalar(out[f"msgs.{i}"]) for i in range(3)] == PKC_MSGS


def _deal(pre):
    pre.generate_triples(1024)
    pre.generate_rands(256)
    pre.generate_bits(8)


CASES = {
    "add_double_neg": (prog_add_double_neg, check_add_double_neg),
    **{f"mul_{k}": (_prog_mul(k), _check_mul(k)) for k in KS},
    "montgomery_mul": (prog_montgomery_mul, check_montgomery_mul),
    "share_mul": (prog_share_mul, check_share_mul),
    "mul_jit": (prog_mul_jit, check_mul_jit),
    "pkc": (prog_pkc, check_pkc),
}


def _ref(op):
    return ref_run(N, T, _deal, CASES[op][0], robust=False)


GOLDEN = {f"rt_jj_{op}_{N}_{T}": (lambda op=op: _ref(op)) for op in CASES}


def _check(ref, op, path):
    out, ctx = port_run(ref, N, T, CASES[op][0], path, robust=False)
    CASES[op][1](out)
    assert ctx.nerr_total.tolist() == [0] * N


@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference(op, tmp_path):
    _check(golden(f"rt_jj_{op}_{N}_{T}"), op, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op", list(CASES))
def test_word_equal_to_the_reference_live_reference(op, tmp_path):
    _check(_ref(op), op, tmp_path)


# -- the port alone -----------------------------------------------------------

@pytest.mark.parametrize("nbits", [3, 5])
def test_share_mul_folds_an_odd_number_of_terms(nbits):
    """The leftover term of an odd level joins the term axis (the
    reference joins it to the batch axis: wrong points at 3 bits, a shape
    error at 5)."""
    pre = PreProcessedElements(N, T, seed=5, device="cpu")
    pre.generate_triples(256)
    pre.generate_rands(64)
    ctx = MpcContext(N, T, preproc=pre, device="cpu", robust=False)
    scalar_ = (1 << nbits) - 3
    bits = FpArray.from_ints([[(scalar_ >> i) & 1 for i in range(nbits)]],
                             device="cpu")
    sbits = ctx.ShareArray(pre._share_values(bits.reshape(nbits)).reshape(
        N, 1, nbits))
    got = share_mul(ctx, sbits, Point(*TEST_POINT))
    want = Point(*TEST_POINT) * scalar_
    assert _coords(got) == [int(want.x), int(want.y)]


def test_cpu_inversion_equals_the_chain_of_multiplies():
    """On a CPU tensor inv_mod takes Python's pow; its words equal the
    square-and-multiply chain of mont_mul that the card runs (inv(0) =
    0)."""
    xs = [0, 1, P - 1] + ints(91, 5)
    a = FpArray.from_ints([xs[:4], xs[4:]], device="cpu")
    got = mont.inv_mod(a.limbs)
    assert torch.equal(got, mont.pow_const(a.limbs, P - 2))
    assert np.array_equal(FpArray(got).to_ints().reshape(-1),
                          [pow(x, P - 2, P) if x else 0 for x in xs])


def test_shared_point_constants_stay_on_the_context_device():
    ctx = MpcContext(N, T, device="cpu")
    sp = SharedPoint.from_point(ctx, Point(*TEST_POINT), (3,))
    assert sp.xs.v.limbs.device.type == "cpu"
    assert tuple(sp.xs.v.shape) == (N, 3)
