"""Port parity for the MPC runtime core (runtime/context.py): the share
algebra, both multiplications, inversion and division, the product tree,
``Share``'s scalar surface and the batched open of several arrays, at
n=4, t=1 and n=7, t=2 on the CPU.

Each op runs as one program (tests/_runtime_parity.py) on pools dealt by
the JAX package and loaded into the port through
``PreProcessedElements.load``: the port's output shares are word-equal to
the JAX package's (golden vectors from tests/make_golden.py; a slow
``*_live_reference`` twin runs the reference live), and opened values are
equal to Python-int oracles. The port alone: errors (context mix, an
exhausted pool, another backend) and the per-party error tally."""

import numpy as np
import pytest
import torch

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import (NT, ints, mont_words, opened, plain, port_run,
                             ref_run, scalar, share_words)
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements

B = 5
XS, YS = ints(11, B), ints(12, B)
NZ = [v or 1 for v in ints(13, 4)]          # nonzero: inversion, division


def _inv(v):
    return pow(v, P - 2, P)


def _xy(ctx, api, xs=XS, ys=YS):
    return (api.share(share_words(1, ctx.n, ctx.t, xs)),
            api.share(share_words(2, ctx.n, ctx.t, ys)))


def prog_linear(ctx, api):
    x, y = _xy(ctx, api)
    pub = api.fp(mont_words(YS))
    return {"add": x + y, "sub": x - y, "neg": -x, "scale": x * 7,
            "rscale": 3 * x, "addc": x + 9, "raddc": 9 + x, "rsubc": 4 - x,
            "subc": x - 2, "addpub": x + pub, "mulpub": x * pub,
            "divc": x / 5, "lift": ctx.lift_public(pub),
            "open": (x * 7 + y - x).open()}


def check_linear(out):
    assert opened(out["open"]) == [(6 * x + y) % P for x, y in zip(XS, YS)]
    assert plain(out["lift"]) == [YS] * len(plain(out["lift"]))


def prog_beaver(ctx, api):
    x, y = _xy(ctx, api)
    grid = [ints(14, 3), ints(15, 3)]
    gx = api.share(share_words(3, ctx.n, ctx.t, grid))
    gy = api.share(share_words(4, ctx.n, ctx.t, grid[::-1]))
    z, g = x * y, gx * gy                      # [B] and a [2, 3] array
    # (the reference cannot open a 3-D share tensor on a context that has
    # opened a 2-D one: its nerr_total, ROADMAP Queue C 2)
    return {"z": z, "g": g, "open": z.open(), "open_g": g.reshape(6).open()}


def check_beaver(out):
    assert opened(out["open"]) == [x * y % P for x, y in zip(XS, YS)]
    a, b = ints(14, 3), ints(15, 3)
    assert opened(out["open_g"]) == [u * v % P for u, v in zip(a + b, b + a)]


def prog_double_sharing(ctx, api):
    c = api.context
    ctx.config[c.MixinConstants.MultiplyShareArray] = \
        c.double_sharing_multiply_arrays
    x, y = _xy(ctx, api)
    z = x * y
    return {"z": z, "open": z.open()}


def check_double_sharing(out):
    assert opened(out["open"]) == [x * y % P for x, y in zip(XS, YS)]


def prog_invert_divide(ctx, api):
    x, y = _xy(ctx, api, NZ, NZ[::-1])
    inv, q = x.invert(), x / y
    return {"inv": inv, "q": q, "open_inv": inv.open(), "open_q": q.open()}


def check_invert_divide(out):
    assert opened(out["open_inv"]) == [_inv(v) for v in NZ]
    assert opened(out["open_q"]) == [u * _inv(v) % P
                                     for u, v in zip(NZ, NZ[::-1])]


def _prog_product(k):
    def prog(ctx, api):
        if k == 0:
            x = ctx.ShareArray(api.fp(np.zeros((16, ctx.n, 0), np.uint32)))
        else:
            x = api.share(share_words(5, ctx.n, ctx.t, ints(16, k)))
        s = x.multiplicative_product()
        return {"prod": s, "open": s.open()}
    return prog


def _check_product(k):
    def check(out):
        want = 1
        for v in ints(16, k):
            want = want * v % P
        assert scalar(out["open"]) == want
    return check


def prog_tree_fold(ctx, api):
    x = api.share(share_words(6, ctx.n, ctx.t, ints(17, 7)))
    s_add = x.tree_fold(lambda a, b: a + b)
    s_mul = x.tree_fold(lambda a, b: a * b)
    return {"add": s_add, "mul": s_mul, "open_add": s_add.open(),
            "open_mul": s_mul.open()}


def check_tree_fold(out):
    vals = ints(17, 7)
    prod = 1
    for v in vals:
        prod = prod * v % P
    assert scalar(out["open_add"]) == sum(vals) % P
    assert scalar(out["open_mul"]) == prod


SCALAR = ints(18, 2)


def prog_share_scalar(ctx, api):
    x, y = _xy(ctx, api, [SCALAR[0] or 1], [SCALAR[1] or 1])
    a, b = ctx.Share(x), ctx.Share(y)
    outs = {"add": a + b, "sub": a - b, "rsub": 3 - a, "neg": -a,
            "mul": a * b, "scale": a * 5, "rscale": 5 * a, "div": a / b,
            "divc": a / 7, "inv": a.invert(), "sq": a.square()}
    outs.update({f"open_{k}": v.open() for k, v in list(outs.items())})
    return outs


def check_share_scalar(out):
    a, b = SCALAR[0] or 1, SCALAR[1] or 1
    want = {"add": a + b, "sub": a - b, "rsub": 3 - a, "neg": -a,
            "mul": a * b, "scale": 5 * a, "rscale": 5 * a,
            "div": a * _inv(b), "divc": a * _inv(7), "inv": _inv(a),
            "sq": a * a}
    for k, v in want.items():
        assert scalar(out[f"open_{k}"]) == v % P, k


SHAPES = ((3,), (2, 2), (1,), (2, 3, 2))


def prog_open_arrays(ctx, api):
    arrs = [api.share(share_words(20 + i, ctx.n, ctx.t,
                                  np.array(ints(30 + i, int(np.prod(s))),
                                           object).reshape(s).tolist()))
            for i, s in enumerate(SHAPES)]
    return {"opened": ctx.open_share_arrays(arrs)}


def check_open_arrays(out):
    for i, s in enumerate(SHAPES):
        got = np.array(opened(out[f"opened.{i}"]), object)
        assert got.shape == s
        assert got.reshape(-1).tolist() == ints(30 + i, int(np.prod(s)))


def _deal(**kinds):
    def deal(pre):
        for kind, k in kinds.items():
            getattr(pre, f"generate_{kind}")(k)
    return deal


CASES = {
    "linear": (_deal(), prog_linear, check_linear),
    "beaver": (_deal(triples=12), prog_beaver, check_beaver),
    "double_sharing": (_deal(double_shares=B), prog_double_sharing,
                       check_double_sharing),
    "invert_divide": (_deal(rands=8, triples=12), prog_invert_divide,
                      check_invert_divide),
    "tree_fold": (_deal(triples=6), prog_tree_fold, check_tree_fold),
    "share_scalar": (_deal(rands=4, triples=8), prog_share_scalar,
                     check_share_scalar),
    "open_arrays": (_deal(), prog_open_arrays, check_open_arrays),
}
for _k in (0, 1, 2, 5, 8):
    CASES[f"product_k{_k}"] = (_deal(triples=max(_k - 1, 1)),
                               _prog_product(_k), _check_product(_k))


def _ref(op, n, t):
    deal, prog, _ = CASES[op]
    return ref_run(n, t, deal, prog)


GOLDEN = {f"rt_ctx_{op}_{n}_{t}": (lambda op=op, n=n, t=t: _ref(op, n, t))
          for op in CASES for n, t in NT}

PARAMS = [pytest.param(op, n, t, id=f"{op}-{n}-{t}")
          for op in CASES for n, t in NT]


def _check(ref, op, n, t, path):
    out, ctx = port_run(ref, n, t, CASES[op][1], path)
    CASES[op][2](out)
    assert tuple(ctx.nerr_total.shape) == (n,)
    assert ctx.nerr_total.tolist() == [0] * n


@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference(op, n, t, tmp_path):
    _check(golden(f"rt_ctx_{op}_{n}_{t}"), op, n, t, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference_live_reference(op, n, t, tmp_path):
    _check(_ref(op, n, t), op, n, t, tmp_path)


# -- the port alone -----------------------------------------------------------

def _ctx(n=4, t=1, **deal):
    pre = PreProcessedElements(n, t, seed=5, device="cpu")
    for kind, k in deal.items():
        getattr(pre, f"generate_{kind}")(k)
    return MpcContext(n, t, preproc=pre, device="cpu")


def _share(ctx, seed, vals):
    return ctx.ShareArray(FpArray(torch.from_numpy(
        share_words(seed, ctx.n, ctx.t, vals).view(np.int32))))


def test_shares_of_two_contexts_never_combine():
    ctx = _ctx(triples=4)
    other = MpcContext(ctx.n, ctx.t, preproc=ctx.preproc, device="cpu")
    a = _share(ctx, 1, XS[:3])
    b = other.ShareArray(a.v)
    for op in (lambda: a + b, lambda: a - b, lambda: a * b, lambda: a / b,
               lambda: a.local_mul(b)):
        with pytest.raises(TypeError):
            op()


def test_an_exhausted_pool_raises_assertion_error():
    ctx = _ctx(rands=4)
    with pytest.raises(AssertionError, match="exhausted"):
        ctx.preproc.get_rands(5)
    x = _share(ctx, 2, XS)
    with pytest.raises(AssertionError, match="exhausted"):
        x * x                                   # no triples dealt


def test_only_the_sim_backend_is_ported():
    class MeshBackend:
        n = 4

    with pytest.raises(NotImplementedError, match="Queue A 6"):
        MpcContext(4, 1, backend=MeshBackend(), device="cpu")
    wrapped = type("Byzantine", (), {"inner": MeshBackend()})()
    with pytest.raises(NotImplementedError):
        MpcContext(4, 1, backend=wrapped, device="cpu")
    with pytest.raises(ValueError, match="dealer"):
        MpcContext(4, 1, preproc=PreProcessedElements(4, 1, device="cpu"),
                   device="meta")


def test_nerr_total_counts_corrected_errors_per_party():
    """A Beaver multiply at n=7, t=2 whose x shares lie at party 3: the
    open of (x-a, y-b) (two chunks of t+1) is corrected by the Gao redo,
    which charges the wrong share of the first chunk to every destination;
    the tally is a per-party [n] tensor. The product's shares do not use x's
    own shares, so they open with no error."""
    n, t = 7, 2
    ctx = _ctx(n, t, triples=6)
    words = share_words(7, n, t, XS[:3])
    words[:, 3] = share_words(9, n, t, YS[:3])[:, 3]   # party 3 lies
    x = ctx.ShareArray(FpArray(torch.from_numpy(words.view(np.int32))))
    y = _share(ctx, 8, YS[:3])
    z = x * y
    assert tuple(ctx.nerr_total.shape) == (n,)
    assert ctx.nerr_total.dtype == torch.int32
    assert ctx.nerr_total.tolist() == [1] * n
    want_xy = [u * v % P for u, v in zip(XS[:3], YS[:3])]
    assert opened(z.open().limbs.numpy().view(np.uint32)) == want_xy
    assert ctx.nerr_total.tolist() == [1] * n


def test_agreement_check_catches_a_diverged_party(monkeypatch):
    from honeybadgermpc_tpu_torch.runtime import context
    ctx = _ctx()
    secrets = FpArray.from_ints([[1, 2], [1, 2], [1, 3], [1, 2]],
                                device="cpu")
    with pytest.raises(AssertionError, match="diverged"):
        context._assert_party_agreement(secrets)
    monkeypatch.setenv("HBMPC_NO_AGREEMENT_CHECK", "1")
    context._assert_party_agreement(secrets)
    assert ctx.opened_count == 0
