"""Port parity for the comparison mixins (runtime/comparison.py): the
Legendre equality test and Reistad's less-than, at n=4, t=1 and n=7, t=2
on the CPU.

``equality`` and ``less_than`` run as programs (tests/_runtime_parity.py)
on pools dealt by the JAX package and loaded into the port: the port's
output shares are word-equal to the JAX package's (golden vectors; slow
``*_live_reference`` twins), and the opened results agree with Python
ints. The port alone: the Brent-Kung exclusive suffix scan against the
same oracle, bound and Hillis-Steele twin as the reference's
``tests/test_jubjub_comparison.py::test_suffix_scan_brent_kung`` — whose
3-D open fails in the reference (its ``nerr_total``, ROADMAP Queue C 2)
and passes here, with a per-party tally — and the public helpers."""

import numpy as np
import pytest
import torch

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import NT, ints, opened, port_run, ref_run, share_words
from honeybadgermpc_tpu_torch.interop import to_reference_limbs
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.parallel.reconstruct import \
    sim_batch_reconstruct
from honeybadgermpc_tpu_torch.runtime import comparison
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements

EQ_X = ints(40, 3)
EQ_Y = [EQ_X[0], ints(41, 1)[0], EQ_X[2]]
LT_A = ints(42, 2, 1 << 200)
LT_B = [ints(43, 1, 1 << 200)[0], LT_A[1]]      # a random pair, an equal one


def prog_equality(ctx, api):
    api.comparison.install(ctx)
    x = api.share(share_words(1, ctx.n, ctx.t, EQ_X))
    y = api.share(share_words(2, ctx.n, ctx.t, EQ_Y))
    eq = x == y
    return {"eq": eq, "open": eq.open()}


def check_equality(out):
    got = opened(out["open"])
    assert [v != 0 for v in got] == [u == v for u, v in zip(EQ_X, EQ_Y)]


def _prog_less_than(B):
    def prog(ctx, api):
        api.comparison.install(ctx)
        a = api.share(share_words(3, ctx.n, ctx.t, LT_A[:B]))
        b = api.share(share_words(4, ctx.n, ctx.t, LT_B[:B]))
        lt = a < b
        return {"lt": lt, "open": lt.open()}
    return prog


def _check_less_than(B):
    def check(out):
        assert opened(out["open"]) == [int(u < v) for u, v in
                                       zip(LT_A[:B], LT_B[:B])]
    return check


# less_than spends 768 triples per element: B = 2 at n=4 (an equal pair
# included), 1 at n=7, to keep each golden file near 1 MB
LT_B_OF = {4: 2, 7: 1}


def _case(op, n):
    if op == "equality":
        return (lambda pre: (pre.generate_bits(96), pre.generate_rands(192),
                             pre.generate_triples(400)),
                prog_equality, check_equality)
    B = LT_B_OF[n]
    return (lambda pre: (pre.generate_share_bits(2 * B),
                         pre.generate_triples(800 * B)),
            _prog_less_than(B), _check_less_than(B))


def _ref(op, n, t):
    deal, prog, _ = _case(op, n)
    return ref_run(n, t, deal, prog)


OPS = ("equality", "less_than")
GOLDEN = {f"rt_cmp_{op}_{n}_{t}": (lambda op=op, n=n, t=t: _ref(op, n, t))
          for op in OPS for n, t in NT}
PARAMS = [pytest.param(op, n, t, id=f"{op}-{n}-{t}")
          for op in OPS for n, t in NT]


def _check(ref, op, n, t, path):
    out, ctx = port_run(ref, n, t, _case(op, n)[1], path)
    _case(op, n)[2](out)
    assert ctx.nerr_total.tolist() == [0] * n


@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference(op, n, t, tmp_path):
    _check(golden(f"rt_cmp_{op}_{n}_{t}"), op, n, t, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference_live_reference(op, n, t, tmp_path):
    _check(_ref(op, n, t), op, n, t, tmp_path)


# -- the port alone -----------------------------------------------------------

def test_suffix_scan_brent_kung():
    """The port's counterpart of the reference's test of the same name: the
    Brent-Kung exclusive suffix scan equals the plaintext oracle and the
    Hillis-Steele variant at about 2K triples per element instead of
    K*log2(K). Its Beaver opens are 2-D, the opens of its [n, B, K] result
    3-D, on one context: the tally stays a per-party [n] tensor, and a 3-D
    open's own nerr is [n, B], as the reference's generic program gives
    it."""
    n, t = 4, 1
    K, B = 13, 2                    # odd, non-power-of-two bit axis
    Kp = 16
    pre = PreProcessedElements(n, t, seed=91, device="cpu")
    pre.generate_triples(512)
    c = comparison.install(MpcContext(n, t, preproc=pre, device="cpu"))
    rng = np.random.default_rng(91)
    vals = rng.integers(1, 1000, (B, K)).tolist()
    fa = FpArray.from_ints(vals, device="cpu")
    sa = c.ShareArray(pre._share_values(fa.reshape(B * K)).reshape(n, B, K))

    pool = pre._pool("triples")
    before = pool.remaining()
    got_bk = comparison._exclusive_suffix_product(c, sa)
    used_bk = before - pool.remaining()
    got_hs = comparison._exclusive_suffix_product_hs(c, sa)
    used_hs = before - used_bk - pool.remaining()

    oracle = [[1] * K for _ in range(B)]
    for bi in range(B):
        for i in reversed(range(K - 1)):
            oracle[bi][i] = oracle[bi][i + 1] * vals[bi][i + 1] % P
    flat_oracle = [x for row in oracle for x in row]
    opened_bk = [int(v) for v in
                 np.asarray(c.open_share_array(got_bk).to_ints()[0]).ravel()]
    opened_hs = [int(v) for v in
                 np.asarray(c.open_share_array(got_hs).to_ints()[0]).ravel()]
    assert opened_bk == flat_oracle
    assert opened_hs == flat_oracle
    assert used_bk <= 2 * (Kp - 1) * B, used_bk
    assert used_hs >= K * 4 * B, used_hs
    assert used_bk < used_hs, (used_bk, used_hs)

    assert tuple(c.nerr_total.shape) == (n,)
    assert c.nerr_total.dtype == torch.int32
    assert c.nerr_total.tolist() == [0] * n
    padded = FpArray.concatenate(
        [got_bk.v, FpArray.zeros((n, B, 1), "cpu")], axis=2)   # K+1 = 14
    sec, nerr = sim_batch_reconstruct(padded, n, t)
    assert tuple(nerr.shape) == (n, B) and nerr.tolist() == [[0] * B] * n
    assert tuple(sec.shape) == (n, B, K + 1)


def test_faulty_3d_open_charges_each_row(monkeypatch):
    """A 3-D open at n=7, t=2 with party 5 lying in row 1 only: the redo
    corrects it, its nerr [n, B] charges the row's two chunks to every
    destination, and the context's tally adds them per party."""
    from honeybadgermpc_tpu_torch.runtime import context
    n, t, B, K = 7, 2, 3, 6
    vals = np.array(ints(50, B * K), object).reshape(B, K).tolist()
    words = share_words(9, n, t, vals)                       # [L, n, B, K]
    words[:, 5, 1] = share_words(10, n, t, vals)[:, 5, 1]
    seen = []

    def spy(*args):
        out = sim_batch_reconstruct(*args)
        seen.append(out[1])
        return out

    monkeypatch.setattr(context, "sim_batch_reconstruct", spy)
    ctx = MpcContext(n, t, device="cpu")
    x = ctx.ShareArray(FpArray(torch.from_numpy(words.view(np.int32))))
    got = ctx.open_share_array(x)
    assert [e.tolist() for e in seen] == [[[0, 2, 0]] * n]
    assert opened(to_reference_limbs(got.limbs)) == vals
    assert ctx.nerr_total.tolist() == [2] * n


def test_faulty_3d_open_not_robust_keeps_detect_counts():
    """robust=False, the same lie: no redo runs, and the detect-only counts
    (charged to the source party) reach the tally, equal to those of a 2-D
    open of the same shares flattened on another context."""
    n, t, B, K = 7, 2, 3, 6
    vals = np.array(ints(50, B * K), object).reshape(B, K).tolist()
    words = share_words(9, n, t, vals)
    words[:, 5, 1] = share_words(10, n, t, vals)[:, 5, 1]
    tallies = []
    for shape in ((B, K), (B * K,)):
        ctx = MpcContext(n, t, robust=False, device="cpu")
        x = ctx.ShareArray(FpArray(torch.from_numpy(
            words.reshape(words.shape[:2] + shape).view(np.int32))))
        ctx.open_share_array(x)
        assert tuple(ctx.nerr_total.shape) == (n,)
        tallies.append(ctx.nerr_total.tolist())
    assert tallies[0] == tallies[1] and tallies[0][5] > 0


def test_public_helpers_against_ints():
    vals = [0, 1, P - 1, (1 << 254) + 3, 12345] + ints(51, 3)
    c = FpArray.from_ints(vals, device="cpu")
    bits = comparison.public_bits(c).to_ints()
    for v, row in zip(vals, bits.tolist()):
        assert sum(int(b) << i for i, b in enumerate(row)) == v
    for bound in (1, 1 << 254, (1 << 254) + (1 << 253), P):
        assert comparison.public_lt_const(c, bound).tolist() == \
            [v < bound for v in vals]
    leg = comparison.legendre_fp(c).to_ints().tolist()
    assert leg == [pow(v, (P - 1) // 2, P) for v in vals]
    assert set(leg[1:]) <= {1, P - 1}
