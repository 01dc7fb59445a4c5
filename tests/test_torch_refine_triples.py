"""Port parity for triple refinement (runtime/refinement.py: ``batch_beaver``
and ``refine_triples``) at n=4, t=1 and n=7, t=2 on the CPU.

Both run as programs (tests/_runtime_parity.py) on pools dealt by the JAX
package and loaded into the port: output shares word-equal to the JAX
package's (golden vectors; slow ``*_live_reference`` twins), and every
refined triple opens to (a, b, a*b). The dirty triples are numpy-made
sharings of (a, b, a*b), two batches of d+1 = n each, so refinement keeps
n - t per batch. The port alone: a dirty triple whose c is wrong spoils the
refined ones (refinement extracts, it does not verify)."""

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
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements
from honeybadgermpc_tpu_torch.runtime.refinement import refine_triples

BATCHES = 2


def _dirty(n, c_delta=0):
    """[BATCHES, n] values of a, b and c = a*b (+ c_delta at [0, 0])."""
    a = np.array(ints(70, BATCHES * n), object).reshape(BATCHES, n)
    b = np.array(ints(71, BATCHES * n), object).reshape(BATCHES, n)
    c = (a * b) % P
    c[0, 0] = (c[0, 0] + c_delta) % P
    return a.tolist(), b.tolist(), c.tolist()


def prog_batch_beaver(ctx, api):
    xs, ys = ints(72, 4), ints(73, 4)
    x = api.share(share_words(1, ctx.n, ctx.t, xs))
    y = api.share(share_words(2, ctx.n, ctx.t, ys))
    a, b, ab = (ctx.from_preproc(v) for v in ctx.preproc.get_triples(4))
    z = api.refinement.batch_beaver(ctx, x, y, a, b, ab)
    return {"z": z, "open": z.open()}


def check_batch_beaver(out):
    assert opened(out["open"]) == [x * y % P for x, y in
                                   zip(ints(72, 4), ints(73, 4))]


def prog_refine(ctx, api):
    a, b, c = _dirty(ctx.n)
    sa, sb, sc = (api.share(share_words(3 + i, ctx.n, ctx.t, v))
                  for i, v in enumerate((a, b, c)))
    ra, rb, rc = api.refinement.refine_triples(ctx, sa, sb, sc)
    return {"a": ra, "b": rb, "c": rc,
            "open": ctx.open_share_arrays([ra, rb, rc])}


def check_refine(out):
    a, b, c = (np.array(opened(out[f"open.{i}"]), object) for i in range(3))
    assert a.shape == (BATCHES, out["open.0"].shape[-1])
    assert ((a * b) % P == c).all()
    assert len(set(a.reshape(-1).tolist())) == a.size


CASES = {
    "batch_beaver": (lambda pre, n: pre.generate_triples(4),
                     prog_batch_beaver, check_batch_beaver),
    "refine_triples": (lambda pre, n: pre.generate_triples(BATCHES * (n - 1)),
                       prog_refine, check_refine),
}


def _ref(op, n, t):
    deal, prog, _ = CASES[op]
    return ref_run(n, t, lambda pre: deal(pre, n), prog)


GOLDEN = {f"rt_ref_{op}_{n}_{t}": (lambda op=op, n=n, t=t: _ref(op, n, t))
          for op in CASES for n, t in NT}
PARAMS = [pytest.param(op, n, t, id=f"{op}-{n}-{t}")
          for op in CASES for n, t in NT]


def _check(ref, op, n, t, path):
    out, ctx = port_run(ref, n, t, CASES[op][1], path)
    CASES[op][2](out)
    if op == "refine_triples":
        assert out["a"].shape == (16, n, BATCHES, n - t)
    assert ctx.nerr_total.tolist() == [0] * n


@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference(op, n, t, tmp_path):
    _check(golden(f"rt_ref_{op}_{n}_{t}"), op, n, t, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference_live_reference(op, n, t, tmp_path):
    _check(_ref(op, n, t), op, n, t, tmp_path)


def test_a_wrong_dirty_triple_spoils_the_refined_ones():
    n, t = 4, 1
    pre = PreProcessedElements(n, t, seed=4, device="cpu")
    pre.generate_triples(BATCHES * (n - 1))
    ctx = MpcContext(n, t, preproc=pre, device="cpu")
    a, b, c = _dirty(n, c_delta=1)
    sa, sb, sc = (ctx.ShareArray(FpArray(torch.from_numpy(
        share_words(3 + i, n, t, v).view(np.int32))))
        for i, v in enumerate((a, b, c)))
    ra, rb, rc = refine_triples(ctx, sa, sb, sc)
    va, vb, vc = (np.array(opened(to_reference_limbs(x.open().limbs)),
                           object) for x in (ra, rb, rc))
    assert not ((va[0] * vb[0]) % P == vc[0]).all()   # batch 0 spoiled
    assert ((va[1] * vb[1]) % P == vc[1]).all()       # batch 1 clean
