"""Port parity for the models of the runtime slice (models/mimc.py,
models/mimc_symmetric.py, models/butterfly.py) and for the slice as one
program, at n=4, t=1 and n=7, t=2 on the CPU.

MiMC (``mimc_mpc_batch`` and ``mimc_mpc_batch_jit``, one body under the
reference's two names; ``mimc_encrypt_ctr``), the butterfly network
(``iterated_butterfly_network`` and its ``_jit`` name) and a whole program
(multiply, compare, MiMC, open) run on pools dealt by the JAX package and
loaded into the port: output
shares word-equal to the JAX package's (golden vectors; slow
``*_live_reference`` twins), opened values equal to Python-int oracles
(``mimc_plain``; a permutation of the network's inputs). The port alone:
the one-take MiMC at a batch that is no multiple of t+1 (the reference's
scan asks for one) and the symmetric cipher's round trip."""

import numpy as np
import pytest
import torch

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import NT, ints, opened, port_run, ref_run, share_words
from honeybadgermpc_tpu_torch.interop import to_reference_limbs
from honeybadgermpc_tpu_torch.models import mimc, mimc_symmetric
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.runtime.context import MpcContext
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements

KEY = ints(60, 1)[0]
MSG = ints(61, 3)
NONCE = 77
NET_K = 8
NET_IN = ints(62, NET_K, 1000)


def _prog_mimc(which):
    def prog(ctx, api):
        B = ctx.t + 1            # the reference's scan asks B % (t+1) == 0
        x = api.share(share_words(1, ctx.n, ctx.t, MSG[:B]))
        enc = getattr(api.mimc, which)(ctx, x, KEY)
        return {"enc": enc, "open": enc.open()}
    return prog


def _check_mimc(out):
    got = opened(out["open"])
    assert got == [mimc.mimc_plain(m, KEY) for m in MSG[:len(got)]]


def prog_ctr(ctx, api):
    key = api.share(share_words(2, ctx.n, ctx.t, [KEY]))
    blocks = api.share(share_words(3, ctx.n, ctx.t, MSG[:2]))
    ct = api.mimc.mimc_encrypt_ctr(ctx, key, NONCE, blocks)
    return {"ct": ct, "open": ct.open()}


def check_ctr(out):
    assert opened(out["open"]) == [
        (m + mimc.mimc_plain(NONCE + i, KEY)) % P
        for i, m in enumerate(MSG[:2])]


def _prog_net(which):
    def prog(ctx, api):
        x = api.share(share_words(4, ctx.n, ctx.t, NET_IN))
        out = getattr(api.butterfly, which)(ctx, x, NET_K)
        return {"out": out, "open": out.open()}
    return prog


def check_net(out):
    got = opened(out["open"])
    assert sorted(got) == sorted(NET_IN)


WHOLE_A, WHOLE_B = ints(63, 2, 1 << 100), ints(64, 2, 1 << 100)
WHOLE_W = ints(65, 2, 1 << 200)


def prog_whole(ctx, api):
    """Deal (the JAX dealer), multiply, compare, encrypt, open."""
    api.comparison.install(ctx)
    a = api.share(share_words(5, ctx.n, ctx.t, WHOLE_A[:1]))
    b = api.share(share_words(6, ctx.n, ctx.t, WHOLE_B[:1]))
    w = api.share(share_words(7, ctx.n, ctx.t, WHOLE_W[:1]))
    z = a * b
    lt = z < w
    enc = api.mimc.mimc_mpc_batch(ctx, z, KEY)
    return {"z": z, "lt": lt, "enc": enc,
            "open": ctx.open_share_arrays([z, lt, enc])}


def check_whole(out):
    z = WHOLE_A[0] * WHOLE_B[0] % P
    assert opened(out["open.0"]) == [z]
    assert opened(out["open.1"]) == [int(z < WHOLE_W[0])]
    assert opened(out["open.2"]) == [mimc.mimc_plain(z, KEY)]


def _net_rounds():
    return int(np.log2(NET_K)) ** 2 * NET_K // 2


CASES = {
    "mimc_batch": (lambda pre, B: pre.generate_cubes(mimc.ROUND * B),
                   _prog_mimc("mimc_mpc_batch"), _check_mimc),
    "mimc_batch_jit": (lambda pre, B: pre.generate_cubes(mimc.ROUND * B),
                       _prog_mimc("mimc_mpc_batch_jit"), _check_mimc),
    "mimc_encrypt_ctr": (lambda pre, B: pre.generate_cubes(mimc.ROUND * 2),
                         prog_ctr, check_ctr),
    "butterfly": (lambda pre, B: (pre.generate_one_minus_ones(_net_rounds()),
                                  pre.generate_triples(_net_rounds())),
                  _prog_net("iterated_butterfly_network"), check_net),
    "butterfly_jit": (lambda pre, B: (
        pre.generate_one_minus_ones(_net_rounds()),
        pre.generate_triples(_net_rounds())),
        _prog_net("iterated_butterfly_network_jit"), check_net),
    "whole_slice": (lambda pre, B: (pre.generate_triples(800),
                                    pre.generate_share_bits(2),
                                    pre.generate_cubes(mimc.ROUND)),
                    prog_whole, check_whole),
}


def _ref(op, n, t):
    deal, prog, _ = CASES[op]
    return ref_run(n, t, lambda pre: deal(pre, t + 1), prog)


# the _jit names are one body with the per-round names: the MiMC twin's
# 161 rounds run at one (n, t) only
CELLS = [(op, n, t) for op in CASES for n, t in NT
         if not (op == "mimc_batch_jit" and (n, t) != NT[0])]
GOLDEN = {f"rt_mdl_{op}_{n}_{t}": (lambda op=op, n=n, t=t: _ref(op, n, t))
          for op, n, t in CELLS}
PARAMS = [pytest.param(op, n, t, id=f"{op}-{n}-{t}") for op, n, t in CELLS]


def _check(ref, op, n, t, path):
    out, ctx = port_run(ref, n, t, CASES[op][1], path)
    CASES[op][2](out)
    assert ctx.nerr_total.tolist() == [0] * n


@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference(op, n, t, tmp_path):
    _check(golden(f"rt_mdl_{op}_{n}_{t}"), op, n, t, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("op,n,t", PARAMS)
def test_word_equal_to_the_reference_live_reference(op, n, t, tmp_path):
    _check(_ref(op, n, t), op, n, t, tmp_path)


# -- the port alone -----------------------------------------------------------

def _ctx(n, t, **deal):
    pre = PreProcessedElements(n, t, seed=12, device="cpu")
    for kind, k in deal.items():
        getattr(pre, f"generate_{kind}")(k)
    return MpcContext(n, t, preproc=pre, device="cpu")


def _share(ctx, seed, vals):
    return ctx.ShareArray(FpArray(torch.from_numpy(
        share_words(seed, ctx.n, ctx.t, vals).view(np.int32))))


def test_mimc_one_take_pads_a_batch_that_is_no_multiple():
    """B = 3 at t = 1: each round's open is padded to 4; one take of
    ROUND*B cubes, none left; the pads are opened zero sharings, so no
    error is counted."""
    assert mimc.mimc_mpc_batch_jit is mimc.mimc_mpc_batch
    ctx = _ctx(4, 1, cubes=mimc.ROUND * 3)
    enc = mimc.mimc_mpc_batch_jit(ctx, _share(ctx, 8, MSG), KEY)
    got = opened(to_reference_limbs(enc.open().limbs))
    assert got == [mimc.mimc_plain(m, KEY) for m in MSG]
    assert ctx.preproc._pool("cubes").remaining() == 0
    assert ctx.opened_count == mimc.ROUND * 3 + 3
    assert ctx.nerr_total.tolist() == [0] * 4


def test_symmetric_cipher_round_trip():
    """mimc_encrypt publishes m + MiMC_k(nonce + i); mimc_decrypt turns the
    ciphertexts back into shares of the messages (n=7, t=2)."""
    ctx = _ctx(7, 2, cubes=mimc.ROUND * 4)
    key = _share(ctx, 9, [KEY])
    ct = mimc_symmetric.mimc_encrypt(ctx, key, _share(ctx, 10, MSG[:2]),
                                     nonce=NONCE)
    assert opened(to_reference_limbs(ct.limbs)) == [
        (m + mimc.mimc_plain(NONCE + i, KEY)) % P
        for i, m in enumerate(MSG[:2])]
    back = mimc_symmetric.mimc_decrypt(ctx, key, FpArray(ct.limbs[:, 0]),
                                       nonce=NONCE)
    assert opened(to_reference_limbs(back.open().limbs)) == MSG[:2]

