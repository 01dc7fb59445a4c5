"""The harness of the runtime slice's parity tests (MpcContext, the dealer's
kinds, comparison, MiMC, the butterfly network, triple refinement).

A *program* is a function ``program(ctx, api)`` written once for both
packages: ``api`` holds the package's modules (``api.context``,
``api.comparison``, ``api.mimc``, ...) and ``api.share(words)``, which
turns np.uint32 Montgomery limbs ``[L, n, ...]`` into a ShareArray of
``ctx``. It returns a dict of outputs: ShareArrays, FpArrays, Shares'
opened ints or lists of them.

The reference side (``ref_run``): the JAX dealer deals every pool at a
fixed seed, the JAX context runs the program, and the result holds the
words of every output and of the part of every pool the program consumed
(``pool_<kind>``). The port side (``port_run``): those pools are written
in the reference's file format and loaded into the port's dealer through
``PreProcessedElements.load`` (the carry-across path), the port's context
runs the same program on the CPU, and its outputs' words are compared with
the reference's, word for word (no tolerance), and every pool must be used
up exactly. The test modules keep the reference's results as golden
vectors (tests/_golden.py) and each has a slow ``*_live_reference`` twin.

Input shares are made with numpy from a seed (Shamir polynomials at the
party points 1..n), so neither package's sampler draws them.
"""

import os
import types

import numpy as np
import torch

from honeybadgermpc_tpu_torch import interop
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, int_to_limbs,
                                                ints_to_limbs, limbs_to_ints)

NT = ((4, 1), (7, 2))


RINV = pow(R_MOD_P, P - 2, P)
DEALER_SEED = 2029


def ints(seed, count, bound=P):
    """`count` Python ints in [0, bound) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % bound
            for _ in range(count)]


def share_words(seed, n, degree, values):
    """Shamir shares of `values` (a nested list of ints: the element shape)
    at the points 1..n, random polynomials of `degree` from a numpy seed:
    np.uint32 Montgomery limbs [L, n, *shape]."""
    arr = np.array(values, dtype=object)
    flat = arr.reshape(-1).tolist()
    coeffs = ints(seed, len(flat) * degree)
    rows = []
    for x in range(1, n + 1):
        row = []
        for i, v in enumerate(flat):
            acc = 0
            for c in reversed(coeffs[i * degree:(i + 1) * degree]):
                acc = (acc + c) * x % P
            row.append((v + acc) % P * R_MOD_P % P)
        rows.append(row)
    return ints_to_limbs(np.array(rows, dtype=object).reshape(
        (n,) + arr.shape))


def mont_words(values):
    """Python ints (nested lists) -> np.uint32 Montgomery limbs."""
    return ints_to_limbs(np.vectorize(lambda v: int(v) % P * R_MOD_P % P,
                                      otypes=[object])(
        np.array(values, dtype=object)))


def plain(words):
    """np.uint32 Montgomery limbs [L, ...] -> nested lists of Python ints."""
    vals = limbs_to_ints(np.asarray(words, np.uint32))
    return np.vectorize(lambda v: int(v) * RINV % P, otypes=[object])(
        vals).tolist()


def scalar(words):
    """The int an opened Share was stored as (its 16 plain limbs)."""
    return int(limbs_to_ints(np.asarray(words, np.uint32)))


def opened(words):
    """Party 0's view of opened words [L, n, ...] (every party's is equal,
    which the test checks)."""
    arr = np.asarray(words)
    assert all(np.array_equal(arr[:, j], arr[:, 0])
               for j in range(arr.shape[1]))
    return plain(arr[:, 0])


def _words(v):
    """An output -> np.uint32 words: a ShareArray's shares, an FpArray's
    limbs, a Python int (an opened Share) as its 16 plain limbs."""
    if isinstance(v, (int, np.integer)):
        return int_to_limbs(int(v) % P)
    if hasattr(v, "_arr"):                     # a Share
        v = v._arr
    if hasattr(v, "ctx"):                      # a ShareArray
        v = v.v
    limbs = v.limbs
    if isinstance(limbs, torch.Tensor):
        return interop.to_reference_limbs(limbs)
    return np.asarray(limbs, np.uint32)


def _flatten(outs):
    flat = {}
    for name, v in outs.items():
        if isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                flat[f"{name}.{i}"] = _words(x)
        else:
            flat[name] = _words(v)
    return flat


def ref_api():
    import jax.numpy as jnp

    from honeybadgermpc_tpu import elliptic_curve
    from honeybadgermpc_tpu.models import (butterfly, fixedpoint, jubjub,
                                           mimc, mimc_jubjub_pkc,
                                           mimc_symmetric, powermixing)
    from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
    from honeybadgermpc_tpu.runtime import (comparison, context, fused,
                                            refinement)
    return types.SimpleNamespace(
        context=context, comparison=comparison, mimc=mimc,
        mimc_symmetric=mimc_symmetric, butterfly=butterfly,
        refinement=refinement, fixedpoint=fixedpoint,
        powermixing=powermixing, fused=fused, jubjub=jubjub,
        pkc=mimc_jubjub_pkc, curve=elliptic_curve, FpArray=RefFpArray,
        raw=lambda w: jnp.asarray(np.asarray(w, np.uint32)),
        fp=lambda w: RefFpArray(jnp.asarray(np.asarray(w, np.uint32))))


def port_api():
    from honeybadgermpc_tpu_torch import elliptic_curve
    from honeybadgermpc_tpu_torch.models import (butterfly, fixedpoint,
                                                 jubjub, mimc,
                                                 mimc_jubjub_pkc,
                                                 mimc_symmetric, powermixing)
    from honeybadgermpc_tpu_torch.runtime import (comparison, context, fused,
                                                  refinement)

    def raw(w):
        return torch.from_numpy(
            np.ascontiguousarray(w, np.uint32).view(np.int32))

    return types.SimpleNamespace(
        context=context, comparison=comparison, mimc=mimc,
        mimc_symmetric=mimc_symmetric, butterfly=butterfly,
        refinement=refinement, fixedpoint=fixedpoint,
        powermixing=powermixing, fused=fused, jubjub=jubjub,
        pkc=mimc_jubjub_pkc, curve=elliptic_curve, FpArray=FpArray, raw=raw,
        fp=lambda w: FpArray(interop.from_reference_limbs(
            np.asarray(w, np.uint32), "cpu")))


def _bind(api, ctx):
    api.share = lambda w, t=None: ctx.ShareArray(api.fp(w), t)
    return api


def ref_run(n, t, deal, program, robust=True):
    """Run `program` on the JAX package: `deal(pre)` fills the reference
    dealer (seeded), then the context (robust opens unless `robust` is
    False) runs the program. Returns the words of every output
    (``out_<name>``) and of the consumed part of every pool
    (``pool_<kind>``)."""
    from honeybadgermpc_tpu.runtime.context import MpcContext
    from honeybadgermpc_tpu.runtime.preprocessing import PreProcessedElements
    pre = PreProcessedElements(n, t, seed=DEALER_SEED)
    deal(pre)
    dealt = {kind: np.asarray(pool.data.limbs)
             for kind, pool in pre._pools.items()}
    ctx = MpcContext(n, t, preproc=pre, robust=robust)
    outs = _flatten(program(ctx, _bind(ref_api(), ctx)))
    res = {f"out_{k}": v for k, v in outs.items()}
    for kind, arr in dealt.items():
        used = arr.shape[2] - pre._pool(kind).remaining()
        res[f"pool_{kind}"] = arr[:, :, :used]
    return res


def write_pools(ref, n, t, path):
    """The reference's consumed pools as ``{kind}_{n}_{t}.npy`` files (the
    format ``PreProcessedElements.save`` writes)."""
    os.makedirs(path, exist_ok=True)
    for key, arr in ref.items():
        if key.startswith("pool_"):
            np.save(os.path.join(path, f"{key[5:]}_{n}_{t}.npy"), arr)


def port_run(ref, n, t, program, path, robust=True):
    """Run `program` on the port (CPU) with the reference's pools loaded
    through ``PreProcessedElements.load``; assert that its outputs are
    word-equal to the reference's and that every pool is used up. Returns
    (outputs' words, context)."""
    from honeybadgermpc_tpu_torch.runtime.context import MpcContext
    from honeybadgermpc_tpu_torch.runtime.preprocessing import \
        PreProcessedElements
    write_pools(ref, n, t, path)
    pre = PreProcessedElements(n, t, seed=0, device="cpu")
    pre.load(str(path))
    ctx = MpcContext(n, t, preproc=pre, device="cpu", robust=robust)
    outs = _flatten(program(ctx, _bind(port_api(), ctx)))
    want = {k[4:]: v for k, v in ref.items() if k.startswith("out_")}
    assert sorted(outs) == sorted(want)
    for name, words in outs.items():
        assert words.shape == want[name].shape, name
        assert np.array_equal(words, want[name]), name
    for kind, pool in pre._pools.items():
        assert pool.remaining() == 0, (kind, pool.remaining())
    return outs, ctx
