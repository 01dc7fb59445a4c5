"""Butterfly switching network for share shuffling (reference
apps/asynchromix/butterfly_network.py:9-118).

Counterpart of ``honeybadgermpc_tpu/models/butterfly.py``. Each switch
consumes one +-1-shared sbit s and maps (a, b) to ((a+b+s(a-b))/2,
(a+b-s(a-b))/2) — a swap iff s == -1. A round of k/2 switches is ONE
batched Beaver multiply; the k(log k)^2 network is log2(k) iterations of a
log2(k)-round butterfly.
"""

from __future__ import annotations

import math

import torch

from ..ops.fparray import FpArray
from ..ops.limbs import P
from ..runtime.context import MpcContext, ShareArray, beaver_multiply_arrays

_INV2 = pow(2, P - 2, P)


def batch_switch(ctx: MpcContext, xs: ShareArray, ys: ShareArray,
                 sbits: ShareArray, triples=None):
    """Vectorized switches (butterfly_network.py:9-19): returns (out_x,
    out_y) with per-pair swap decided by the +-1 sbit share. `triples`
    (a, b, ab), if given, serve the Beaver multiply instead of a take."""
    inv2 = FpArray.from_int(_INV2, device=ctx.device)
    sdiff = beaver_multiply_arrays(ctx, sbits, xs - ys, triples)
    summ = xs + ys
    out_x = ctx.ShareArray((summ.v + sdiff.v) * inv2, xs.t)
    out_y = ctx.ShareArray((summ.v - sdiff.v) * inv2, xs.t)
    return out_x, out_y


def butterfly_round(ctx: MpcContext, inputs: ShareArray, sbits: ShareArray,
                    stride: int, triples=None):
    """One round: pair elements at the given stride and switch."""
    v = inputs.v.limbs                       # [L, n, k]
    k = v.shape[-1]
    group = 2 * stride
    blocks = v.reshape(v.shape[:-1] + (k // group, 2, stride))
    xs = ctx.ShareArray(FpArray(
        blocks[..., 0, :].reshape(v.shape[:-1] + (k // 2,))), inputs.t)
    ys = ctx.ShareArray(FpArray(
        blocks[..., 1, :].reshape(v.shape[:-1] + (k // 2,))), inputs.t)
    ox, oy = batch_switch(ctx, xs, ys, sbits, triples)
    oxb = ox.v.limbs.reshape(v.shape[:-1] + (k // group, 1, stride))
    oyb = oy.v.limbs.reshape(v.shape[:-1] + (k // group, 1, stride))
    merged = torch.cat([oxb, oyb], dim=-2).reshape(v.shape)
    return ctx.ShareArray(FpArray(merged), inputs.t)


def iterated_butterfly_network(ctx: MpcContext, inputs: ShareArray,
                               k: int) -> ShareArray:
    """log2(k) iterations of a log2(k)-round butterfly
    (butterfly_network.py:22-53) with ONE pool take per kind for the whole
    network, laid out by round: k/2 * log2(k)^2 one-minus-one bits and as
    many triples. The reference's per-round takes slice the pools the same
    way, so the words are the same; each round's open is the context's,
    padded to a multiple of t+1."""
    assert k & (k - 1) == 0, "k must be a power of 2"
    R = int(math.log2(k)) ** 2
    h = k // 2

    def by_round(fp):
        return fp.limbs.reshape(fp.limbs.shape[:-1] + (R, h))

    sb = by_round(ctx.preproc.get_one_minus_ones(R * h))
    abc = [by_round(x) for x in ctx.preproc.get_triples(R * h)]
    cur = inputs
    for i in range(R):
        stride = 1 << (i % int(math.log2(k)))
        cur = butterfly_round(
            ctx, cur, ctx.from_preproc(FpArray(sb[..., i, :])), stride,
            [ctx.from_preproc(FpArray(x[..., i, :])) for x in abc])
    return cur


# the reference's jitted lax.scan over one take per kind (butterfly.py:
# 79-174); PyTorch runs eagerly, so it is the same loop
iterated_butterfly_network_jit = iterated_butterfly_network
