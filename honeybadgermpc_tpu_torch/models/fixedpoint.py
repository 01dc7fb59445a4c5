"""Secure fixed-point arithmetic (Catrina-Saxena, FC'10).

Counterpart of ``honeybadgermpc_tpu/models/fixedpoint.py`` (reference
progs/fixedpoint.py: params :24-35, random2m :91, trunc_pr :108,
get_carry_bit :131, bit_ltl :163, div2m :184, trunc :208, FixedPoint :214).
Batched: a FixedPointArray wraps a ShareArray tensor; the carry-computation
tree over the bit axis runs as log-depth *batched* multiply rounds, each
product a ``mont_mul`` (row 9 on the card) and each open the context's.

F = 32 fraction bits, K = 64 total bits, KAPPA = 32 statistical security —
like the reference, opening masked values leaks O(2^-KAPPA) per op.
"""

from __future__ import annotations

import numpy as np
import torch

from ..elliptic_curve import Subgroup
from ..ops import montgomery as mont
from ..ops.fparray import FpArray
from ..ops.limbs import L, MASK, W
from ..runtime.comparison import _sum_last, public_bits
from ..runtime.context import MpcContext, ShareArray, beaver_multiply_arrays

F = 32
KAPPA = 32
K = 64
p = Subgroup.BLS12_381


def to_fixed_point_repr(x: float, f: int = F) -> int:
    return int(x * 2 ** f)


def from_fixed_point_repr(x: int, k: int = K, f: int = F, signed=True) -> float:
    x = int(x)
    if signed and x >= 2 ** (k - 1):
        x = -(p - x)
    return float(x) / 2 ** f


def random2m(ctx: MpcContext, B: int, m: int):
    """m-bit random share per element: (value share [.., B],
    bit shares [.., B, m] LSB first) — fixedpoint.py:91-98 batched."""
    bits = ctx.preproc.get_bits(B * m)                       # [n, B*m]
    lead = bits.shape[:ctx.lead]
    bits = bits.reshape(lead + (B, m))
    weights = FpArray.from_ints([1 << i for i in range(m)], device=ctx.device)
    val = _sum_last(bits * weights)
    return ctx.ShareArray(val), ctx.ShareArray(bits)


def _const(ctx, x: int) -> FpArray:
    return FpArray.from_int(x, device=ctx.device)


def trunc_pr(ctx: MpcContext, x: ShareArray, k: int, m: int) -> ShareArray:
    """Probabilistic truncation of the low m bits (fixedpoint.py:108-120)."""
    assert k > m
    B = x.v.shape[-1]
    r1, _ = random2m(ctx, B, m)
    r2, _ = random2m(ctx, B, k + KAPPA - m)
    r2v = r2.v * _const(ctx, 1 << m)
    c = ctx.open_share_array(
        ctx.ShareArray(x.v + _const(ctx, 1 << (k - 1)) + r1.v + r2v, x.t))
    c2 = _mod_2m(c, m)                                       # public
    inv2m = _const(ctx, pow(1 << m, p - 2, p))
    return ctx.ShareArray((x.v - c2 + r1.v) * inv2m, x.t)


def get_carry_bit(ctx: MpcContext, a_bits: ShareArray, b_bits: ShareArray,
                  low_carry_bit: int = 1) -> ShareArray:
    """Carry-out of a + b over bit tensors [.., B, m] (LSB first), via the
    (carry, all_one) combine tree — fixedpoint.py:131-160, with each tree
    level one batched multiply round per product (left = more
    significant)."""
    carry = beaver_multiply_arrays(ctx, a_bits, b_bits)
    allone = ctx.ShareArray(
        a_bits.v + b_bits.v - carry.v - carry.v, a_bits.t)
    # append the low carry-in as the least significant element, then make
    # the tree axis MSB-first
    edge = carry.v.shape[:-1] + (1,)
    lcb = FpArray.from_int(low_carry_bit, edge, ctx.device)
    zero = FpArray.zeros(edge, ctx.device)
    axis = carry.v.ndim - 1
    c = FpArray.concatenate([lcb, carry.v], axis=axis)
    o = FpArray.concatenate([zero, allone.v], axis=axis)
    cs = ctx.ShareArray(FpArray(torch.flip(c.limbs, (-1,))), a_bits.t)
    os_ = ctx.ShareArray(FpArray(torch.flip(o.limbs, (-1,))), a_bits.t)
    m = c.shape[-1]
    while m > 1:
        half = m // 2
        cl, cr = _pairs(ctx, cs)
        ol, orr = _pairs(ctx, os_)
        oc = beaver_multiply_arrays(ctx, ol, cr)
        oo = beaver_multiply_arrays(ctx, ol, orr)
        nc = cl + oc
        no = oo
        if m % 2:
            nc = _append_last(ctx, nc, cs)
            no = _append_last(ctx, no, os_)
            m = half + 1
        else:
            m = half
        cs, os_ = nc, no
    return ctx.ShareArray(FpArray(cs.v.limbs[..., 0]), a_bits.t)


def bit_ltl(ctx: MpcContext, a: FpArray, b_bits: ShareArray) -> ShareArray:
    """Share of [a < b] for public a[.., B] and bitwise-shared b [.., B, m]
    (fixedpoint.py:163-181): 1 - the carry of a + (2^m - 1 - b) + 1.
    (The reference's docstring says [b < a]; div2m needs [a < b].)"""
    m = b_bits.v.shape[-1]
    nb = ctx.ShareArray(1 - b_bits.v, b_bits.t)              # 1 - b_i
    a_bits = public_bits(a, m)                               # [.., B, m]
    if a_bits.shape != nb.v.shape:
        a_bits = a_bits.broadcast_to(nb.v.shape)
    carry = get_carry_bit(ctx, ctx.ShareArray(a_bits, b_bits.t), nb)
    return ctx.ShareArray(1 - carry.v, carry.t)


def div2m(ctx: MpcContext, x: ShareArray, k: int, m: int) -> ShareArray:
    """Share of [x mod 2^m] (fixedpoint.py:184-193; the reference's naming
    keeps div2m = remainder, trunc = quotient)."""
    B = x.v.shape[-1]
    r1, r1_bits = random2m(ctx, B, m)
    r2, _ = random2m(ctx, B, k + KAPPA - m)
    r2v = r2.v * _const(ctx, 1 << m)
    c = ctx.open_share_array(ctx.ShareArray(
        x.v + r2v + r1.v + _const(ctx, 1 << (k - 1)), x.t))
    c2 = _mod_2m(c, m)
    u = bit_ltl(ctx, c2, r1_bits)
    return ctx.ShareArray(c2 - r1.v + _const(ctx, 1 << m) * u.v, x.t)


def trunc(ctx: MpcContext, x: ShareArray, k: int, m: int) -> ShareArray:
    """Share of [x // 2^m] (fixedpoint.py:208-211)."""
    a2 = div2m(ctx, x, k, m)
    inv2m = _const(ctx, pow(1 << m, p - 2, p))
    return ctx.ShareArray((x.v - a2.v) * inv2m, x.t)


class FixedPointArray:
    """Batched fixed-point numbers over shares (fixedpoint.py:214-286)."""

    def __init__(self, ctx: MpcContext, x):
        self.ctx = ctx
        if isinstance(x, ShareArray):
            self.share = x
        elif isinstance(x, (list, tuple, np.ndarray)):
            reps = [to_fixed_point_repr(float(v)) % p for v in x]
            B = len(reps)
            zero = ctx.from_preproc(ctx.preproc.get_zeros(B))
            self.share = ctx.ShareArray(
                zero.v + FpArray.from_ints(reps, device=ctx.device), zero.t)
        else:
            raise NotImplementedError(type(x))

    def __add__(self, o):
        return FixedPointArray(self.ctx, self.share + o.share)

    def __sub__(self, o):
        return FixedPointArray(self.ctx, self.share - o.share)

    def neg(self):
        return FixedPointArray(self.ctx, -1 * self.share)

    def __mul__(self, o):
        prod = self.share * o.share
        return FixedPointArray(self.ctx, trunc_pr(self.ctx, prod, 2 * K, F))

    def div(self, c):
        assert isinstance(c, (int, float))
        B = self.share.v.shape[-1]
        return self * FixedPointArray(self.ctx, [1.0 / c] * B)

    def ltz(self) -> ShareArray:
        """Share of [self < 0] (fixedpoint.py:266-268)."""
        t = trunc(self.ctx, self.share, K, K - 1)
        return self.ctx.ShareArray(-t.v, t.t)

    def lt(self, o) -> ShareArray:
        return (self - o).ltz()

    def open(self) -> np.ndarray:
        vals = self.ctx.open_share_array(self.share).to_ints()
        flat = vals.reshape(-1)
        out = np.array([from_fixed_point_repr(v) for v in flat])
        return out.reshape(vals.shape)


# -- helpers -----------------------------------------------------------------

def _pairs(ctx, sa: ShareArray):
    m = sa.v.shape[-1]
    half = m // 2
    l = ctx.ShareArray(FpArray(sa.v.limbs[..., 0:half * 2:2]), sa.t)
    r = ctx.ShareArray(FpArray(sa.v.limbs[..., 1:half * 2:2]), sa.t)
    return l, r


def _append_last(ctx, sa: ShareArray, src: ShareArray):
    m = src.v.shape[-1]
    tail = FpArray(src.v.limbs[..., m - 1:m])
    return ctx.ShareArray(
        FpArray.concatenate([sa.v, tail], axis=sa.v.ndim - 1), sa.t)


def _mod_2m(c: FpArray, m: int) -> FpArray:
    """Public c mod 2^m as a field element: the plain limbs above bit m
    masked (limb j keeps min(16, max(0, m - 16 j)) bits), then back to
    Montgomery form."""
    keep = [MASK if (j + 1) * W <= m else
            ((1 << (m - j * W)) - 1 if j * W < m else 0) for j in range(L)]
    mask = torch.tensor(keep, dtype=torch.int32, device=c.device).reshape(
        (L,) + (1,) * c.ndim)
    return FpArray(mont.to_mont(mont.from_mont(c.limbs) & mask))
