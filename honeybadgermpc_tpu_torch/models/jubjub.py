"""Shared-point arithmetic on the Jubjub twisted Edwards curve.

Counterpart of ``honeybadgermpc_tpu/models/jubjub.py`` (the reference's
progs/jubjub.py: SharedPoint :9-185, SharedIdeal :188-255, share_mul
:258-294). Batched: a SharedPoint holds ShareArrays of x/y coordinate
tensors, so one object is a whole vector of points; the share_mul term
tree folds a [K, B] term axis with log2(K) *batched* curve additions
instead of K-1 sequential ones.

Public constants (the curve's a and d, a public point's coordinates, the
term tree's multiples of P) live on the context's device and are cached
there (``ops/fparray.py::scalar_const``, ``dev_const``), so a warm program
issues no host-to-device copy, as a CUDA graph capture requires
(runtime/fused.py).
"""

from __future__ import annotations

import torch

from ..elliptic_curve import Ideal, Jubjub, Point
from ..ops import montgomery as mont
from ..ops.fparray import FpArray, dev_const, mont_limbs_np
from ..runtime.context import MpcContext, ShareArray


class SharedPoint:
    def __init__(self, ctx: MpcContext, xs: ShareArray, ys: ShareArray,
                 curve: Jubjub | None = None):
        self.context = ctx
        self.curve = curve or Jubjub()
        self.xs, self.ys = xs, ys

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_point(ctx: MpcContext, p: Point, shape=(1,)) -> "SharedPoint":
        """Public point -> constant (degree-0) sharing, broadcast to shape."""
        x = FpArray.from_int(int(p.x), device=ctx.device).broadcast_to(shape)
        y = FpArray.from_int(int(p.y), device=ctx.device).broadcast_to(shape)
        return SharedPoint(ctx, ctx.ShareArray(_lift(ctx, x)),
                           ctx.ShareArray(_lift(ctx, y)), p.curve)

    def open(self):
        """Open both coordinates -> (x, y) FpArrays (public)."""
        both = ShareArray.concat([self.xs, self.ys],
                                 axis=_last_axis(self.context, self.xs))
        B = _numel(self.xs)
        o = both.open()
        return FpArray(o.limbs[..., :B]), FpArray(o.limbs[..., B:])

    # -- group ops (twisted Edwards complete formulas) ---------------------
    def neg(self) -> "SharedPoint":
        return SharedPoint(self.context, -1 * self.xs, self.ys, self.curve)

    def add(self, other: "SharedPoint") -> "SharedPoint":
        if isinstance(other, SharedIdeal):
            return self
        assert self.curve == other.curve, "points on different curves"
        x1, y1, x2, y2 = self.xs, self.ys, other.xs, other.ys
        d = FpArray.from_int(int(self.curve.d), device=self.context.device)
        x_prod, y_prod = x1 * x2, y1 * y2
        d_prod = (x_prod * y_prod) * d
        x3 = (x1 * y2 + y1 * x2) / (d_prod + 1)
        y3 = (y_prod + x_prod) / (1 - d_prod)
        return SharedPoint(self.context, x3, y3, self.curve)

    def sub(self, other):
        return self.add(other.neg())

    def double(self) -> "SharedPoint":
        x_, y_ = self.xs, self.ys
        x_sq, y_sq = x_ * x_, y_ * y_
        a = FpArray.from_int(int(self.curve.a), device=self.context.device)
        ax_sq = x_sq * a
        x_denom = ax_sq + y_sq
        x = (2 * (x_ * y_)) / x_denom
        y = (y_sq - ax_sq) / (2 - x_denom)
        return SharedPoint(self.context, x, y, self.curve)

    def mul(self, n: int) -> "SharedPoint":
        """Double-and-add by a public scalar (jubjub.py:119-142)."""
        assert isinstance(n, int)
        if n < 0:
            return self.neg().mul(-n)
        if n == 0:
            return SharedIdeal(self.curve)
        current, product = self, None
        i = 1
        while i <= n:
            if n & i:
                product = current if product is None else product.add(current)
            if (i << 1) <= n:
                current = current.double()
            i <<= 1
        return product

    def montgomery_mul(self, n: int) -> "SharedPoint":
        """Montgomery-ladder variant (jubjub.py:144-171)."""
        assert isinstance(n, int)
        if n < 0:
            return self.neg().montgomery_mul(-n)
        if n == 0:
            return SharedIdeal(self.curve)
        shape = self.xs.shape
        product = SharedPoint.from_point(
            self.context, Point(0, 1, self.curve), shape)
        current = self
        for i in reversed(range(n.bit_length())):
            if (n >> i) & 1:
                product = product.add(current)
                current = current.double()
            else:
                current = product.add(current)
                product = product.double()
        return product

    def equals(self, other: "SharedPoint"):
        """Secure equality of both coordinates -> host bool after opening
        (jubjub.py:60-81)."""
        ex = (self.xs == other.xs).open()
        ey = (self.ys == other.ys).open()
        # the Equality mixin's output opens to NONZERO iff equal
        return (not bool(ex.is_zero().any())) and \
            (not bool(ey.is_zero().any()))


class SharedIdeal:
    """Point at infinity (jubjub.py:188)."""

    def __init__(self, curve):
        self.curve = curve

    def neg(self):
        return self

    def add(self, other):
        return other

    def sub(self, other):
        return other.neg()

    def mul(self, n):
        return self

    def double(self):
        return self


def _sel_share(c, bit, a: ShareArray, b: ShareArray) -> ShareArray:
    """bit ? a : b elementwise on share tensors (a public bit: a 0-d
    tensor on the device, one row of the scan's per_step)."""
    mask = (bit != 0).expand(a.v.limbs.shape[1:])
    return c.ShareArray(FpArray(mont.select(mask, a.v.limbs, b.v.limbs)),
                        a.t)


def _ladder_step(c, carry, bit):
    """One uniform Montgomery-ladder step (jubjub.py:144-171 semantics,
    branchless): added = P+C; D = double(bit ? C : P);
    P' = bit ? added : D; C' = bit ? D : added."""
    px, py, cx, cy = carry
    product = SharedPoint(c, px, py)
    current = SharedPoint(c, cx, cy)
    added = product.add(current)
    dbl = SharedPoint(c, _sel_share(c, bit, cx, px),
                      _sel_share(c, bit, cy, py)).double()
    npx = _sel_share(c, bit, added.xs, dbl.xs)
    npy = _sel_share(c, bit, added.ys, dbl.ys)
    ncx = _sel_share(c, bit, dbl.xs, added.xs)
    ncy = _sel_share(c, bit, dbl.ys, added.ys)
    return npx, npy, ncx, ncy


def jubjub_mul_jit(ctx: MpcContext, pt: SharedPoint, scalar: int,
                   auto_deal: bool = False) -> SharedPoint:
    """Public-scalar point multiply as ONE ladder step replayed per bit
    (runtime/fused.py run_fused_scan, the ladder bits as its per_step):
    a captured CUDA graph on the card, the same step eagerly on the CPU;
    preprocessing rides the step axis. The shape of
    SharedPoint.montgomery_mul (jubjub.py:144-171). Sim backend only;
    opens to the points of SharedPoint.mul."""
    from ..runtime.fused import run_fused_scan
    assert isinstance(scalar, int)
    if scalar < 0:
        return jubjub_mul_jit(ctx, pt.neg(), -scalar, auto_deal)
    nbits = max(1, scalar.bit_length())
    bits = torch.tensor([(scalar >> i) & 1 for i in reversed(range(nbits))],
                        dtype=torch.int32, device=ctx.device)
    elem_shape = pt.xs.v.shape[ctx.lead:]
    ident = SharedPoint.from_point(ctx, Point(0, 1, pt.curve), elem_shape)
    out = run_fused_scan(
        ctx, _ladder_step, (ident.xs, ident.ys, pt.xs, pt.ys), nbits,
        per_step=bits, auto_deal=auto_deal)
    return SharedPoint(ctx, out[0], out[1], pt.curve)


def share_mul(ctx: MpcContext, bits: ShareArray, p: Point) -> SharedPoint:
    """[x]P from the bitwise-shared scalar (LSB first along the LAST axis)
    and a public point (jubjub.py:258-294). The K terms fold in log2(K)
    batched additions: the term axis rides as a leading element axis."""
    if isinstance(p, Ideal):
        return SharedIdeal(p.curve)
    K = bits.v.shape[-1]
    xs_pub, ys_pub = [], []
    p2i = p
    for _ in range(K):
        xs_pub.append(int(p2i.x))
        ys_pub.append((int(p2i.y) - 1) % ctx.field_modulus)
        p2i = p2i.double()
    px = FpArray(dev_const(mont_limbs_np, (tuple(xs_pub),), ctx.device))
    py1 = FpArray(dev_const(mont_limbs_np, (tuple(ys_pub),), ctx.device))
    # terms: x_i = b_i * P2i.x ; y_i = b_i * (P2i.y - 1) + 1
    bv = _move_term_axis(ctx, bits)                # term axis leading
    tx = ctx.ShareArray(bv.v * _col(px, bv), bits.t)
    ty = ctx.ShareArray(bv.v * _col(py1, bv)
                        + FpArray.from_int(1, device=ctx.device), bits.t)
    terms = SharedPoint(ctx, tx, ty, p.curve)
    while _term_len(ctx, terms.xs) > 1:
        m = _term_len(ctx, terms.xs)
        half = m // 2
        left = _slice_terms(ctx, terms, 0, half)
        right = _slice_terms(ctx, terms, half, 2 * half)
        folded = left.add(right)
        if m % 2:
            folded = _concat_terms(ctx, folded,
                                   _slice_terms(ctx, terms, m - 1, m))
        terms = folded
    return _drop_term_axis(ctx, terms)


def _lift(ctx, pub: FpArray) -> FpArray:
    """Public values -> constant sharing tensor (adds the local party
    axis)."""
    return ctx.lift_public(pub)


def _last_axis(ctx, sa: ShareArray):
    return sa.v.ndim - 1 - ctx.lead


def _numel(sa: ShareArray):
    return sa.v.shape[-1]


def _term_axis(ctx):
    return ctx.lead


def _move_term_axis(ctx, bits: ShareArray) -> ShareArray:
    """[.., B, K] -> [K_leading, .., B] as element axes (after party axis)."""
    v = torch.movedim(bits.v.limbs, -1, _term_axis(ctx) + 1)
    return ctx.ShareArray(FpArray(v), bits.t)


def _col(pub: FpArray, like: ShareArray) -> FpArray:
    """[K] public constants -> broadcastable against the term-leading value."""
    extra = like.v.ndim - 1
    return FpArray(pub.limbs.reshape(
        pub.limbs.shape[:1] + (pub.shape[0],) + (1,) * (extra - 1)))


def _term_len(ctx, sa: ShareArray):
    return sa.v.shape[_term_axis(ctx)]


def _slice_terms(ctx, pt: SharedPoint, a, b) -> SharedPoint:
    ax = _term_axis(ctx) + 1  # +1 for limb axis
    sl = [slice(None)] * pt.xs.v.limbs.dim()
    sl[ax] = slice(a, b)
    return SharedPoint(
        pt.context,
        pt.context.ShareArray(FpArray(pt.xs.v.limbs[tuple(sl)]), pt.xs.t),
        pt.context.ShareArray(FpArray(pt.ys.v.limbs[tuple(sl)]), pt.ys.t),
        pt.curve)


def _concat_terms(ctx, a: SharedPoint, b: SharedPoint) -> SharedPoint:
    """Join b's terms after a's along the term axis. ShareArray.concat
    counts axes after the party axis, so that is axis 0 there; the
    reference passes the term axis's index in the FpArray, which joins an
    odd level's leftover term to the batch axis (ROADMAP Queue C)."""
    ax = _term_axis(ctx) - ctx.lead
    return SharedPoint(
        ctx,
        ShareArray.concat([a.xs, b.xs], axis=ax),
        ShareArray.concat([a.ys, b.ys], axis=ax),
        a.curve)


def _drop_term_axis(ctx, pt: SharedPoint) -> SharedPoint:
    sl = [slice(None)] * pt.xs.v.limbs.dim()
    sl[_term_axis(ctx) + 1] = 0
    return SharedPoint(
        ctx,
        ctx.ShareArray(FpArray(pt.xs.v.limbs[tuple(sl)]), pt.xs.t),
        ctx.ShareArray(FpArray(pt.ys.v.limbs[tuple(sl)]), pt.ys.t),
        pt.curve)
