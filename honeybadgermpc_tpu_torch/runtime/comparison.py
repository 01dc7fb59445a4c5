"""Secure comparison mixins: Equality (Legendre) and LessThan (Reistad'07).

Counterpart of ``honeybadgermpc_tpu/runtime/comparison.py`` (reference
progs/mixins/share_comparison.py: Equality :9-80, LessThan :83-212). The
security parameter and the bit axis are tensor axes, so a comparison is a
handful of batched opens; every product is a ``mont_mul`` (row 9 on the
card) and every open the context's.
"""

from __future__ import annotations

import torch

from ..ops import montgomery as mont
from ..ops.fparray import FpArray
from ..ops.limbs import P, W, int_to_limbs
from .context import (MixinConstants, MpcContext, ShareArray,
                      beaver_multiply_arrays)

BIT_LENGTH = 255  # p.bit_length()


def legendre_fp(c: FpArray) -> FpArray:
    """Legendre symbol of public values as field elements in {1, p-1}
    (0 maps to 0) — c^((p-1)/2)."""
    return c.pow_static((P - 1) // 2)


def equality(ctx: MpcContext, x: ShareArray, y: ShareArray,
             security_parameter: int = 32):
    """Probabilistic equality test -> share of nonzero (equal) / 0 (not
    equal).

    Per test bit s (share_comparison.py:33-62): with shared bit b and
    rands r, rp: _b = 5 - 4b in {1, 5} (5 is a QNR); c = open(diff*r +
    _b*rp^2); test_bit = (leg(c)/2) * (_b + leg(c)); the result is the
    product of the s test bits. c == 0 (probability about 2^-254 per bit)
    counts as "agree", where the reference retries."""
    s = security_parameter
    dev = ctx.device
    diff = x - y
    B = diff.v.shape[-1]

    b = ctx.from_preproc(ctx.preproc.get_bits(B * s))        # [n, B*s]
    r = ctx.from_preproc(ctx.preproc.get_rands(B * s))
    rp = ctx.from_preproc(ctx.preproc.get_rands(B * s))

    _b = (-4) * b + 5                                        # in {1, 5}
    diff_rep = _repeat_last(ctx, diff, s)                    # [n, B*s]
    rp2_b = beaver_multiply_arrays(ctx, beaver_multiply_arrays(ctx, rp, rp),
                                   _b)
    c = ctx.open_share_array(
        beaver_multiply_arrays(ctx, diff_rep, r) + rp2_b)    # public

    leg = legendre_fp(c)                                     # {1, p-1}
    leg = FpArray.select(c.is_zero(), FpArray.ones(leg.shape, dev), leg)
    inv2 = FpArray.from_int(pow(2, P - 2, P), device=dev)
    # a test bit is 0 with probability 1/4 when the values differ and never
    # when they are equal: the product opens NONZERO iff equal
    test = ctx.ShareArray((_b.v + leg) * (leg * inv2), x.t)

    # product of the s test bits per element: log2(s) batched multiplies
    cur = test
    width = s
    while width > 1:
        half = width // 2
        v = cur.v.limbs.reshape(cur.v.limbs.shape[:-1] + (B, width))
        even = v[..., 0:half * 2:2].reshape(v.shape[:-2] + (B * half,))
        odd = v[..., 1:half * 2:2].reshape(v.shape[:-2] + (B * half,))
        prod = beaver_multiply_arrays(
            ctx, ctx.ShareArray(FpArray(even), cur.t),
            ctx.ShareArray(FpArray(odd), cur.t))
        if width % 2:
            pv = prod.v.limbs.reshape(v.shape[:-2] + (B, half))
            merged = torch.cat([pv, v[..., width - 1:width]], dim=-1)
            cur = ctx.ShareArray(FpArray(
                merged.reshape(v.shape[:-2] + (B * (half + 1),))), cur.t)
            width = half + 1
        else:
            cur = prod
            width = half
    return cur


def _repeat_last(ctx, sa: ShareArray, s: int) -> ShareArray:
    """[.., B] -> [.., B*s] (each element repeated s times, grouped by s:
    layout [B, s] flattened)."""
    v = sa.v.limbs[..., :, None]
    v = v.expand(v.shape[:-1] + (s,))
    return ctx.ShareArray(
        FpArray(v.reshape(v.shape[:-2] + (v.shape[-2] * s,))), sa.t)


def public_bits(c: FpArray, nbits: int = BIT_LENGTH) -> FpArray:
    """Public values -> 0/1 field elements of their bits, LSB first on a
    new trailing axis: [.., B] -> [.., B, nbits]."""
    plain = mont.from_mont(c.limbs)                   # [L, .., B]
    idx = torch.arange(nbits, device=c.device)
    sel = plain.index_select(0, idx // W)             # [nbits, .., B]
    bits = (sel >> (idx % W).reshape((nbits,) + (1,) * (plain.dim() - 1))) \
        & 1
    bits = bits.movedim(0, -1)                        # [.., B, nbits]
    return FpArray.select(bits != 0, FpArray.ones(bits.shape, c.device),
                          FpArray.zeros(bits.shape, c.device))


def public_lt_const(c: FpArray, bound: int):
    """bool mask: int value of public c < bound (lexicographic limb
    compare against a host constant)."""
    plain = mont.from_mont(c.limbs)
    b = int_to_limbs(bound)
    lt = torch.zeros(plain.shape[1:], dtype=torch.bool, device=c.device)
    decided = torch.zeros_like(lt)
    for j in reversed(range(plain.shape[0])):
        bj = int(b[j])
        lt = lt | (~decided & (plain[j] < bj))
        decided = decided | (plain[j] != bj)
    return lt


def _xor_pub(share_v: FpArray, cbit: FpArray) -> FpArray:
    """share XOR public bit, locally: c + r(1 - 2c)."""
    one = FpArray.from_int(1, device=cbit.device)
    return cbit + share_v * (one - cbit - cbit)


def _xor_shares(ctx, a: ShareArray, b: ShareArray) -> ShareArray:
    """a + b - 2ab (share_comparison.py:113-117) — one batched multiply."""
    ab = beaver_multiply_arrays(ctx, a, b)
    return a + b - ab - ab


def less_than(ctx: MpcContext, a: ShareArray, b: ShareArray) -> ShareArray:
    """Reistad'07 comparison (share_comparison.py:83-212): share of 1 iff
    a < b. Requires a, b < (p-1)/2.

    The 255-bit axis is an element axis; the reference's 254 SEQUENTIAL
    suffix-product multiplications (:155-157) become 2 log2(K) rounds of
    batched multiplies (Brent-Kung)."""
    B = a.v.shape[-1]
    K = BIT_LENGTH
    one = FpArray.from_int(1, device=ctx.device)
    z = a - b

    # 5.1 transform: open c = 2z + r, with bitwise-shared r
    r_b, r_bits = ctx.preproc.get_share_bits(B)       # [n, B], [n, B, K]
    r_b = ctx.from_preproc(r_b)
    r_bits = ctx.from_preproc(r_bits)
    c = ctx.open_share_array(z + z + r_b)             # public [n, B]
    c_bits = public_bits(c, K)                        # [n, B, K]

    # 5.2 x: suffix products of (1 + r_j xor c_j) for j > i
    xor = ctx.ShareArray(_xor_pub(r_bits.v, c_bits), r_bits.t)
    pb = xor + 1                                      # in {1, 2}
    suffix = _exclusive_suffix_product(ctx, pb)       # [n, B, K]
    r1c = ctx.ShareArray(r_bits.v * (one - c_bits), r_bits.t)
    terms = beaver_multiply_arrays(ctx, r1c, suffix)
    x = ctx.ShareArray(_sum_last(terms.v), a.t)       # [n, B]

    # 5.3 the lsb of x via a second bitwise-shared mask s
    s_b, s_bits = ctx.preproc.get_share_bits(B)
    s_b = ctx.from_preproc(s_b)
    s_bits = ctx.from_preproc(s_bits)
    d = ctx.open_share_array(s_b + x)                 # public
    s_0 = _bit(ctx, s_bits, 0)
    s_1 = _bit(ctx, s_bits, K - 1)
    s_2 = _bit(ctx, s_bits, K - 2)
    s_prod = beaver_multiply_arrays(ctx, s_1, s_2)
    d0 = FpArray(public_bits(d, 1).limbs[..., 0])     # public bit of d
    hi1, hi2 = 1 << (K - 1), 1 << (K - 2)
    x1 = _xor_bits_pub(d0, public_lt_const(d, hi1))
    x2 = _xor_bits_pub(d0, public_lt_const(d, hi2))
    x12 = _xor_bits_pub(d0, public_lt_const(d, hi1 + hi2))
    d_0 = ctx.ShareArray(
        (one - s_1.v - s_2.v + s_prod.v) * d0
        + (s_2.v - s_prod.v) * x2
        + (s_1.v - s_prod.v) * x1
        + s_prod.v * x12, a.t)
    x_0 = _xor_shares(ctx, s_0, d_0)

    # result = c_0 xor r_0 xor x_0
    c0 = FpArray(c_bits.limbs[..., 0])
    r_0 = _bit(ctx, r_bits, 0)
    cr = ctx.ShareArray(_xor_pub(r_0.v, c0), a.t)
    return _xor_shares(ctx, cr, x_0)


def _exclusive_suffix_product(ctx, pb: ShareArray) -> ShareArray:
    """powers[i] = prod_{j > i} pb[j] along the last axis.

    Work-efficient Brent-Kung (Blelloch) scan: about 2K multiplies in
    2*log2(K) rounds, against the reference's K SEQUENTIAL multiplies
    (share_comparison.py:155-157) and Hillis-Steele's K*log2(K). The bit
    axis is reversed so the suffix becomes an exclusive prefix, padded
    with identity sharings to the next power of two."""
    K = pb.v.shape[-1]
    Kp = 1 << max(1, (K - 1).bit_length())
    t = pb.t
    v = pb.v.limbs.flip(-1)                           # a fresh tensor
    if Kp > K:
        pad = FpArray.ones(pb.v.shape[:-1] + (Kp - K,), ctx.device)
        v = torch.cat([v, pad.limbs], dim=-1)

    def bmul(lv, rv):
        prod = beaver_multiply_arrays(
            ctx, ctx.ShareArray(FpArray(lv), t),
            ctx.ShareArray(FpArray(rv), t))
        return prod.v.limbs

    # upsweep: fold pair products up the tree (one batched multiply/level)
    d = 1
    while d < Kp:
        v[..., 2 * d - 1::2 * d] = bmul(v[..., 2 * d - 1::2 * d],
                                        v[..., d - 1::2 * d])
        d *= 2
    # clear the root to the identity, then downsweep
    v[..., Kp - 1] = FpArray.ones(pb.v.shape[:-1], ctx.device).limbs
    d = Kp // 2
    while d >= 1:
        left = v[..., d - 1::2 * d].clone()
        right = v[..., 2 * d - 1::2 * d].clone()
        v[..., d - 1::2 * d] = right
        v[..., 2 * d - 1::2 * d] = bmul(right, left)
        d //= 2
    return ctx.ShareArray(FpArray(v[..., :K].flip(-1)), t)


def _exclusive_suffix_product_hs(ctx, pb: ShareArray) -> ShareArray:
    """Hillis-Steele variant (log2(K) rounds, K*log2(K) multiplies) — the
    parity oracle for the Brent-Kung scan, and for latency-bound callers
    that prefer fewer rounds over triple consumption."""
    K = pb.v.shape[-1]
    cur = _shift_left_fill_one(ctx, pb, 1)
    shift = 1
    while shift < K:
        shifted = _shift_left_fill_one(ctx, cur, shift)
        cur = beaver_multiply_arrays(ctx, cur, shifted)
        shift *= 2
    return cur


def _shift_left_fill_one(ctx, sa: ShareArray, k: int) -> ShareArray:
    """out[..., i] = sa[..., i+k] (fill with the constant-1 sharing)."""
    k = min(k, sa.v.shape[-1])
    ones = FpArray.ones(sa.v.shape[:-1] + (k,), ctx.device)
    return ctx.ShareArray(
        FpArray(torch.cat([sa.v.limbs[..., k:], ones.limbs], dim=-1)), sa.t)


def _sum_last(v: FpArray) -> FpArray:
    """Tree-sum over the last axis (local additions)."""
    K = v.shape[-1]
    while K > 1:
        half = K // 2
        s = FpArray(v.limbs[..., 0:half * 2:2]) + \
            FpArray(v.limbs[..., 1:half * 2:2])
        if K % 2:
            s = FpArray.concatenate([s, FpArray(v.limbs[..., K - 1:K])],
                                    axis=s.ndim - 1)
            K = half + 1
        else:
            K = half
        v = s
    return FpArray(v.limbs[..., 0])


def _bit(ctx, bits: ShareArray, i: int) -> ShareArray:
    return ctx.ShareArray(FpArray(bits.v.limbs[..., i]), bits.t)


def _xor_bits_pub(a: FpArray, b_mask) -> FpArray:
    """public bit (field 0/1) XOR bool mask -> field 0/1."""
    b = FpArray.select(b_mask, FpArray.ones(a.shape, a.device),
                       FpArray.zeros(a.shape, a.device))
    two = FpArray.from_int(2, device=a.device)
    return a + b - two * a * b


def install(ctx: MpcContext):
    """Register the comparison mixins on a context (mixin-config
    injection, mpc.py:84-99)."""
    ctx.config[MixinConstants.ShareEquality] = \
        lambda c, x, y: equality(c, x, y)
    ctx.config[MixinConstants.ShareLessThan] = \
        lambda c, x, y: less_than(c, x, y)
    return ctx
