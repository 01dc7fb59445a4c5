"""Power-sum mixing (reference apps/asynchromix/powermixing.py:12-206 with
the native kernels apps/asynchromix/cpp/compute-power-sums.cpp:17-53 and
solver/solver.cpp).

Counterpart of ``honeybadgermpc_tpu/models/powermixing.py``. Three phases:
 1. per message m with a powers-tuple ([b], [b^2], .., [b^k]): open
    e = m - b, then [m^j] = e^j + sum_l C(j,l) e^(j-l) [b^l]. The public
    coefficient rows C(j,l) e^(j-l) are built for a chunk of j at a time
    and meet ``b_powers`` in one ``mont_mul``, then one tree sum over l: a
    call launches O(k) groups of kernels, not the reference's k(k+1)/2
    multiply-adds (field sums are exact, so the words are the same).
 2. sum the power shares over all messages and batch-open the k power sums.
 3. Newton's identities -> elementary symmetric polynomial coefficients ->
    root finding over GF(p) recovers the (unordered) message set: the C++
    Cantor-Zassenhaus of ``native/hbmpc_native.cpp``, built by
    ``_build.native()`` (a failed build raises); ``find_roots_plain`` is
    its pure-Python twin.
"""

from __future__ import annotations

import random
from functools import lru_cache
from math import comb

import numpy as np
import torch

from .. import _build
from ..ops.fparray import FpArray, dev_const
from ..ops.limbs import P, R_MOD_P, ints_to_limbs
from ..runtime.comparison import _sum_last
from ..runtime.context import MpcContext, ShareArray

# elements of one chunk's coefficient tensor [.., B, j's, l's]: about 2 GB
# of limbs, so the int64 tree sum over l stays within a few times that
CHUNK_ELEMENTS = 1 << 25


def _e_powers(e: FpArray, k: int) -> FpArray:
    """[.., B] -> [.., B, k+1]: e^0 .. e^k by doubling (log2(k) steps of
    two products each)."""
    pows = FpArray.stack([FpArray.ones(e.shape, e.device), e], axis=e.ndim)
    while pows.shape[-1] < k + 1:
        top = FpArray(pows.limbs[..., -1]) * e            # e^len
        pows = FpArray.concatenate(
            [pows, pows * FpArray(top.limbs[..., None])], axis=e.ndim)
    return FpArray(pows.limbs[..., :k + 1])


def _chunks(k: int, width: int):
    """Consecutive ranges [j0, j1] of j = 1..k whose rows j0..j1 over
    l = 1..j1 hold at most `width` (j, l) slots (one j at least)."""
    j0 = 1
    while j0 <= k:
        j1 = j0
        while j1 < k and (j1 + 2 - j0) * (j1 + 1) <= width:
            j1 += 1
        yield j0, j1
        j0 = j1 + 1


@lru_cache(maxsize=None)
def _binomial_words(j0: int, j1: int) -> np.ndarray:
    """Montgomery words [L, nj, j1] of C(j, l) for j = j0..j1, l = 1..j1,
    zero where l > j (a host constant)."""
    return ints_to_limbs(np.array(
        [[comb(j, l) % P * R_MOD_P % P if l <= j else 0
          for l in range(1, j1 + 1)] for j in range(j0, j1 + 1)],
        dtype=object).reshape(j1 - j0 + 1, j1))


def _binomial_rows(j0: int, j1: int, device):
    """(C(j, l) as an FpArray [nj, j1] on `device`; the exponents j - l,
    clamped to 0 where l > j, as a flat index tensor)."""
    js = torch.arange(j0, j1 + 1, device=device)[:, None]
    ls = torch.arange(1, j1 + 1, device=device)[None, :]
    return (FpArray(dev_const(_binomial_words, (j0, j1), device)),
            (js - ls).clamp(min=0).reshape(-1))


def compute_power_shares(ctx: MpcContext, messages: ShareArray,
                         b_powers: ShareArray) -> ShareArray:
    """messages [.., B]; b_powers [.., B, k] (shares of b, b^2, .., b^k) ->
    [m^1..m^k] shares [.., B, k] at the cost of ONE batched open.

    [m^j] = e^j + sum_{l=1..j} C(j,l) e^(j-l) [b^l],  e = m - b (public)."""
    k = b_powers.v.shape[-1]
    b1 = ctx.ShareArray(FpArray(b_powers.v.limbs[..., 0]), b_powers.t)
    e = ctx.open_share_array(messages - b1)            # public [.., B]
    e_pows = _e_powers(e, k)                           # [.., B, k+1]
    lead = e.shape
    width = max(1, CHUNK_ELEMENTS // max(1, int(np.prod(lead))))
    out = []
    for j0, j1 in _chunks(k, width):
        binom, idx = _binomial_rows(j0, j1, e.device)  # [nj, j1]
        nj = j1 - j0 + 1
        gathered = e_pows.limbs[..., idx].reshape(
            e_pows.limbs.shape[:-1] + (nj, j1))        # e^(j-l)
        coef = FpArray(gathered) * binom               # public rows
        bl = FpArray(b_powers.v.limbs[..., None, :j1])  # [.., B, 1, j1]
        terms = coef * bl                              # [.., B, nj, j1]
        out.append(_sum_last(terms) + FpArray(e_pows.limbs[..., j0:j1 + 1]))
    limbs = torch.cat([o.limbs for o in out], dim=-1)  # [L, .., B, k]
    return ctx.ShareArray(FpArray(limbs), messages.t)


def power_sums(ctx: MpcContext, m_powers: ShareArray) -> FpArray:
    """Sum over the message axis and open the k power sums
    (powermixing.py:74-95)."""
    v = m_powers.v                                      # [.., B, k]
    summed = _sum_axis(v, axis=v.ndim - 2)
    return ctx.open_share_array(ctx.ShareArray(summed, m_powers.t))


def newton_inversion(psums: list, k: int) -> list:
    """Power sums p_1..p_k -> elementary symmetric e_1..e_k via Newton's
    identities (host ints; solver.cpp front half)."""
    e = [1]
    for j in range(1, k + 1):
        acc = 0
        sign = 1
        for i in range(1, j + 1):
            acc = (acc + sign * e[j - i] * psums[i - 1]) % P
            sign = -sign
        e.append(acc * pow(j, P - 2, P) % P)
    return e[1:]


def _ascending(elem_sym: list) -> list:
    """x^k - e1 x^(k-1) + e2 x^(k-2) - ... as ascending coefficients."""
    poly = [1]
    for j, ej in enumerate(elem_sym):
        poly.append((-1) ** (j + 1) * ej % P)
    return list(reversed(poly))


def find_roots(elem_sym: list) -> list:
    """Sorted roots of x^k - e1 x^(k-1) + e2 x^(k-2) - ... over GF(p): the
    Cantor-Zassenhaus of native/hbmpc_native.cpp (the role of the
    reference's FLINT solver.cpp). Assumes distinct roots (messages are
    randomized field elements)."""
    k = len(elem_sym)
    buf = b"".join(c.to_bytes(32, "little") for c in _ascending(elem_sym))
    out = _build.native().find_roots(buf)
    roots = sorted(int.from_bytes(out[i * 32:(i + 1) * 32], "little")
                   for i in range(len(out) // 32))
    assert len(roots) == k, f"expected {k} distinct roots, got {len(roots)}"
    return roots


def find_roots_plain(elem_sym: list) -> list:
    """Pure-Python twin of ``find_roots`` (the reference's fallback
    Cantor-Zassenhaus): the same roots, about 20x slower at k = 64."""
    k = len(elem_sym)
    f = _ascending(elem_sym)

    def pmod(a, m):
        a = a[:]
        dm = len(m) - 1
        inv = pow(m[-1], P - 2, P)
        while len(a) - 1 >= dm and any(a):
            da = len(a) - 1
            if a[-1] == 0:
                a.pop()
                continue
            c = a[-1] * inv % P
            off = da - dm
            for i in range(dm + 1):
                a[off + i] = (a[off + i] - c * m[i]) % P
            a.pop()
        return a if a else [0]

    def pmulmod(a, b, m):
        out = [0] * (len(a) + len(b) - 1)
        for i, x in enumerate(a):
            if x:
                for j, y in enumerate(b):
                    out[i + j] = (out[i + j] + x * y) % P
        return pmod(out, m)

    def ppowmod(base, e, m):
        result = [1]
        while e:
            if e & 1:
                result = pmulmod(result, base, m)
            base = pmulmod(base, base, m)
            e >>= 1
        return result

    def pgcd(a, b):
        a, b = a[:], b[:]
        while any(b):
            a = pmod(a, b)
            a, b = b, a
        lead_inv = pow(a[-1], P - 2, P)
        return [c * lead_inv % P for c in a]

    def pdiv(num, den):
        num = num[:]
        out = [0] * (len(num) - len(den) + 1)
        inv = pow(den[-1], P - 2, P)
        while len(num) >= len(den):
            c = num[-1] * inv % P
            off = len(num) - len(den)
            out[off] = c
            for i in range(len(den)):
                num[off + i] = (num[off + i] - c * den[i]) % P
            num.pop()
        return out

    rng = random.Random(0xC0FFEE)

    def split(g):
        """Recursively split a product of distinct linear factors."""
        d = len(g) - 1
        if d == 0:
            return []
        if d == 1:
            return [(-g[0]) * pow(g[1], P - 2, P) % P]
        while True:
            r = rng.randrange(P)
            h = ppowmod([r, 1], (P - 1) // 2, g)   # (x + r)^((p-1)/2) mod g
            h[0] = (h[0] - 1) % P
            d1 = pgcd(g, h)
            if 0 < len(d1) - 1 < d:
                return split(d1) + split(pdiv(g, d1))

    # restrict to the split part: gcd(f, x^p - x) = product of linear factors
    xp = ppowmod([0, 1], P, f)
    if len(xp) < 2:
        xp += [0] * (2 - len(xp))
    xp[1] = (xp[1] - 1) % P
    roots = split(pgcd(f, xp))
    assert len(roots) == k, f"expected {k} distinct roots, got {len(roots)}"
    return sorted(roots)


async def async_mixing(ctx: MpcContext, messages: ShareArray,
                       b_powers: ShareArray) -> list:
    """End-to-end power-mix: returns the sorted plaintext message set."""
    return power_mix(ctx, messages, b_powers)


def power_mix(ctx: MpcContext, messages: ShareArray,
              b_powers: ShareArray) -> list:
    """Mix k shared messages [n, k] with k powers-tuples [n, >= k, >= k]:
    the sorted plaintext messages (party 0's view of the opened sums in
    sim mode; every party's is equal)."""
    k = messages.v.shape[-1]
    assert b_powers.v.shape[-1] >= k
    bp = ctx.ShareArray(FpArray(b_powers.v.limbs[..., :k]), b_powers.t)
    mp = compute_power_shares(ctx, messages, bp)
    sums = power_sums(ctx, mp)
    if ctx.sim:
        sums = FpArray(sums.limbs[:, 0])
    psums = [int(v) for v in sums.to_ints()]
    return find_roots(newton_inversion(psums, k))


def _sum_axis(v: FpArray, axis: int) -> FpArray:
    """Tree-sum a FpArray along an element axis."""
    return _sum_last(FpArray(v.limbs.movedim(axis + 1, -1)))
