"""Montgomery-form GF(p) arithmetic on stacked limb tensors (plain PyTorch).

Counterpart of ``honeybadgermpc_tpu/ops/montgomery.py``. All functions take
and return ``int32[L, *batch]`` limb tensors (16-bit values, limbs leading
— see ops/limbs.py) and do their arithmetic in ``int64``, where none of the
reference's 32-bit carry-save sums can overflow; every result is the same
canonical residue the reference produces, word for word.

The multiplier is the same carry-save CIOS: each outer step does whole
limb-vector ops and keeps the accumulator in redundant form, with a single
carry normalization at the end. ``mont_mul`` on a CUDA tensor launches the
hand-written elementwise kernel (ops/field_kernels.py::mont_mul_pallas,
csrc/mont_mul.cu) at every size; ``_mont_mul_plain`` is its plain version
and serves CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .limbs import (L, MASK, N0, P, P_LIMBS, R2_MOD_P_LIMBS, R_MOD_P,
                    R_MOD_P_LIMBS, W, int_to_limbs, ints_to_limbs,
                    limbs_to_ints)

_P = [int(x) for x in P_LIMBS]

# times the plain multiply ran on CUDA tensors: the card's paths must keep
# this at 0 (only a comparison against the kernel may move it)
plain_calls_on_cuda = 0


def _bshape(a):
    return tuple(a.shape[1:])


def _pstack(shape, device):
    return torch.tensor(_P, dtype=torch.int64, device=device).reshape(
        (L,) + (1,) * len(shape))


def _align2(a, b):
    """Broadcasting aligns trailing dims, which is wrong for the
    limb-LEADING layout when element ranks differ ([L,k] vs [L,B,k] must
    align as [L,1,k]). Insert singleton batch dims right after the limb
    axis so element shapes broadcast by their own trailing-dim rules."""
    s1, s2 = _bshape(a), _bshape(b)
    s = torch.broadcast_shapes(s1, s2)
    if len(s1) < len(s):
        a = a.reshape((L,) + (1,) * (len(s) - len(s1)) + s1)
    if len(s2) < len(s):
        b = b.reshape((L,) + (1,) * (len(s) - len(s2)) + s2)
    return a, b


def _carry_chain(vals):
    """Normalize a list of L limb tensors into canonical limbs plus
    carry-out (sequential 16-step ripple)."""
    c = torch.zeros_like(vals[0])
    out = []
    for j in range(L):
        v = vals[j] + c
        out.append(v & MASK)
        c = v >> W
    return out, c


def _cond_sub_p64(out, hi):
    """int64 canonical limb list `out` (value hi*2^256 + out < 2p) ->
    int64[L, ...] reduced into [0, p)."""
    borrow = torch.zeros_like(out[0])
    d = []
    for j in range(L):
        v = out[j] - _P[j] - borrow
        d.append(v & MASK)
        borrow = (v >> W) & 1
    take = (hi != 0) | (borrow == 0)
    return torch.where(take[None], torch.stack(d, 0), torch.stack(out, 0))


def add_mod(a, b):
    a, b = _align2(a, b)
    s = a.to(torch.int64) + b.to(torch.int64)
    out, carry = _carry_chain([s[j] for j in range(L)])
    return _cond_sub_p64(out, carry).to(torch.int32)


def sub_mod(a, b):
    a, b = _align2(a, b)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    borrow = torch.zeros(torch.broadcast_shapes(_bshape(a), _bshape(b)),
                         dtype=torch.int64, device=a.device)
    d = []
    for j in range(L):
        v = a64[j] - b64[j] - borrow
        d.append(v & MASK)
        borrow = (v >> W) & 1
    carry = torch.zeros_like(borrow)
    dp = []
    for j in range(L):
        v = d[j] + _P[j] + carry
        dp.append(v & MASK)
        carry = v >> W
    neg = borrow != 0
    return torch.where(neg[None], torch.stack(dp, 0),
                       torch.stack(d, 0)).to(torch.int32)


def mont_mul(a, b):
    """a*b*R^{-1} mod p, canonical output (< p). a, b: canonical int32[L,...]
    broadcasting by their element shapes. On a CUDA tensor: the row-9
    kernel (operands materialized at the broadcast shape); on a CPU tensor:
    the plain version."""
    a, b = _align2(a, b)
    if a.is_cuda:
        from .field_kernels import mont_mul_pallas
        shape = (L,) + torch.broadcast_shapes(_bshape(a), _bshape(b))
        return mont_mul_pallas(a.expand(shape), b.expand(shape))
    return _mont_mul_plain(a, b)


def _mont_mul_plain(a, b):
    """Plain PyTorch version of mont_mul: canonical int32[L,...] a, b.

    Redundant accumulator t: [L+1, ...]; per outer step limb j gains at
    most four 16-bit terms plus the limb-0 carry re-injection, so every
    limb stays < 2^23 — the reference's uint32 bound; in int64 there is
    ample room. m is derived from t[0] mod 2^16, which is exact in
    carry-save form."""
    global plain_calls_on_cuda
    a, b = _align2(a, b)
    if a.is_cuda:
        plain_calls_on_cuda += 1
    shape = torch.broadcast_shapes(_bshape(a), _bshape(b))
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64).expand((L,) + shape)
    pst = _pstack(shape, a.device)
    t = torch.zeros((L + 1,) + shape, dtype=torch.int64, device=a.device)
    for i in range(L):
        prod = a64[i][None] * b64
        t[:L] += prod & MASK
        t[1:] += prod >> W
        m = ((t[0] & MASK) * N0) & MASK
        mprod = m[None] * pst
        t[:L] += mprod & MASK
        t[1:] += mprod >> W
        carry0 = t[0] >> W                      # t[0] = 0 mod 2^16 now
        t = torch.cat([t[1:], torch.zeros_like(t[:1])], 0)
        t[0] += carry0
    out, _ = _carry_chain([t[j] for j in range(L)])
    return _cond_sub_p64(out, torch.zeros_like(out[0])).to(torch.int32)


RAND_LIMBS = 24        # 384-bit draws: distance to uniform mod p < 2^-129
_REDC384_ROUNDS = 9


def _redc384_rows(rows):
    """24 int64 halfword rows -> int64[L, ...] canonical limbs of
    T * 2^-144 mod p (shared by redc384 and the plain field sampler)."""
    rows = list(rows) + [torch.zeros_like(rows[0])]
    for _ in range(_REDC384_ROUNDS):
        m = ((rows[0] & MASK) * N0) & MASK
        for j in range(L):
            mp = m * _P[j]
            rows[j] = rows[j] + (mp & MASK)
            rows[j + 1] = rows[j + 1] + (mp >> W)
        carry0 = rows[0] >> W                   # rows[0] = 0 mod 2^16
        rows = rows[1:]
        rows[0] = rows[0] + carry0
    # 25 - 9 = 16 rows remain, value < 2^240 + p < 2p
    out, carry = _carry_chain(rows)
    return _cond_sub_p64(out, carry)


def redc384(t_limbs):
    """Canonical limbs (< p) of T * 2^-144 mod p from a 384-bit value T
    given as int32[24, ...] 16-bit limbs (little-endian).

    Nine rounds of (m = -t/p mod 2^16; t += m*p; t >>= 16) leave a value
    < 2p, so one conditional subtract canonicalizes. Multiplication by the
    constant 2^-144 is a bijection on Z_p, so T uniform on [0, 2^384)
    gives an output within 2^-129 of uniform."""
    if t_limbs.shape[0] != RAND_LIMBS:
        raise ValueError(f"expected {RAND_LIMBS} limb rows, got "
                         f"{tuple(t_limbs.shape)}")
    t64 = t_limbs.to(torch.int64)
    return _redc384_rows([t64[j] for j in range(RAND_LIMBS)]).to(torch.int32)


def const_stack(limbs_np, shape, device):
    """uint32[L] numpy limbs -> broadcast int32[L, *shape] tensor on
    `device` (no default: a constant is built where its user lives)."""
    t = torch.from_numpy(np.asarray(limbs_np, np.int64).astype(np.int32))
    return t.to(device).reshape((L,) + (1,) * len(shape)).expand(
        (L,) + tuple(shape))


def to_mont(a):
    """Plain residue (any 256-bit value) -> Montgomery form of (a mod p)."""
    return mont_mul(a, const_stack(R2_MOD_P_LIMBS, _bshape(a), a.device))


def from_mont(a):
    """Montgomery form -> plain residue in [0, p)."""
    return mont_mul(a, const_stack(int_to_limbs(1), _bshape(a), a.device))


def one_mont(shape, device):
    return const_stack(R_MOD_P_LIMBS, shape, device)


def is_zero_mask(a):
    return (a == 0).all(0)


def eq_mask(a, b):
    a, b = _align2(a, b)
    return (a == b).all(0)


def neg_mod(a):
    """p - a (a < p, so no borrow escapes), with -0 = 0."""
    a64 = a.to(torch.int64)
    borrow = torch.zeros_like(a64[0])
    d = []
    for j in range(L):
        v = _P[j] - a64[j] - borrow
        d.append(v & MASK)
        borrow = (v >> W) & 1
    out = torch.stack(d, 0)
    return torch.where(is_zero_mask(a)[None], torch.zeros_like(out),
                       out).to(torch.int32)


def select(mask, a, b):
    """where(mask, a, b) on stacked limbs; mask has the batch shape."""
    return torch.where(mask[None], a, b)


def mont_sqr(a):
    return mont_mul(a, a)


def pow_const(a, e: int):
    """a**e for a constant int exponent: square-and-multiply over the bits
    of e from the top. Every product is a canonical Montgomery residue, so
    the result is the reference's word for word (its lax.scan computes the
    unused products too and selects them away)."""
    if e == 0:
        return one_mont(_bshape(a), a.device)
    if e < 0:
        return pow_const(inv_mod(a), -e)
    acc = None
    for bit in bin(e)[2:]:
        if acc is not None:
            acc = mont_sqr(acc)
        if bit == "1":
            acc = a if acc is None else mont_mul(acc, a)
    return acc


def inv_mod(a):
    """Batched modular inverse via Fermat: a^(p-2); inv(0) = 0 (callers
    mask). On a CUDA tensor the square-and-multiply chain of ``pow_const``
    (385 launches of the mont_mul kernel); on a CPU tensor the same
    canonical words from Python's ``pow`` on the host (``_inv_mod_host``),
    where the chain's plain multiplies cost about a second per call."""
    if a.is_cuda:
        return pow_const(a, P - 2)
    return _inv_mod_host(a)


_RINV = pow(R_MOD_P, P - 2, P)


def _inv_mod_host(a):
    """inv_mod of a CPU limb tensor int32 [L, ...]: for the Montgomery word
    w = xR the chain's result is x^(p-2) R = x^-1 R mod p (0 for 0)."""
    w = limbs_to_ints(a.contiguous().numpy().view(np.uint32))
    inv = np.vectorize(
        lambda v: pow(int(v) * _RINV % P, P - 2, P) * R_MOD_P % P,
        otypes=[object])(w)
    return torch.from_numpy(ints_to_limbs(inv).view(np.int32)).reshape(
        a.shape)


# Tonelli-Shanks static data: p - 1 = q * 2^s with s = 32; nonresidue z = 5.
_TS_S = 32
_TS_Q = (P - 1) >> _TS_S
_TS_ZQ = pow(5, _TS_Q, P)


def sqrt_mod(a):
    """Batched constant-structure Tonelli-Shanks (cf. RFC 9380 G.4), step
    for step the reference's: t = a^q, r = a^((q+1)/2), c = z^q; then for
    i = s, s-1, ..., 2: b = t squared i-2 times; where b != 1, r *= c and
    t *= c^2; c = c^2. Returns (root, has_root_mask); root*root == a where
    the mask is set. The root the algorithm lands on (not just any square
    root) is part of the function: generate_bits takes its sign from it.
    Every product is a mont_mul, so on a CUDA tensor each one launches the
    elementwise kernel."""
    shape = _bshape(a)
    one = one_mont(shape, a.device)
    t = pow_const(a, _TS_Q)
    r = pow_const(a, (_TS_Q + 1) // 2)
    c = to_mont(const_stack(int_to_limbs(_TS_ZQ), shape, a.device))
    for idx in range(_TS_S - 1):
        i = _TS_S - idx                    # i runs s, s-1, ..., 2
        b = t
        for _ in range(i - 2):
            b = mont_sqr(b)
        need = ~eq_mask(b, one)
        c2 = mont_sqr(c)
        r = select(need, mont_mul(r, c), r)
        t = select(need, mont_mul(t, c2), t)
        c = c2
    has_root = eq_mask(mont_sqr(r), a) | is_zero_mask(a)
    return r, has_root
