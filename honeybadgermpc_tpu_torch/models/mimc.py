"""MiMC block cipher over secret shares (reference progs/mimc.py).

Counterpart of ``honeybadgermpc_tpu/models/mimc.py``. Batched: one call
encrypts a whole tensor of message shares in ROUND = ceil(log3 p) = 161
rounds; each round costs exactly one batched open (the preprocessed-cube
trick, mimc.py:25-30):

    open e = x - r;   x^3 = 3e*r^2 + 3e^2*r + e^3 + r^3
"""

from __future__ import annotations

from math import ceil, log

from ..elliptic_curve import Subgroup
from ..ops.fparray import FpArray
from ..runtime.context import MpcContext, ShareArray

ROUND = ceil(log(Subgroup.BLS12_381, 3))  # 161


def mimc_plain(x: int, k: int) -> int:
    """Plaintext oracle (reference mimc.py:11-15)."""
    p = Subgroup.BLS12_381
    inp = x
    for ctr in range(ROUND):
        inp = pow((inp + k + ctr) % p, 3, p)
    return (inp + k) % p


def _cube(x: ShareArray, e: FpArray, r, r2, r3) -> ShareArray:
    """x^3 from the opened e = x - r and the cube shares r, r^2, r^3."""
    three = FpArray.from_int(3, device=e.device)
    e2 = e * e
    v = (e * three) * r2 + (e2 * three) * r + e2 * e + r3
    return x.ctx.ShareArray(v, x.t)


def cube_shares(ctx: MpcContext, x: ShareArray) -> ShareArray:
    B = x.v.shape[-1]
    r, r2, r3 = ctx.preproc.get_cubes(B)
    return _cube(x, (x - ctx.from_preproc(r)).open(), r, r2, r3)


def mimc_mpc_batch(ctx: MpcContext, xs: ShareArray, k) -> ShareArray:
    """Encrypt share tensor xs [n, B] under public key k (reference
    mimc.py:40-64): ONE pool take of ROUND*B cubes, laid out by round, then
    161 sequential rounds, each one batched open (the context's, padded to
    a multiple of t+1 and counted in ``nerr_total``). The reference's
    per-round takes of B slice the pool the same way, so the words are
    the same."""
    dev = ctx.device
    if isinstance(k, int):
        k = FpArray.from_int(k, device=dev)
    B = xs.v.shape[-1]
    r, r2, r3 = (a.limbs.reshape(a.limbs.shape[:-1] + (ROUND, B))
                 for a in ctx.preproc.get_cubes(ROUND * B))
    inp = xs
    for ctr in range(ROUND):
        x = inp + (k + FpArray.from_int(ctr, device=dev))
        ri = FpArray(r[..., ctr, :])
        inp = _cube(x, (x - ctx.from_preproc(ri)).open(), ri,
                    FpArray(r2[..., ctr, :]), FpArray(r3[..., ctr, :]))
    return inp + k


# the reference's jitted lax.scan over one take (mimc.py:56-109); PyTorch
# runs eagerly, so it is the same loop
mimc_mpc_batch_jit = mimc_mpc_batch


def mimc_encrypt_ctr(ctx: MpcContext, key_share: ShareArray, nonce: int,
                     blocks: ShareArray) -> ShareArray:
    """MiMC-CTR symmetric encryption over a SHARED key (reference
    progs/mimc_symmetric.py): ciphertext_i = block_i + MiMC_k(nonce + i)."""
    B = blocks.v.shape[-1]
    ctr_pub = FpArray.from_ints([nonce + i for i in range(B)],
                                device=ctx.device)
    return blocks + mimc_mpc_shared_key(ctx, ctr_pub, key_share)


def mimc_mpc_shared_key(ctx: MpcContext, xs_pub: FpArray,
                        key_share: ShareArray) -> ShareArray:
    """MiMC with public input and SHARED key (the symmetric mode). x starts
    public; after the first round it is a share."""
    B = xs_pub.shape[-1]
    kb = _broadcast_key(ctx, key_share, B)
    inp = cube_shares(ctx, kb + xs_pub)
    for ctr in range(1, ROUND):
        inp = cube_shares(ctx, inp + kb + FpArray.from_int(ctr,
                                                           device=ctx.device))
    return inp + kb


def _broadcast_key(ctx: MpcContext, key_share: ShareArray,
                   B: int) -> ShareArray:
    kv = key_share.v
    assert kv.shape[-1] == 1
    return ctx.ShareArray(
        FpArray(kv.limbs.expand(kv.limbs.shape[:-1] + (B,))), key_share.t)
