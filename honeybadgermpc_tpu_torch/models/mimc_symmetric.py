"""MiMC symmetric encryption over shares (reference
progs/mimc_symmetric.py:10-27): ciphertext_i = m_i + MiMC_[k](nonce + i)
with a SHARED key; decryption subtracts the regenerated pads.

Counterpart of ``honeybadgermpc_tpu/models/mimc_symmetric.py``."""

from __future__ import annotations

from ..ops.fparray import FpArray
from ..runtime.context import MpcContext, ShareArray
from .mimc import mimc_mpc_shared_key


def _pads(ctx: MpcContext, key_share: ShareArray, B: int, nonce: int):
    ctr = FpArray.from_ints([nonce + i for i in range(B)], device=ctx.device)
    return mimc_mpc_shared_key(ctx, ctr, key_share)


def mimc_encrypt(ctx: MpcContext, key_share: ShareArray, blocks: ShareArray,
                 nonce: int = 0):
    """Returns PUBLIC ciphertexts (opened), like the reference, which
    publishes cipher = m + MiMC_k(nonce+i)."""
    return (blocks + _pads(ctx, key_share, blocks.v.shape[-1], nonce)).open()


def mimc_decrypt(ctx: MpcContext, key_share: ShareArray, ciphertexts: FpArray,
                 nonce: int = 0) -> ShareArray:
    """Public ciphertexts -> shares of the plaintexts."""
    pads = _pads(ctx, key_share, ciphertexts.shape[-1], nonce)
    return ctx.ShareArray(ciphertexts - pads.v, pads.t)
