"""Hybrid public-key cryptosystem: Jubjub Diffie-Hellman + MiMC-CTR.

Counterpart of ``honeybadgermpc_tpu/models/mimc_jubjub_pkc.py`` (the
reference's progs/mimc_jubjub_pkc.py:9-79).

Key generation: bitwise-shared private key [x] with public key X = [x]G
opened; encryption (public side): ephemeral k, shared point kX -> MiMC-CTR
keystream; decryption under MPC: [x]*(kG) via share_mul, then the pads
subtracted. As in the reference, the pads are computed with the plaintext
MiMC once the shared point's x-coordinate (the symmetric seed) is opened.
"""

from __future__ import annotations

from ..elliptic_curve import Point
from ..runtime.context import MpcContext, ShareArray
from .jubjub import share_mul
from .mimc import mimc_plain

# generator GP of the prime-order subgroup (reference mimc_jubjub_pkc.py:9)
GP = Point(
    5,
    6846412461894745224441235558443359243034138132682534265960483512729196124138,  # noqa: E501
)

KEY_BITS = 64  # bitwise-shared key length (tests use a shorter key;
               # the reference's original uses the full field width)


def key_generation(ctx: MpcContext, key_bits: int = KEY_BITS):
    """-> (bitwise-shared private key [.., 1, key_bits], public Point)
    (reference :14-26)."""
    bits = ctx.from_preproc(ctx.preproc.get_bits(key_bits))
    bits = ctx.ShareArray(bits.v.reshape(
        bits.v.shape[:ctx.lead] + (1, key_bits)), bits.t)
    pub_shared = share_mul(ctx, bits, GP)
    x, y = pub_shared.open()
    return bits, Point(int(x.to_ints()[0][0]), int(y.to_ints()[0][0]))


def mimc_encrypt(public_key: Point, messages: list, ephemeral_key: int):
    """Public-side hybrid encryption (reference :29-49): kG and
    ciphertexts c_i = m_i + MiMC_plain(key=(kX).x, nonce=i)."""
    kg = GP * ephemeral_key
    kx = public_key * ephemeral_key
    seed = int(kx.x)
    cts = [(m + mimc_plain(i, seed)) % GP.curve.field.modulus
           for i, m in enumerate(messages)]
    return kg, cts


def mimc_decrypt(ctx: MpcContext, priv_bits: ShareArray, kg: Point,
                 ciphertexts: list):
    """MPC decryption (reference :52-79): [x]*(kG) by share_mul, its
    x-coordinate opened as the symmetric seed, then each pad computed with
    the plaintext MiMC and subtracted."""
    shared_pt = share_mul(ctx, priv_bits, kg)
    x, _ = shared_pt.open()
    seed = int(x.to_ints()[0][0])
    p = GP.curve.field.modulus
    return [(c - mimc_plain(i, seed)) % p for i, c in enumerate(ciphertexts)]
