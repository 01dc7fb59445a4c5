"""Limb decomposition constants and host-side conversions for GF(p).

The BLS12-381 scalar field prime is a 255-bit prime. Field elements are
decomposed into 16 limbs of 16 bits each (values always < 2**16 between
kernel steps). All device-side arithmetic is Montgomery-form (R = 2**256),
so modular multiplication is a carry-save CIOS loop of 16x16->32-bit
products that never overflows 32 bits:
    a*b + c + d <= (2^16-1)^2 + 2*(2^16-1) = 2^32 - 1.

Layout convention: limbs are the LEADING axis — ``[L, *shape]`` — so the
element axes stay minor and neighbouring GPU threads touch neighbouring
addresses; the limb axis is unrolled in kernels.

This is the port's own copy of the reference's pure-numpy helpers (same
names, same values); the host arrays here are ``np.uint32`` exactly as in
the reference, the torch tensors built from them are ``int32`` (see the
package docstring).
"""

from __future__ import annotations

import numpy as np

# BLS12-381 scalar field modulus.
P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

W = 16                    # bits per limb
L = 16                    # number of limbs (256 bits total)
MASK = (1 << W) - 1
R = 1 << (W * L)          # Montgomery radix 2**256
R_MOD_P = R % P
R2_MOD_P = (R * R) % P
N0 = (-pow(P, -1, 1 << W)) % (1 << W)   # -p^{-1} mod 2**16, the CIOS m-factor


def int_to_limbs(x: int) -> np.ndarray:
    """Python int (< 2**256) -> uint32[L] little-endian 16-bit limbs."""
    return np.array([(x >> (W * i)) & MASK for i in range(L)], dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    """uint32[L] -> Python int."""
    return sum(int(limbs[i]) << (W * i) for i in range(L))


def ints_to_limbs(xs, dtype=np.uint32) -> np.ndarray:
    """Iterable/array of Python ints -> uint32[L, *shape] limb array.

    Accepts nested lists or numpy object arrays; the output's trailing shape
    matches the input's shape.
    """
    arr = np.asarray(xs, dtype=object)
    flat = arr.reshape(-1)
    out = np.empty((L, flat.shape[0]), dtype=dtype)
    for j, v in enumerate(flat):
        v = int(v)
        for i in range(L):
            out[i, j] = (v >> (W * i)) & MASK
    return out.reshape((L,) + arr.shape)


def limbs_to_ints(limbs) -> np.ndarray:
    """uint32[L, *shape] -> object array of Python ints with shape *shape."""
    limbs = np.asarray(limbs)
    shape = limbs.shape[1:]
    flat = limbs.reshape(L, -1)
    out = np.empty(flat.shape[1], dtype=object)
    for j in range(flat.shape[1]):
        out[j] = sum(int(flat[i, j]) << (W * i) for i in range(L))
    return out.reshape(shape)


P_LIMBS = int_to_limbs(P)
R_MOD_P_LIMBS = int_to_limbs(R_MOD_P)     # Montgomery form of 1
R2_MOD_P_LIMBS = int_to_limbs(R2_MOD_P)
