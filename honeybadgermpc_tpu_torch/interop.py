"""State carried across: tensors and files shared with the reference.

The reference keeps limbs and packed words as ``uint32`` arrays; the port
keeps the same bits in ``int32`` tensors (see the package docstring). These
helpers convert at that boundary without touching a bit, so limb tensors,
packed share tensors (flat ``[PL, n, B]`` and the extraction's 4D
``[PL, n, R, S]`` alike), Threefry key data and saved preprocessing pools
move between the two packages unchanged. (The pool files themselves are
read and written by
``runtime/preprocessing.py::PreProcessedElements.load`` / ``save``.)
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.fused_open import PL
from .ops.limbs import L


def _from_u32(arr, lead: int, what: str, device):
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or arr.ndim < 1 or arr.shape[0] != lead:
        raise ValueError(f"{what} must be np.uint32 [{lead}, ...], got "
                         f"{arr.dtype} {arr.shape}")
    # np.array copies: the source may be a read-only view of foreign memory
    return torch.from_numpy(
        np.array(arr, order="C").view(np.int32)).to(torch.device(device))


def _to_u32(t, lead: int, what: str) -> np.ndarray:
    if t.dtype != torch.int32 or t.dim() < 1 or t.shape[0] != lead:
        raise ValueError(f"{what} must be int32 [{lead}, ...], got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous().cpu().numpy().view(np.uint32)


def from_reference_limbs(limbs, device=torch.device("cuda")):
    """np.uint32 [L, ...] limb array of the reference -> int32 tensor."""
    return _from_u32(limbs, L, "limbs", device)


def to_reference_limbs(limbs) -> np.ndarray:
    """int32 [L, ...] limb tensor -> np.uint32 array for the reference."""
    return _to_u32(limbs, L, "limbs")


def from_reference_packed(packed, device=torch.device("cuda")):
    """np.uint32 [PL, ...] packed words of the reference -> int32 tensor."""
    return _from_u32(packed, PL, "packed words", device)


def to_reference_packed(packed) -> np.ndarray:
    """int32 [PL, ...] packed tensor -> np.uint32 array for the reference."""
    return _to_u32(packed, PL, "packed words")


def from_reference_key(key_data):
    """Key data of the reference (``jax.random.key_data`` of a Threefry
    key, as a numpy uint32[2]) -> the port's key data, a pair of ints."""
    arr = np.asarray(key_data)
    if arr.dtype != np.uint32 or arr.shape != (2,):
        raise ValueError(f"key data must be np.uint32 [2], got "
                         f"{arr.dtype} {arr.shape}")
    return int(arr[0]), int(arr[1])


def to_reference_key(key_data) -> np.ndarray:
    """The port's key data (a pair of ints) -> np.uint32 [2]."""
    k0, k1 = key_data
    return np.array([int(k0), int(k1)], dtype=np.uint32)


def from_reference_receive(cols, device=torch.device("cuda")):
    """The reference's receive tensor np.uint32 [nblk, njt, PL, n, JT, TBW]
    (slot block, destination group, word, source, destination within the
    group, slot within the block) -> the port's int32 [PL, dst, src, sp]
    (ops/fused_randousha.py). A pure permutation."""
    arr = np.asarray(cols)
    if arr.dtype != np.uint32 or arr.ndim != 6 or arr.shape[2] != PL:
        raise ValueError(f"receive tensor must be np.uint32 [nblk, njt, "
                         f"{PL}, n, JT, TBW], got {arr.dtype} {arr.shape}")
    nblk, njt, _, n, jt, tbw = arr.shape
    out = arr.transpose(2, 1, 4, 3, 0, 5).reshape(PL, njt * jt, n,
                                                  nblk * tbw)
    return _from_u32(out, PL, "receive tensor", device)


def from_reference_check(chk, device=torch.device("cuda")):
    """The reference's per-column check tensor np.uint32 [nblk, njt, PL,
    JT, ncheckp, TBW] (slot block, party group, word, party within the
    group, check column, slot within the block) -> the port's int32
    [PL, n, ncheckp, sp] (ops/fused_randousha.py). A pure permutation. The
    check outputs need none: vals [PL, ncheckp, sp] has one layout in both
    packages, errs is the reference's [1, ncheckp, sp] without its 1."""
    arr = np.asarray(chk)
    if arr.dtype != np.uint32 or arr.ndim != 6 or arr.shape[2] != PL:
        raise ValueError(f"check tensor must be np.uint32 [nblk, njt, {PL}, "
                         f"JT, ncheckp, TBW], got {arr.dtype} {arr.shape}")
    nblk, njt, _, jt, ncheckp, tbw = arr.shape
    out = arr.transpose(2, 1, 3, 4, 0, 5).reshape(PL, njt * jt, ncheckp,
                                                  nblk * tbw)
    return _from_u32(out, PL, "check tensor", device)
