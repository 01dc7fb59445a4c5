"""Field kernels of the port — counterpart of ``ops/pallas_field.py``.

So far: the field sampler ``rand_limbs`` (the reference's
``rand_limbs_pallas``). Element e draws Threefry-2x32-20 with counters
(s, e), s = 0..5, taking the words of each call in the order
w0.lo, w0.hi, w1.lo, w1.hi — 24 halfwords = 384 bits — and sends them
through the 9-round ``redc384``; the canonical limbs are used directly as
the Montgomery representation. Threefry is a fixed function, so for the
same key data the output is bit-identical to the reference kernel's.

On a CUDA device the sampler is the hand-written kernel
``csrc/rand_limbs.cu``; ``_rand_limbs_plain`` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import montgomery as mont
from .fused_open import _launch_stream
from .limbs import L, MASK, W

_TF_ROT_A = (13, 15, 26, 6)
_TF_ROT_B = (17, 29, 16, 24)
_M32 = 0xFFFFFFFF

launches = 0      # times the CUDA kernel was launched (and nowhere else)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on Python ints or int64 tensors holding
    uint32 values (k0, k1 ints). The CUDA twin is field_core.cuh's."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for g in range(5):
        rots = _TF_ROT_A if g % 2 == 0 else _TF_ROT_B
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def split_key(key_data, num: int):
    """Derive `num` sub-keys from a Threefry key (two uint32): child i is
    the two output words of Threefry-2x32(key, counter = (0x5EED, i)).
    This is the port's own derivation (a fixed, documented function); it
    does not reproduce ``jax.random.split``. A parent key is only ever
    split, never drawn from, so children of different parents and the
    sampler's (s, e) counters never meet under one key."""
    k0, k1 = _key_ints(key_data)
    return [_threefry2x32(k0, k1, 0x5EED, i) for i in range(num)]


def _key_ints(key_data):
    """Key data (a pair of ints, numpy uint32[2] or a tensor) -> (k0, k1)."""
    if isinstance(key_data, torch.Tensor):
        key_data = key_data.tolist()
    k0, k1 = (int(x) & _M32 for x in key_data)
    return k0, k1


def _rand_limbs_plain(key_data, numel: int, device):
    """Plain PyTorch version of the sampler: int32 [L, numel] on `device`."""
    k0, k1 = _key_ints(key_data)
    e = torch.arange(numel, dtype=torch.int64, device=device)
    rows = []
    for s in range(6):                       # 6 calls x 64 bits = 384 bits
        w0, w1 = _threefry2x32(k0, k1, torch.full_like(e, s), e)
        for wrd in (w0, w1):
            rows.append(wrd & MASK)
            rows.append(wrd >> W)
    return mont._redc384_rows(rows).to(torch.int32)


def _rand_limbs_cuda(key_data, numel: int, device):
    """Launch csrc/rand_limbs.cu: int32 [L, numel] on the CUDA `device`."""
    global launches
    from .._build import lib
    k0, k1 = _key_ints(key_data)
    out = torch.empty((L, numel), dtype=torch.int32, device=device)
    rc = lib().hb_rand_limbs(k0, k1, out.data_ptr(), numel,
                             _launch_stream(out))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"rand_limbs kernel launch failed: CUDA error {rc}")
    return out


def rand_limbs(key_data, numel: int, device=torch.device("cuda")):
    """Threefry key (two uint32) -> int32 [L, numel] canonical limbs, each
    element uniform mod p (distance < 2^-129). Counter layout: element
    index e uses Threefry counters (s, e), s = 0..5."""
    device = torch.device(device)
    if not 0 < numel < (1 << 32):
        raise ValueError(f"numel must be in (0, 2^32), got {numel}")
    if device.type == "cuda":
        return _rand_limbs_cuda(key_data, numel, device)
    return _rand_limbs_plain(key_data, numel, device)
