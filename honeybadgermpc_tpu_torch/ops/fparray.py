"""FpArray: an array of GF(p) elements in Montgomery form over a tensor.

Counterpart of ``honeybadgermpc_tpu/ops/fparray.py``. Storage is
``int32[L, *shape]`` (limbs leading, element axes minor — see
ops/limbs.py). All arithmetic stays in Montgomery form; conversion happens
only at the host boundary (``from_ints`` / ``to_ints``). A plain class over
one tensor: PyTorch runs eagerly, so there is no pytree registration and
no jitted entry points.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import montgomery as mont
from .limbs import L, P, int_to_limbs, ints_to_limbs, limbs_to_ints

_CUDA = torch.device("cuda")


def _numel(shape):
    out = 1
    for d in shape:
        out *= d
    return out


def _to_tensor(host_u32: np.ndarray, device):
    """np.uint32 limb array -> int32 tensor on `device` (same bits)."""
    return torch.from_numpy(
        np.ascontiguousarray(host_u32, dtype=np.uint32).view(np.int32)
    ).to(torch.device(device))


@lru_cache(maxsize=None)
def dev_const(builder, args: tuple, device):
    """Device copy of the host constant ``builder(*args)`` (a host-cached
    np.uint32 limb array), cached per (builder, args, device): constants
    go to each device once."""
    return _to_tensor(builder(*args), device)


class FpArray:
    """Array of field elements; shape excludes the limb axis."""

    __slots__ = ("limbs",)

    def __init__(self, limbs):
        self.limbs = limbs  # int32[L, *shape], Montgomery form, canonical

    # -- construction ------------------------------------------------------
    @classmethod
    def from_ints(cls, xs, device=_CUDA):
        """Host: Python ints / object array -> Montgomery-form FpArray."""
        arr = np.asarray(xs, dtype=object)
        if arr.ndim == 0:
            plain = ints_to_limbs(np.array(int(arr[()]) % P, dtype=object))
        else:
            plain = ints_to_limbs(
                np.vectorize(lambda v: int(v) % P, otypes=[object])(arr))
        return cls(mont.to_mont(_to_tensor(plain, device)))

    @classmethod
    def from_int(cls, x: int, shape=(), device=_CUDA):
        """x at every element of `shape`: one limb vector (Montgomery form
        computed on the host) broadcast on the device."""
        shape = tuple(shape)
        one = _to_tensor(int_to_limbs(pow(2, 256, P) * x % P), device)
        return cls(one.reshape((L,) + (1,) * len(shape)).expand(
            (L,) + shape).contiguous())

    @classmethod
    def zeros(cls, shape=(), device=_CUDA):
        return cls.from_int(0, shape, device)

    @classmethod
    def ones(cls, shape=(), device=_CUDA):
        return cls.from_int(1, shape, device)

    @classmethod
    def rand(cls, key_data, shape=(), device=_CUDA):
        """Uniform field elements, statistical distance < 2^-129 from
        uniform: a 384-bit Threefry draw per element sent through the
        9-round reduction (ops/montgomery.py::redc384). The canonical
        output limbs are used DIRECTLY as the Montgomery representation —
        the represented value is a fixed bijection of the uniform draw.

        `key_data` is explicit Threefry key data (two uint32). The draw
        always uses the sampler kernel's counter layout
        (ops/field_kernels.py::rand_limbs), on the card and on the CPU
        alike, so one key gives one value everywhere."""
        from .field_kernels import rand_limbs
        shape = tuple(shape)
        numel = _numel(shape)
        if numel == 0:
            return cls(torch.zeros((L,) + shape, dtype=torch.int32,
                                   device=torch.device(device)))
        return cls(rand_limbs(key_data, numel, device).reshape((L,) + shape))

    # -- host extraction ---------------------------------------------------
    def to_ints(self) -> np.ndarray:
        """Object ndarray of Python ints in [0, p)."""
        plain = mont.from_mont(self.limbs)
        return limbs_to_ints(plain.cpu().numpy())

    # -- shape plumbing ----------------------------------------------------
    @property
    def shape(self):
        return tuple(self.limbs.shape[1:])

    @property
    def ndim(self):
        return self.limbs.dim() - 1

    @property
    def device(self):
        return self.limbs.device

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return FpArray(self.limbs.reshape((L,) + tuple(shape)))

    def transpose(self, axes=None):
        if axes is None:
            axes = tuple(reversed(range(self.ndim)))
        return FpArray(self.limbs.permute((0,) + tuple(a + 1 for a in axes)))

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return FpArray(self.limbs[(slice(None),) + idx])

    def at_set(self, idx, value: "FpArray"):
        """A copy with the elements at `idx` replaced by `value`."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        limbs = self.limbs.clone()
        limbs[(slice(None),) + idx] = value.limbs
        return FpArray(limbs)

    def broadcast_to(self, shape):
        shape = tuple(shape)
        limbs = self.limbs
        if self.ndim < len(shape):
            limbs = limbs.reshape(
                (L,) + (1,) * (len(shape) - self.ndim) + self.shape)
        return FpArray(limbs.expand((L,) + shape))

    def take(self, indices, axis=0):
        idx = torch.as_tensor(indices, dtype=torch.int64, device=self.device)
        return FpArray(self.limbs.index_select(axis + 1, idx))

    @staticmethod
    def concatenate(arrays, axis=0):
        return FpArray(torch.cat([a.limbs for a in arrays], dim=axis + 1))

    @staticmethod
    def stack(arrays, axis=0):
        return FpArray(torch.stack([a.limbs for a in arrays], dim=axis + 1))

    # -- arithmetic --------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, FpArray):
            return other
        if isinstance(other, int):
            return FpArray.from_int(other, device=self.device)
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return FpArray(mont.add_mod(self.limbs, o.limbs))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return FpArray(mont.sub_mod(self.limbs, o.limbs))

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return FpArray(mont.sub_mod(o.limbs, self.limbs))

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return FpArray(mont.mont_mul(self.limbs, o.limbs))

    __rmul__ = __mul__

    def __neg__(self):
        return FpArray(mont.neg_mod(self.limbs))

    def square(self):
        return FpArray(mont.mont_sqr(self.limbs))

    def inv(self):
        """Elementwise inverse (Fermat; inv(0) = 0)."""
        return FpArray(mont.inv_mod(self.limbs))

    def pow_static(self, e: int):
        return FpArray(mont.pow_const(self.limbs, e))

    def sqrt(self):
        """(root, has_root mask): the constant-structure Tonelli-Shanks of
        ops/montgomery.py::sqrt_mod."""
        r, ok = mont.sqrt_mod(self.limbs)
        return FpArray(r), ok

    # -- predicates --------------------------------------------------------
    def is_zero(self):
        return mont.is_zero_mask(self.limbs)

    def eq(self, other):
        o = self._coerce(other)
        return mont.eq_mask(self.limbs, o.limbs)

    @staticmethod
    def select(mask, a: "FpArray", b: "FpArray"):
        """where(mask, a, b) — mask broadcasts over the element shape."""
        return FpArray(mont.select(mask, a.limbs, b.limbs))

    def __repr__(self):
        return f"FpArray(shape={self.shape}, device={self.device})"
