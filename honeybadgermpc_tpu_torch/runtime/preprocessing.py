"""Trusted-dealer preprocessing on the device.

Counterpart of ``honeybadgermpc_tpu/runtime/preprocessing.py``. The dealer
generates whole share tensors [n, count] on the device (dealing = one
sampler launch per draw + one batched encode) and the runtime consumes
them cursor-style. ``save``/``load`` provide the file-backed variant, in
the reference's own file format, so a pool dealt by either package can be
consumed by the other.

Kinds ported so far: ``rands``.

Keys. The dealer carries a Threefry key as two uint32 and derives sub-keys
with ``ops/field_kernels.py::split_key`` (child i = Threefry-2x32(key,
(0x5EED, i))): ``_next_key`` replaces the dealer key by child 0 and hands
out children 1.. — the same carry-and-split discipline as the reference,
with the port's own fixed derivation function. Every function that
consumes a key also accepts explicit key data.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch

from ..interop import from_reference_limbs, to_reference_limbs
from ..ops.field_kernels import split_key
from ..ops.fparray import FpArray
from ..ops.rs import Encoding


def _share_pure(enc: Encoding, degree: int, values: FpArray,
                key_data) -> FpArray:
    """values[B] -> shares[n, B]: random degree-`degree` polynomials with
    the values as constant terms, evaluated at the n party points."""
    B = values.shape[-1]
    hi = FpArray.rand(key_data, (B, degree), device=values.device)
    coeffs = FpArray.concatenate([values.reshape(B, 1), hi], axis=1)
    return enc.encode(coeffs).transpose((1, 0))


def _deal_rands(enc: Encoding, n: int, t: int, k: int, key_data,
                device) -> FpArray:
    """The dealer program for kind ``rands``: [n, k, 1] shares of k fresh
    uniform secrets. Sub-keys 0 and 1 of `key_data` draw the secrets and
    the polynomials' higher coefficients."""
    ks = split_key(key_data, 4)
    r = FpArray.rand(ks[0], (k,), device=device)
    return _share_pure(enc, t, r, ks[1]).reshape(n, k, 1)


class _Pool:
    """A consumable pool of dealt share tensors, each [n, capacity, ...],
    kept as a LIST of segments; take() slices within a segment when
    possible and concatenates only across segments."""

    def __init__(self):
        self.segs: list[FpArray] = []
        self.cursor = 0                    # offset into segs[0]

    def put(self, arr: FpArray):
        self.segs.append(arr)

    def take(self, k: int) -> FpArray:
        if self.remaining() < k:
            raise ValueError(f"preprocessing pool exhausted (have "
                             f"{self.remaining()}, want {k})")
        parts = []
        need = k
        while need:
            seg = self.segs[0]
            avail = seg.shape[1] - self.cursor
            use = min(avail, need)
            parts.append(FpArray(
                seg.limbs[:, :, self.cursor:self.cursor + use]))
            need -= use
            self.cursor += use
            if self.cursor == seg.shape[1]:
                self.segs.pop(0)
                self.cursor = 0
        if len(parts) == 1:
            return parts[0]
        return FpArray.concatenate(parts, axis=1)

    @property
    def data(self) -> FpArray | None:
        """All remaining elements as one tensor (save()/inspection path)."""
        if not self.segs:
            return None
        if self.cursor:
            seg = self.segs[0]
            self.segs[0] = FpArray(seg.limbs[:, :, self.cursor:])
            self.cursor = 0
        if len(self.segs) > 1:
            self.segs = [FpArray.concatenate(self.segs, axis=1)]
        return self.segs[0]

    @data.setter
    def data(self, arr):
        self.segs = [arr] if arr is not None else []
        self.cursor = 0

    def remaining(self):
        return sum(s.shape[1] for s in self.segs) - self.cursor


class PreProcessedElements:
    """Dealer for (n, t); all kinds share one key stream (seeded, so runs
    are reproducible). Tensors live on `device`."""

    def __init__(self, n: int, t: int, seed: int = 0,
                 use_omega_powers: bool = False,
                 device=torch.device("cuda")):
        self.n, self.t = n, t
        self.device = torch.device(device)
        self.enc = Encoding(n, use_omega_powers=use_omega_powers)
        self._key = (0, int(seed) & 0xFFFFFFFF)
        self._pools: dict[str, _Pool] = {}

    def _next_key(self, num=1):
        self._key, *ks = split_key(self._key, num + 1)
        return ks if num > 1 else ks[0]

    def _pool(self, kind: str) -> _Pool:
        return self._pools.setdefault(kind, _Pool())

    # -- generators --------------------------------------------------------
    def generate_rands(self, k: int, key_data=None):
        """Deal k random sharings into the ``rands`` pool; `key_data`
        (two uint32) overrides the dealer's own next key."""
        key = self._next_key() if key_data is None else key_data
        self._pool("rands").put(
            _deal_rands(self.enc, self.n, self.t, k, key, self.device))

    # -- consumers (shapes [n, k, parts]) ----------------------------------
    def get_rands(self, k: int):
        return FpArray(self._pool("rands").take(k).limbs[..., 0])

    # -- persistence (the reference's file format) -------------------------
    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        for kind, pool in self._pools.items():
            if pool.data is None:
                continue
            np.save(os.path.join(path, f"{kind}_{self.n}_{self.t}.npy"),
                    to_reference_limbs(pool.data.limbs))
            with open(os.path.join(
                    path, f"{kind}_{self.n}_{self.t}.meta"), "wb") as f:
                pickle.dump({"cursor": pool.cursor}, f)

    def load(self, path: str):
        """Read ``{kind}_{n}_{t}.npy`` / ``.meta`` files written by this
        class or by the reference's ``PreProcessedElements.save``."""
        for fn in glob.glob(os.path.join(path, f"*_{self.n}_{self.t}.npy")):
            kind = os.path.basename(fn).rsplit(
                f"_{self.n}_{self.t}.npy", 1)[0]
            pool = self._pool(kind)
            pool.data = FpArray(from_reference_limbs(np.load(fn),
                                                     self.device))
            meta = fn[:-4] + ".meta"
            if os.path.exists(meta):
                with open(meta, "rb") as f:
                    pool.cursor = pickle.load(f)["cursor"]
