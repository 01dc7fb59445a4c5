"""Trusted-dealer preprocessing on the device.

Counterpart of ``honeybadgermpc_tpu/runtime/preprocessing.py``. The dealer
generates whole share tensors [n, count] on the device (dealing = one
sampler launch per draw + one batched encode) and the runtime consumes
them cursor-style. ``save``/``load`` provide the file-backed variant, in
the reference's own file format, so a pool dealt by either package can be
consumed by the other.

Kinds (the reference's names and pool shapes): triples ``[n, k, 3]``,
cubes ``[n, k, 3]``, rands, zeros, bits and one_minus_ones ``[n, k, 1]``,
double_shares ``[n, k, 2]``, share_bits ``[n, k, 256]`` (r, then its 255
bits, least significant first), powers ``[n, x_count, k]`` and share
(pools ``share_d{degree}``, ``[n, 1, 1]``).

Keys. The dealer carries a Threefry key as two uint32 and derives sub-keys
with ``ops/field_kernels.py::split_key`` (child i = Threefry-2x32(key,
(0x5EED, i))): ``_next_key`` replaces the dealer key by child 0 and hands
out children 1.. — the same carry-and-split discipline as the reference,
with the port's own fixed derivation function. Every function that
consumes a key also accepts explicit key data.

Draws. Every random value comes from the field sampler
(``FpArray.rand``, row 2 on the card) under a key of that stream, so the
port deals other values than the reference from the same seed (pools
cross between the packages through ``save`` / ``load``):

* the dealer programs (``_DEALERS``, the reference's ``_dealer_jit``
  factory run eagerly) split their key into sub-keys 0..3
  as the reference's ``jax.random.split(key, 4)``; the triples' ab
  polynomial, drawn by the reference under ``fold_in(key, 7)``, takes
  sub-key 4;
* a bit (kinds bits and one_minus_ones), drawn by the reference with
  ``jax.random.bernoulli``, is the low bit of a sampler draw's Montgomery
  word (a fair coin within 2^-128);
* share_bits' secrets, drawn by the reference from a host
  ``random.Random`` seeded by ``jax.random.randint``, are sampler draws,
  decomposed into bits on the device.
"""

from __future__ import annotations

import glob
import os
import pickle
import time

import numpy as np
import torch

from ..interop import from_reference_limbs, to_reference_limbs
from ..ops import montgomery as mont
from ..ops.field_kernels import split_key
from ..ops.fparray import FpArray
from ..ops.limbs import P, W
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


def _deal_triples(enc, n, t, k, key_data, device):
    """[n, k, 3] shares of (a, b, a*b): a, b under sub-keys 0 and 1, their
    polynomials under 2 and 3, ab's under 4."""
    ks = split_key(key_data, 5)
    a = FpArray.rand(ks[0], (k,), device=device)
    b = FpArray.rand(ks[1], (k,), device=device)
    return FpArray.stack([_share_pure(enc, t, a, ks[2]),
                          _share_pure(enc, t, b, ks[3]),
                          _share_pure(enc, t, a * b, ks[4])], axis=2)


def _deal_cubes(enc, n, t, k, key_data, device):
    """[n, k, 3] shares of (r, r^2, r^3): r under sub-key 0, the
    polynomials under 1, 2 and 3."""
    ks = split_key(key_data, 4)
    r = FpArray.rand(ks[0], (k,), device=device)
    r2 = r * r
    return FpArray.stack([_share_pure(enc, t, r, ks[1]),
                          _share_pure(enc, t, r2, ks[2]),
                          _share_pure(enc, t, r2 * r, ks[3])], axis=2)


def _deal_double_shares(enc, n, t, k, key_data, device):
    """[n, k, 2] shares of r at degree t and at degree 2t: r under sub-key
    0, the polynomials under 1 and 2."""
    ks = split_key(key_data, 4)
    r = FpArray.rand(ks[0], (k,), device=device)
    return FpArray.stack([_share_pure(enc, t, r, ks[1]),
                          _share_pure(enc, 2 * t, r, ks[2])], axis=2)


_DEALERS = {"triples": _deal_triples, "cubes": _deal_cubes,
            "rands": _deal_rands, "double_shares": _deal_double_shares}


def _coin_bits(key_data, k: int, device):
    """k fair coins (bool [k]): the low bit of a sampler draw each."""
    return (FpArray.rand(key_data, (k,), device=device).limbs[0] & 1) == 1


def _bit_values(bits, device) -> FpArray:
    """bool [...] -> field elements 0 / 1 (Montgomery form)."""
    return FpArray.select(bits, FpArray.ones(bits.shape, device),
                          FpArray.zeros(bits.shape, device))


def _decompose_bits(r: FpArray, nbits: int) -> FpArray:
    """r[k] -> [k, 1 + nbits]: r, then its bits as field elements 0 / 1,
    least significant first."""
    plain = mont.from_mont(r.limbs)                          # [L, k]
    idx = torch.arange(nbits, device=r.device)
    bits = (plain[idx // W] >> (idx % W)[:, None]) & 1       # [nbits, k]
    return FpArray.concatenate(
        [r.reshape(r.shape[0], 1), _bit_values(bits.T == 1, r.device)],
        axis=1)


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
            raise AssertionError(f"preprocessing pool exhausted (have "
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

    # -- dealing kernels ---------------------------------------------------
    def _share_values(self, values: FpArray,
                      degree: int | None = None) -> FpArray:
        """values[B] -> shares[n, B]: random polynomials of `degree`
        (default t), one batched encode."""
        degree = self.t if degree is None else degree
        return _share_pure(self.enc, degree, values, self._next_key())

    # -- generators (reference generate_* API) -----------------------------
    def _run_dealer(self, kind: str, k: int, key_data=None):
        return _DEALERS[kind](
            self.enc, self.n, self.t, k,
            self._next_key() if key_data is None else key_data, self.device)

    def generate_triples(self, k: int, key_data=None):
        self._pool("triples").put(self._run_dealer("triples", k, key_data))

    def generate_cubes(self, k: int, key_data=None):
        self._pool("cubes").put(self._run_dealer("cubes", k, key_data))

    def generate_rands(self, k: int, key_data=None):
        """Deal k random sharings into the ``rands`` pool; `key_data`
        (two uint32) overrides the dealer's own next key."""
        self._pool("rands").put(self._run_dealer("rands", k, key_data))

    def generate_double_shares(self, k: int, key_data=None):
        """(r_t, r_2t) pairs."""
        self._pool("double_shares").put(
            self._run_dealer("double_shares", k, key_data))

    def generate_zeros(self, k: int):
        z = FpArray.zeros((k,), self.device)
        self._pool("zeros").put(self._share_values(z).reshape(self.n, k, 1))

    def generate_bits(self, k: int):
        b = _bit_values(_coin_bits(self._next_key(), k, self.device),
                        self.device)
        self._pool("bits").put(self._share_values(b).reshape(self.n, k, 1))

    def generate_one_minus_ones(self, k: int):
        coins = _coin_bits(self._next_key(), k, self.device)
        pm = FpArray.select(coins, FpArray.ones((k,), self.device),
                            FpArray.from_int(P - 1, (k,), self.device))
        self._pool("one_minus_ones").put(
            self._share_values(pm).reshape(self.n, k, 1))

    def generate_share_bits(self, k: int, bit_length: int = 255):
        """r plus its bit decomposition (stride bit_length + 1)."""
        r = FpArray.rand(self._next_key(), (k,), device=self.device)
        flat = _decompose_bits(r, bit_length).reshape(k * (bit_length + 1))
        sh = self._share_values(flat).reshape(self.n, k, bit_length + 1)
        self._pool("share_bits").put(sh)

    def generate_powers(self, x_count: int, k: int):
        """x_count independent x's, each with powers x^1..x^k."""
        x = FpArray.rand(self._next_key(), (x_count,), device=self.device)
        pows = [x]
        for _ in range(k - 1):
            pows.append(pows[-1] * x)
        stacked = FpArray.stack(pows, axis=1).reshape(x_count * k)
        sh = self._share_values(stacked).reshape(self.n, x_count, k)
        self._pool("powers").put(sh)

    def generate_share(self, value: int, degree: int | None = None):
        v = FpArray.from_ints([value], device=self.device)
        sh = self._share_values(v, degree).reshape(self.n, 1, 1)
        self._pool(f"share_d{degree or self.t}").put(sh)

    # -- consumers (get_* API; shapes [n, k, parts]) ------------------------
    def get_triples(self, k: int):
        s = self._pool("triples").take(k)
        return (FpArray(s.limbs[..., 0]), FpArray(s.limbs[..., 1]),
                FpArray(s.limbs[..., 2]))

    def get_cubes(self, k: int):
        s = self._pool("cubes").take(k)
        return (FpArray(s.limbs[..., 0]), FpArray(s.limbs[..., 1]),
                FpArray(s.limbs[..., 2]))

    def get_rands(self, k: int):
        return FpArray(self._pool("rands").take(k).limbs[..., 0])

    def get_zeros(self, k: int):
        return FpArray(self._pool("zeros").take(k).limbs[..., 0])

    def get_bits(self, k: int):
        return FpArray(self._pool("bits").take(k).limbs[..., 0])

    def get_one_minus_ones(self, k: int):
        return FpArray(self._pool("one_minus_ones").take(k).limbs[..., 0])

    def get_double_shares(self, k: int):
        s = self._pool("double_shares").take(k)
        return FpArray(s.limbs[..., 0]), FpArray(s.limbs[..., 1])

    def get_share_bits(self, k: int):
        s = self._pool("share_bits").take(k)
        return FpArray(s.limbs[..., 0]), FpArray(s.limbs[..., 1:])

    def get_powers(self, k: int):
        return self._pool("powers").take(k)

    def get_share(self, degree: int | None = None):
        return FpArray(
            self._pool(f"share_d{degree or self.t}").take(1).limbs[..., 0, 0])

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


# -- cross-process READY barrier ---------------------------------------------
_READY_FILE = "READY"


def preprocessing_done(path: str = "sharedata"):
    """Signal that dealer preprocessing under ``path`` is complete."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _READY_FILE), "w") as f:
        f.write("ready")


def wait_for_preprocessing(path: str = "sharedata", timeout: float = 60.0,
                           poll: float = 0.2):
    """Block until the dealer drops the READY file under ``path``."""
    deadline = time.monotonic() + timeout
    ready = os.path.join(path, _READY_FILE)
    while not os.path.exists(ready):
        if time.monotonic() >= deadline:
            raise TimeoutError(f"preprocessing READY barrier: {ready}")
        time.sleep(poll)
