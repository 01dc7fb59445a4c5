"""Offline-phase programs: random double sharings and Beaver triples.

Counterpart of ``honeybadgermpc_tpu/runtime/offline.py``. So far only the
fused single-device programs are ported: ``fused_randousha`` and
``fused_generate_triples(packed=True)``, reached through
``sim_offline_jit("generate_triples_packed", n, t, k)``. The eager
per-column programs (randousha, generate_triples, generate_bits), the
unpacked triple finish and the sharded variants are not ported yet and
raise ``NotImplementedError``.

Keys. A key is Threefry key data, two uint32 (a pair of ints, a numpy
``uint32[2]`` or a tensor). The triple program needs three independent
sub-keys, for the a, b and r dealings. The reference derives them with
``jax.random.split(key, 3)``; the port derives them with its own documented
``field_kernels.split_key``. ``fused_generate_triples`` therefore also
takes the three sub-keys' data directly (``subkeys=``): given the same
three pairs it returns the reference's outputs word for word.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ops.field_kernels import (_key_ints, mul_add_packed4_flat,
                                 split_key, sub_bcast_packed4)
from ..ops.fparray import FpArray
from ..ops.fused_open import PL, unpack_limbs
from ..ops.fused_randousha import (fused_fits, sim_randousha_fused,
                                   sim_ransha_fused)
from ..parallel.mesh import SimBackend
from ..parallel.reconstruct import _sim_reconstruct_packed_jit


def _key_data(key):
    """Key data in any accepted form -> (k0, k1) Python ints."""
    return _key_ints(key)


def fused_randousha(backend, n: int, t: int, k: int, key,
                    device=torch.device("cuda")):
    """Random double sharings on the fused kernel pipeline
    (ops/fused_randousha.py): (r_t, r_2t FpArray [n, k*(n-2t)], ok).
    Detect-only: any check failure -> ok False.

    HARD-GATED to SimBackend: the pipeline's aggregated verification
    derives rho from the same run key that fixes the dealings — sound in
    the simulation, where the whole program is one trusted process, but NOT
    in a distributed deployment, where an adversarial dealer could learn
    rho before dealing and craft cross-degree inconsistencies that cancel
    in the aggregate (Schwartz-Zippel needs rho unpredictable at dealing
    time)."""
    assert isinstance(backend, SimBackend), \
        "fused (rho-aggregated) randousha is sim-only; see docstring"
    pt, p2, ok = sim_randousha_fused(_key_data(key), n, t, k, device=device)
    return FpArray(unpack_limbs(pt)), FpArray(unpack_limbs(p2)), ok


def fused_generate_triples(backend, n: int, t: int, k: int, key=None,
                           packed: bool = False,
                           device=torch.device("cuda"), subkeys=None):
    """Beaver triples over the fused pipelines, producing k*(n-2t) triples:
    a and b come from single-degree RanSha (their 2t halves would be dead
    weight), r from RanDouSha, then z = a*b + r_2t is opened at degree 2t
    with the direct open and ab = open(z) - r_t. Detect-only: decode errors
    flip ok. Distinct sub-keys keep the three dealings' Threefry streams
    disjoint. Sim-only, like fused_randousha (rho-aggregated checks).

    packed=True returns (pa, pb, pab, ok): packed share tensors int32 in
    the extraction's native layout [PL, n, n_outp, k] (k % 128 == 0) and a
    0-d bool tensor. Real triples are rows [:n-2t] of the n_outp axis;
    padding rows hold the aggregated-check sharing and zero sharings
    (valid sharings, so the 2t open of z passes through them with zero
    errors). Nothing here reads a device value on the host.

    key: key data of the run, split with field_kernels.split_key; or
    subkeys=(ka, kb, kr): the three dealings' key data given directly."""
    assert isinstance(backend, SimBackend), \
        "fused (rho-aggregated) triple pipeline is sim-only"
    if not packed:
        raise NotImplementedError(
            "packed=False needs the flat mul_add_packed kernel, which is "
            "not ported yet; use packed=True")
    if (key is None) == (subkeys is None):
        raise ValueError("give either key or subkeys=(ka, kb, kr)")
    ka, kb, kr = subkeys if subkeys is not None \
        else split_key(_key_data(key), 3)
    pa, oka = sim_ransha_fused(_key_data(ka), n, t, k, padded=True,
                               device=device)
    pb, okb = sim_ransha_fused(_key_data(kb), n, t, k, padded=True,
                               device=device)
    prt, pr2t, okr = sim_randousha_fused(_key_data(kr), n, t, k,
                                         padded=True, device=device)
    k2 = 2 * t + 1
    run = _sim_reconstruct_packed_jit(n, 2 * t, False, True, fallback=False,
                                      replicate=False)
    _, _, n_outp, sp = pa.shape
    cntp = n_outp * sp
    # z flat [PL, n, cntp + pad] with a zero tail: column count a multiple
    # of 2t+1, as the open requires
    zf = mul_add_packed4_flat(pa, pb, pr2t, pad=(-cntp) % k2)
    del pr2t
    opened, nerr = run(zf)
    ok = oka & okb & okr & (nerr.sum() == 0)
    pab = sub_bcast_packed4(opened[:, :cntp].reshape(PL, n_outp, sp), prt)
    return pa, pb, pab, ok


@lru_cache(maxsize=None)
def sim_offline_jit(program: str, n: int, t: int, k: int,
                    device=torch.device("cuda")):
    """The single-device offline program (program, n, t, k) as a cached
    plain callable (PyTorch runs eagerly, nothing is traced):
    fn(key) or fn(subkeys=(ka, kb, kr)); the backend is constructed inside.
    Detect-only: any decode error flips the ok flag and the batch is
    discarded (the reference's in_graph_fallback=True, opens with the
    robust fallback, waits for the robust open and is not a parameter
    here).

    Ported: "generate_triples_packed" (the packed-at-rest triple program on
    the fused pipeline). "randousha", "generate_triples" and
    "generate_bits" need the eager per-column programs and are not ported
    yet."""
    backend = SimBackend(n)
    device = torch.device(device)
    if program == "generate_triples_packed":
        assert fused_fits(n, t)

        def generate_triples_packed(key=None, subkeys=None):
            return fused_generate_triples(backend, n, t, k, key, packed=True,
                                          device=device, subkeys=subkeys)

        return generate_triples_packed
    if program in ("randousha", "generate_triples", "generate_bits"):
        raise NotImplementedError(
            f"offline program {program!r} needs the eager per-column "
            "offline path, which is not ported yet; "
            "'generate_triples_packed' is")
    raise KeyError(program)
