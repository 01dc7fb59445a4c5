"""Offline-phase programs: random double sharings, Beaver triples, bits.

Counterpart of ``honeybadgermpc_tpu/runtime/offline.py`` (single-device
``SimBackend`` programs; the sharded variants wait for the mesh backends):

* the eager per-column programs ``randousha``, ``generate_triples`` and
  ``generate_bits``: every party deals its secrets at degrees t and 2t,
  the columns are exchanged (all_to_all), the hyperinvertible extraction
  re-encodes them, and the 2t discarded columns of every slot are opened at
  both degrees and compared — any decode error or secret mismatch aborts
  the batch (ok False). This is the distributed-sound check;
* the fused single-device pipelines ``fused_randousha`` and
  ``fused_generate_triples`` (rho-aggregated check, sim-only);
* ``sim_offline_jit``, the one entry point, routing each program as the
  reference routes it on the accelerator.

Program versus eager call. The reference tells a compiled program from an
eager call by whether its shares are tracers; the port traces nothing, so
the eager programs take the flag explicitly (``in_program``):

* ``in_program=True`` (every program of ``sim_offline_jit``): the opens
  are detect-only direct opens, or with ``in_graph_fallback=True`` the
  faithful three-kernel open (ops/fused_open.py) with its robust fallback
  (the Gao redo inside the call);
* ``in_program=False`` (a direct call): the direct open, then, only when
  it saw a mismatch, ``host_robust_redo`` over host-held shares.

Keys. A key is Threefry key data, two uint32 (a pair of ints, a numpy
``uint32[2]`` or a tensor). The reference splits keys with
``jax.random.split``; the port derives sub-keys with its own documented
``field_kernels.split_key``. Test hooks give both packages the same
randomness: ``fused_generate_triples`` takes the three dealings' sub-keys
(``subkeys=``), the eager programs the dealt values themselves
(``draws=``), since the reference's CPU sampler differs from its TPU one.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.field_kernels import (_key_ints, mul_add_packed,
                                 mul_add_packed4_flat, split_key,
                                 sub_bcast_packed, sub_bcast_packed4)
from ..ops.fparray import FpArray
from ..ops.fused_open import (KMAX, PL, pack_limbs, sim_open_fused_packed,
                              unpack_limbs)
from ..ops.fused_open_direct import direct_fits, sim_open_direct_packed
from ..ops.fused_randousha import (fused_fits, sim_randousha_fused,
                                   sim_ransha_fused)
from ..ops.limbs import L, P
from ..ops.rs import Encoding
from ..parallel.mesh import SimBackend
from ..parallel.reconstruct import (_sim_reconstruct_packed_jit,
                                    batch_reconstruct, host_robust_redo)


def _key_data(key):
    """Key data in any accepted form -> (k0, k1) Python ints."""
    return _key_ints(key)


def _deal_own(enc: Encoding, secrets: FpArray, degree: int, key,
              hi: FpArray = None) -> FpArray:
    """Share own secrets[..., k] at the given degree -> [..., k, n] columns
    (column j goes to party j). The `degree` higher coefficients are drawn
    from `key`, unless given as `hi` [..., k, degree]."""
    if hi is None:
        hi = FpArray.rand(key, secrets.shape + (degree,),
                          device=secrets.device)
    coeffs = FpArray.concatenate(
        [FpArray(secrets.limbs[..., None]), hi], axis=secrets.ndim)
    return enc.encode(coeffs)


def _unpack_rows(packed):
    """Packed [PL, n, B] -> limbs [L, n, B]. A broadcast of one copy
    (stride 0 on the party axis, as the opens return it) stays a broadcast
    view instead of n materialized copies."""
    if packed.stride(1) == 0:
        one = unpack_limbs(packed[:, 0])
        return one[:, None].expand((L,) + tuple(packed.shape[1:]))
    return unpack_limbs(packed)


def _open_columns(backend, cols: FpArray, n: int, degree: int,
                  in_graph_fallback: bool = True, in_program: bool = False):
    """Open sharings held column-wise: cols[party, ..., C] -> (values with
    the same shape, nerr [n]). Flattens the trailing dims and pads them to
    a multiple of degree+1 with zero sharings.

    Routing, the reference's on the accelerator: robust when in a program
    with ``in_graph_fallback``; a detect-only open where the direct open
    fits and the open is not robust; else the three-kernel open (n % 8 ==
    0, degree+1 <= 64), robust or not; else the generic two-round program.
    An eager call (``in_program=False``) that saw a mismatch on the direct
    or three-kernel open is redone robustly by ``host_robust_redo``.
    ``in_graph_fallback=False`` in a program: the counts come back in nerr
    and the caller aborts; the offline protocols answer any decode error
    with ok False, so the opened values only need to be right when
    nerr == 0."""
    if not isinstance(backend, SimBackend):
        raise NotImplementedError("only SimBackend is ported")
    shape = cols.shape
    flat = cols.reshape(shape[:1] + (int(np.prod(shape[1:])),))
    k = degree + 1
    B = flat.shape[-1]
    pad = (-B) % k
    if pad:
        flat = FpArray.concatenate(
            [flat, FpArray.zeros(flat.shape[:-1] + (pad,),
                                 device=flat.device)], axis=flat.ndim - 1)
    points = tuple(int(x) % P for x in Encoding(n).points)
    robust = in_program and in_graph_fallback
    use_direct = not robust and direct_fits(n, k)
    if use_direct or (n % 8 == 0 and k <= KMAX):
        packed = pack_limbs(flat.limbs)
        if use_direct:
            sec, nerr = sim_open_direct_packed(packed, n, degree, points)
        else:
            sec, nerr = sim_open_fused_packed(packed, n, degree, points,
                                              robust=robust)
        del packed
        vals = FpArray(_unpack_rows(sec))
        if not in_program and int(nerr.sum()) != 0:
            limbs_np, nerr_np = host_robust_redo(
                flat.limbs.cpu().numpy().view(np.uint32), n, degree,
                device=flat.device)
            vals = FpArray(torch.from_numpy(limbs_np.view(np.int32)).to(
                flat.device))
            nerr = torch.from_numpy(nerr_np).to(flat.device)
    else:
        vals, nerr = batch_reconstruct(backend, flat, n, degree, robust=True,
                                       fallback=in_graph_fallback)
    vals = FpArray(vals.limbs[..., :B])
    return vals.reshape(shape), nerr


def _tampered(tamper, name: str, cols: FpArray) -> FpArray:
    return cols if tamper is None else tamper(name, cols)


def randousha(backend, n: int, t: int, k: int, key=None,
              in_graph_fallback: bool = True, in_program: bool = False,
              device=torch.device("cuda"), draws=None, tamper=None):
    """Generate k*(n-2t) double sharings (r_t, r_2t) with verification:
    (r_t, r_2t FpArray [n, k*(n-2t)], ok 0-d bool tensor). ok False means
    some party dealt inconsistently, or an open saw a decode error, and
    the batch must be discarded (the ABORT vote).

    key: key data, split with field_kernels.split_key into the secrets'
    and the two dealings' keys. draws=(secrets [n, k], hi_t [n, k, t],
    hi_2t [n, k, 2t]) gives the drawn values instead (test hook).
    tamper(name, cols) -> cols: fault injection for tests, applied to
    every share tensor just before it is opened (names "check_t",
    "check_2t"; the callers add theirs)."""
    if not isinstance(backend, SimBackend):
        raise NotImplementedError("only SimBackend is ported")
    enc = Encoding(n)
    lead = (n,)
    if draws is None:
        _, k1, k2, k3 = split_key(_key_data(key), 4)
        secrets = FpArray.rand(k1, lead + (k,), device=device)
        hi_t = hi_2t = None
    else:
        secrets, hi_t, hi_2t = draws
        k2 = k3 = None

    recv_t = backend.all_to_all(_deal_own(enc, secrets, t, k2, hi_t))
    recv_2t = backend.all_to_all(_deal_own(enc, secrets, 2 * t, k3, hi_2t))
    # hyperinvertible extraction: the received vector (over dealers) is a
    # coefficient vector, re-encoded at the n party points
    out_t = enc.encode(recv_t)                     # [n, k, n] output-indexed
    del recv_t
    out_2t = enc.encode(recv_2t)
    del recv_2t

    n_out = n - 2 * t                              # outputs kept per slot
    check_t = _tampered(tamper, "check_t", FpArray(out_t.limbs[..., n_out:]))
    check_2t = _tampered(tamper, "check_2t",
                         FpArray(out_2t.limbs[..., n_out:]))
    # verification: open the discarded columns at both degrees; abort on
    # any decode error or secret mismatch
    v_t, e_t = _open_columns(backend, check_t, n, t, in_graph_fallback,
                             in_program)
    v_2t, e_2t = _open_columns(backend, check_2t, n, 2 * t,
                               in_graph_fallback, in_program)
    ok = v_t.eq(v_2t).all() & (e_t.sum() == 0) & (e_2t.sum() == 0)
    del check_t, check_2t, v_t, v_2t

    flat = lead + (k * n_out,)
    return (FpArray(out_t.limbs[..., :n_out]).reshape(flat),
            FpArray(out_2t.limbs[..., :n_out]).reshape(flat), ok)


def generate_triples(backend, n: int, t: int, k: int, key=None,
                     in_graph_fallback: bool = True, in_program: bool = False,
                     device=torch.device("cuda"), draws=None, tamper=None):
    """Beaver triples from RanDouSha: draw 3k double sharings; use (a, b, r):
    open a*b + r at degree 2t, subtract r_t. Returns (a, b, ab FpArray
    [n, k*(n-2t)], ok). Hooks as in randousha (the draws are those of its
    3k slots; tamper also sees "ab_plus_r")."""
    r_t, r_2t, ok = randousha(backend, n, t, 3 * k, key, in_graph_fallback,
                              in_program, device, draws, tamper)
    cnt = r_t.shape[-1] // 3
    a = FpArray(r_t.limbs[..., :cnt])
    b = FpArray(r_t.limbs[..., cnt:2 * cnt])
    rt = FpArray(r_t.limbs[..., 2 * cnt:3 * cnt])
    r2t = FpArray(r_2t.limbs[..., 2 * cnt:3 * cnt])
    del r_2t

    ab_plus_r = _tampered(tamper, "ab_plus_r", a * b + r2t)  # degree 2t
    del r2t
    opened, nerr = _open_columns(backend, ab_plus_r, n, 2 * t,
                                 in_graph_fallback, in_program)
    ab = opened - rt                                        # degree t
    ok = ok & (nerr.sum() == 0)
    return a, b, ab, ok


def generate_bits(backend, n: int, t: int, k: int, key=None,
                  in_graph_fallback: bool = True, in_program: bool = False,
                  device=torch.device("cuda"), draws=None, tamper=None):
    """Random shared bits via the u / sqrt(u^2) trick: (bits FpArray
    [n, k*(n-2t)], ok). u^2 is opened masked (u*u + r_2t at degree 2t),
    unmasked to a degree-t sharing and opened; the canonical root of the
    public u^2 gives the share of u/root = +-1, and (that + 1)/2 is the
    bit. Hooks as in randousha (its 2k slots; tamper also sees "u2_masked"
    and "u2_share")."""
    r_t, r_2t, ok = randousha(backend, n, t, 2 * k, key, in_graph_fallback,
                              in_program, device, draws, tamper)
    cnt = r_t.shape[-1] // 2
    u = FpArray(r_t.limbs[..., :cnt])
    rt = FpArray(r_t.limbs[..., cnt:2 * cnt])
    r2t = FpArray(r_2t.limbs[..., cnt:2 * cnt])
    del r_2t

    u2_masked = _tampered(tamper, "u2_masked", u * u + r2t)
    del r2t
    opened, e1 = _open_columns(backend, u2_masked, n, 2 * t,
                               in_graph_fallback, in_program)
    u2_share = _tampered(tamper, "u2_share", opened - rt)   # degree t
    del opened
    u2, e2 = _open_columns(backend, u2_share, n, t, in_graph_fallback,
                           in_program)                      # public u^2

    root, has_root = u2.sqrt()                     # canonical root
    dev = u.device
    inv2 = FpArray.from_int(pow(2, P - 2, P), device=dev)
    sign = u * root.inv()                          # share of +-1
    bits = (sign + FpArray.from_int(1, device=dev)) * inv2
    ok = ok & (e1.sum() == 0) & (e2.sum() == 0) & has_root.all()
    return bits, ok


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

    packed=False returns (a, b, ab FpArray [n, k*(n-2t)], ok): z comes
    from the flat packed kernel ``mul_add_packed`` and ab from the flat
    ``sub_bcast_packed``, which broadcasts the one opened copy over the
    parties (the reference subtracts on unpacked limbs: the same words).

    key: key data of the run, split with field_kernels.split_key; or
    subkeys=(ka, kb, kr): the three dealings' key data given directly."""
    assert isinstance(backend, SimBackend), \
        "fused (rho-aggregated) triple pipeline is sim-only"
    if (key is None) == (subkeys is None):
        raise ValueError("give either key or subkeys=(ka, kb, kr)")
    ka, kb, kr = subkeys if subkeys is not None \
        else split_key(_key_data(key), 3)
    pa, oka = sim_ransha_fused(_key_data(ka), n, t, k, padded=packed,
                               device=device)
    pb, okb = sim_ransha_fused(_key_data(kb), n, t, k, padded=packed,
                               device=device)
    prt, pr2t, okr = sim_randousha_fused(_key_data(kr), n, t, k,
                                         padded=packed, device=device)
    k2 = 2 * t + 1
    run = _sim_reconstruct_packed_jit(n, 2 * t, False, True, fallback=False,
                                      replicate=False)
    if packed:
        _, _, n_outp, sp = pa.shape
        cntp = n_outp * sp
        # z flat [PL, n, cntp + pad] with a zero tail: column count a
        # multiple of 2t+1, as the open requires
        zf = mul_add_packed4_flat(pa, pb, pr2t, pad=(-cntp) % k2)
        del pr2t
        opened, nerr = run(zf)
        ok = oka & okb & okr & (nerr.sum() == 0)
        pab = sub_bcast_packed4(opened[:, :cntp].reshape(PL, n_outp, sp),
                                prt)
        return pa, pb, pab, ok
    cnt = pa.shape[-1]                              # k * (n - 2t)
    z = mul_add_packed(pa.reshape(PL, -1), pb.reshape(PL, -1),
                       pr2t.reshape(PL, -1)).reshape(pa.shape)
    del pr2t
    pad = (-cnt) % k2
    if pad:
        z = torch.cat([z, z.new_zeros((PL, n, pad))], dim=-1)
    opened, nerr = run(z)
    del z
    ok = oka & okb & okr & (nerr.sum() == 0)
    # every party's opened value is the same: the subtraction broadcasts
    # the one copy over the parties' r_t
    ab = unpack_limbs(sub_bcast_packed(opened[:, :cnt], prt))
    return (FpArray(unpack_limbs(pa)), FpArray(unpack_limbs(pb)),
            FpArray(ab), ok)


@lru_cache(maxsize=None)
def sim_offline_jit(program: str, n: int, t: int, k: int,
                    in_graph_fallback: bool = False,
                    device=torch.device("cuda")):
    """ONE single-device offline program per (program, n, t, k,
    in_graph_fallback) as a cached plain callable (PyTorch runs eagerly,
    nothing is traced); the backend is constructed inside. Routed as the
    reference routes it on the accelerator:

    * "generate_triples_packed": the fused pipeline with the packed finish,
      fn(key) or fn(subkeys=(ka, kb, kr));
    * "randousha", "generate_triples" with ``in_graph_fallback=False`` (the
      default): the fused pipelines (detect-only, ``packed=False`` for the
      triples), fn(key), the triples also fn(subkeys=...);
    * everything else — "generate_bits", and any program with
      ``in_graph_fallback=True`` — the eager per-column program as one
      program (``in_program=True``): detect-only direct opens, or with
      ``in_graph_fallback=True`` the three-kernel open with its robust
      fallback, which corrects faults inside the call (ok still turns
      False when any open saw one). fn(key), or fn(draws=..., tamper=...)
      with the programs' test hooks.

    Default is detect-only (in_graph_fallback=False): any decode error
    flips ok and the batch is discarded, the offline protocols' abort
    semantics."""
    backend = SimBackend(n)
    device = torch.device(device)
    if program == "generate_triples_packed":
        assert fused_fits(n, t)

        def generate_triples_packed(key=None, subkeys=None):
            return fused_generate_triples(backend, n, t, k, key, packed=True,
                                          device=device, subkeys=subkeys)

        return generate_triples_packed
    if program not in ("randousha", "generate_triples", "generate_bits"):
        raise KeyError(program)
    if program == "randousha" and not in_graph_fallback and fused_fits(n, t):
        def randousha_fused(key):
            return fused_randousha(backend, n, t, k, key, device=device)

        return randousha_fused
    if program == "generate_triples" and not in_graph_fallback \
            and fused_fits(n, t):
        def generate_triples_fused(key=None, subkeys=None):
            return fused_generate_triples(backend, n, t, k, key,
                                          packed=False, device=device,
                                          subkeys=subkeys)

        return generate_triples_fused
    fn = {"randousha": randousha, "generate_triples": generate_triples,
          "generate_bits": generate_bits}[program]

    def eager_program(key=None, draws=None, tamper=None):
        return fn(backend, n, t, k, key, in_graph_fallback, in_program=True,
                  device=device, draws=draws, tamper=tamper)

    eager_program.__name__ = program
    return eager_program
