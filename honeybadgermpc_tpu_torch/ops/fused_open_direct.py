"""Single-kernel direct simulation of the n-party batch open.

Counterpart of ``honeybadgermpc_tpu/ops/fused_open_direct.py``. On ONE
device the whole two-round open protocol is a deterministic linear map of
the share tensor, and the composition collapses:

  * the opened secrets are u = the lam0-contraction of the first k
    parties' shares — ONE k-length band contraction;
  * validation: predict w[z] = lam_z-contraction of the first k parties'
    shares for every z in k..n-1 and compare with the received share of
    party z. Some mismatch is seen iff the n shares do not lie on one
    degree-t polynomial.

Secrets and the accept/reject decision are bit-exact equal to the faithful
simulation; mismatches are charged to the offending SOURCE party (parties
0..t report 0). Callers use the counts as a redo trigger.

On a CUDA tensor the open runs as one launch of a hand-written kernel of
``csrc/open_direct.cu`` (planes, band dot, fold epilogue, compare,
per-party counts): ``open_direct_kernel`` on the wgmma band core
(``csrc/band_gemm.cuh``) wherever a 64-lane block's planes fit its shared
memory (k <= 81), ``open_direct_mma_kernel`` on the mma.sync core above
(``_direct_route``). ``_open_direct_plain`` is the plain PyTorch version of
the same function, used for CPU tensors and as the yardstick the kernels
are held against bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .band_gemm import (SMEM_MAX, _fold_array, _gemm_band, _gemm_plan,
                        smem_bytes)
from .fused_open import (NBAL, PL, _BAL_ROUNDS, _bal_bias, _bal_fold_init,
                         _band_dot_fold, _fold_consts, _folded_band_host,
                         _kernel_band, _lam_int, _launch_stream, _pack16,
                         _planes_of_packed, _smem_plan, pack_limbs,
                         unpack_limbs)
from .fparray import FpArray
from .limbs import P

ZG = 8            # output columns per band group (the reference's layout)
# Contraction-length bound of the balanced base-256 digit scheme at k = 128:
# |diag| <= NBAL*k*128^2 = 2^26 (int32 accumulation headroom 2^31) and the
# 2-round REDC needs sum_r bias*256^r * 2 < p*2^32 ~ 2^287 (it is ~2^277).
KMAX_DIRECT = 128

launches = 0      # times open_direct_kernel (the core) was launched
launches_mma = 0  # times open_direct_mma_kernel (k > 81) was launched
plain_calls_on_cuda = 0   # times the plain version ran on a CUDA tensor


def direct_fits(n: int, k: int) -> bool:
    """The direct open needs at least one validating party and a
    contraction inside the digit scheme's proven int32 headroom."""
    return n > k and k <= KMAX_DIRECT


@functools.lru_cache(maxsize=None)
def _direct_band(points: tuple, k: int):
    """int8 band [ngrp, NBAL*ZG, kcols]: group g's ZG columns are the
    Lagrange rows predicting parties k+g*ZG.. (and, in the last group,
    the lam0 row computing the secrets), folded with the balanced base-256
    digit scheme of ops/fused_open.py. Byte-identical to the reference."""
    n = len(points)
    nv = n - k
    xs = tuple(int(points[i]) % P for i in range(k))
    cols = [_lam_int(xs, int(points[z]) % P) for z in range(k, n)]
    cols.append(_lam_int(xs, 0))                  # u (secrets) row: col nv
    ngrp = -(-(nv + 1) // ZG)
    kcols = -(-(k * NBAL) // 32) * 32
    bands = []
    for g in range(ngrp):
        sub = cols[g * ZG:(g + 1) * ZG]
        sub = sub + [[0] * k] * (ZG - len(sub))
        mat = [[sub[c][i] for c in range(ZG)] for i in range(k)]
        b = _folded_band_host(mat, _BAL_ROUNDS, ZG)   # [NBAL*ZG, NBAL*k]
        if b.shape[1] < kcols:
            b = np.concatenate(
                [b, np.zeros((b.shape[0], kcols - b.shape[1]), np.int8)], 1)
        bands.append(b)
    return np.stack(bands), ngrp, kcols


@functools.lru_cache(maxsize=None)
def _direct_band_device(points: tuple, k: int, device: torch.device):
    """The reference-layout band [ngrp, NBAL*ZG, kcols] int8 on `device`
    (the plain version's)."""
    return torch.from_numpy(_direct_band(points, k)[0]).to(device)


def _direct_route(k: int) -> str:
    """The kernel a CUDA open of k parties' shares launches: "wgmma"
    (open_direct_kernel on csrc/band_gemm.cuh) wherever the core's planes
    of a 64-lane block fit shared memory beside its band rings (k <= 81),
    else "mma_sync" (open_direct_mma_kernel, 82 <= k <= KMAX_DIRECT)."""
    return "wgmma" if smem_bytes(k, 1) <= SMEM_MAX else "mma_sync"


def _direct_band_flat(points: tuple, k: int):
    """(band, ncp): the direct band's ngrp groups of ZG columns laid side by
    side as one band int8 [NBAL*ncp, kcols] of ncp = ngrp*ZG columns, row
    r*ncp + col: the layout of K2's R1 band, whose columns
    [lam(points[k:]) | lam0] are the same."""
    band, ngrp, _ = _direct_band(points, k)
    flat = band.reshape(ngrp, NBAL, ZG, -1).transpose(1, 0, 2, 3)
    return flat.reshape(NBAL * ngrp * ZG, -1), ngrp * ZG


@functools.lru_cache(maxsize=None)
def _direct_tiles(points: tuple, k: int) -> np.ndarray:
    """The direct band's nv+1 columns in band_gemm tiles int8
    [ceil((nv+1)/2), k, 2048] (_gemm_band of _direct_band_flat): the same
    tiles as K2's R1 band."""
    band, ncp = _direct_band_flat(points, k)
    return _gemm_band(band, ncp, k, len(points) - k + 1)


def _open_direct_plain(packed, n: int, k: int, points: tuple):
    """Plain PyTorch version of the direct open: packed int32 [PL, n, B]
    -> (secrets int32 [PL, B], nerr int32 [n]). Same band, same digit
    planes, same fold/REDC arithmetic as the kernel, bit for bit."""
    global plain_calls_on_cuda
    if packed.is_cuda:
        plain_calls_on_cuda += 1
    nv = n - k
    band = _direct_band_device(points, k, packed.device)
    init = _bal_fold_init(k)
    bias = _bal_bias(k)
    planes = _planes_of_packed(packed[:, :k])             # [NBAL*k, B]
    nerr = torch.zeros(n, dtype=torch.int32, device=packed.device)
    sec = None
    for g in range(band.shape[0]):
        out = _pack16(_band_dot_fold(band[g], planes, ZG, init, bias))
        for jj in range(ZG):                              # out [PL, ZG, B]
            col = g * ZG + jj
            if col < nv:                      # predicted share of z = k+col
                diff = torch.zeros_like(out[0, jj])
                for w in range(PL):
                    diff = diff | (out[w, jj] ^ packed[w, k + col])
                nerr[k + col] = (diff != 0).sum()
            elif col == nv:                   # lam0 row: the secrets
                sec = out[:, jj].contiguous()
    return sec, nerr


@functools.lru_cache(maxsize=None)
def _direct_launcher(points: tuple, k: int, device: torch.device):
    """Everything a launch needs that does not depend on the shares: the
    route's kernel entry, the band in its layout on the device, the fold
    constants and the launch shape. Cached, so a call costs two
    allocations and one launch."""
    from .._build import lib
    n = len(points)
    route = _direct_route(k)
    if route == "wgmma":
        fn = lib().hb_open_direct
        band = torch.from_numpy(_direct_tiles(points, k)).to(device)
        fold = _fold_array(_bal_fold_init(k), _bal_bias(k))
        nsm = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        fn = lib().hb_open_direct_mma
        band_np, ngrp, _ = _direct_band(points, k)
        frag = np.concatenate(
            [_kernel_band(band_np[g], ZG, k) for g in range(ngrp)])
        band = torch.from_numpy(
            np.ascontiguousarray(frag[:n - k + 1])).to(device)
        tl, wg = _smem_plan(k)
        init, bias = _fold_consts(k)

    def launch(packed):
        B = packed.shape[-1]
        sec = torch.empty((PL, B), dtype=torch.int32, device=device)
        nerr = torch.zeros(n, dtype=torch.int32, device=device)
        args = (packed.data_ptr(), band.data_ptr(), sec.data_ptr(),
                nerr.data_ptr() + 4 * k, n, k, B)
        if route == "wgmma":
            rc = fn(*args, _gemm_plan(k, B, nsm), fold,
                    _launch_stream(packed))
        else:
            rc = fn(*args, tl, wg, init, bias, _launch_stream(packed))
        return rc, sec, nerr

    launch.route = route
    return launch


def _open_direct_cuda(packed, n: int, k: int, points: tuple):
    """Launch the route's kernel of csrc/open_direct.cu on packed int32
    [PL, n, B] (CUDA) -> (secrets [PL, B], nerr [n]); the kernel adds its
    per-party counts into nerr[k:], which starts at zero."""
    global launches, launches_mma
    launch = _direct_launcher(points, k, packed.device)
    rc, sec, nerr = launch(packed)
    if launch.route == "wgmma":
        launches += 1
    else:
        launches_mma += 1
    if rc != 0:
        raise RuntimeError(f"open_direct kernel ({launch.route}) launch "
                           f"failed: CUDA error {rc}")
    return sec, nerr


@functools.lru_cache(maxsize=None)
def _norm_points(points: tuple) -> tuple:
    return tuple(int(x) % P for x in points)


def sim_open_direct_packed(packed, n: int, t: int, points: tuple,
                           robust: bool = False, replicate: bool = True):
    """Direct-composition open on PACKED shares int32 [PL, n, B]
    (B % (t+1) == 0, as the protocol's chunking b = i*C + c requires) ->
    (secrets PACKED [PL, n, B] — the per-party replicated view, a
    broadcast of one copy — and nerr [n] int32, mismatches charged to the
    offending SOURCE party; parties 0..t report 0).

    replicate=False returns ONE copy of the secrets [PL, B]: every party's
    opened values are identical by construction.

    robust=False (detect-only): callers rerun robustly when sum(nerr) > 0.
    robust=True (with replicate=True): when any mismatch is seen, the whole
    open is redone by the generic two-round program with its Gao fallback
    (parallel/reconstruct.py::batch_reconstruct), whose secrets and
    per-destination error counts are returned instead."""
    k = t + 1
    if packed.dtype != torch.int32 or packed.dim() != 3 \
            or packed.shape[0] != PL or packed.shape[1] != n:
        raise ValueError(f"packed must be int32 [{PL}, {n}, B], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed shares must be contiguous")
    B = packed.shape[-1]
    if B % k != 0:
        raise ValueError(f"batch {B} is not a multiple of t+1 = {k}")
    if not direct_fits(n, k):
        raise ValueError(f"direct open needs n > t+1 <= {KMAX_DIRECT}, "
                         f"got n={n}, t+1={k}")
    points = _norm_points(tuple(points))
    if len(points) != n:
        raise ValueError(f"{len(points)} points for n={n} parties")

    if packed.is_cuda:
        sec, nerr = _open_direct_cuda(packed, n, k, points)
    else:
        sec, nerr = _open_direct_plain(packed, n, k, points)
    if not replicate:
        return sec, nerr
    secrets = sec[:, None, :].expand(PL, n, B)
    if robust and int(nerr.sum()) != 0:
        from ..parallel.mesh import SimBackend
        from ..parallel.reconstruct import batch_reconstruct
        sec2, nerr = batch_reconstruct(SimBackend(n),
                                       FpArray(unpack_limbs(packed)), n, t,
                                       robust=True)
        secrets = pack_limbs(sec2.limbs)
    return secrets, nerr
