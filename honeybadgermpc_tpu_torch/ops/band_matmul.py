"""Generic folded-band matmul against a HOST-CONSTANT int matrix.

Counterpart of ``honeybadgermpc_tpu/ops/band_matmul.py``.

out[..., m] = sum_k a[..., k] * mat[k][m]  over GF(p), a and out in
Montgomery form, mat in plain ints (the host fold pre-multiplies by
2^(16*rounds) so the REDC epilogue lands back in Montgomery form — same
scheme as ops/fused_open.py).

This is the engine behind Vandermonde batch evaluation at protocol-constant
point sets (share dealing). Input [L, B, k] is packed (2x16-bit limbs per
word) to [PL, B, k]; on a CUDA tensor the hand-written kernel
``csrc/band_matmul.cu`` indexes that layout directly and writes
[PL, B, m]. ``_band_matmul_plain`` is the plain PyTorch version.
"""

from __future__ import annotations

import functools

import torch

from .band_gemm import _fold_array, _gemm_band, _gemm_plan
from .fused_open import (KMAX, NBAL, PL, _bal_bias, _bal_fold_init,
                         _band_dot_fold, _folded_band_host, _launch_stream,
                         _pack16, _pad_band, _planes_of_packed, _round8,
                         pack_limbs, unpack_limbs)

launches = 0      # times the CUDA kernel was launched (and nowhere else)


def band_fits(k: int, m: int) -> bool:
    return k <= KMAX and m <= 128


@functools.lru_cache(maxsize=None)
def _band_host(mat_key: tuple):
    """mat_key: tuple-of-tuples plain-int matrix [k][m] (hashable) ->
    the reference's int8 band [1, NBAL*mp, NBAL*k] and mp = round8(m)."""
    k, m = len(mat_key), len(mat_key[0])
    mp = _round8(m)
    band = _pad_band(_folded_band_host(
        [list(r) for r in mat_key], 2, mp), k * NBAL)
    return band, mp


@functools.lru_cache(maxsize=None)
def _band_device(mat_key: tuple, device: torch.device):
    """The band on `device`: reference layout int8 [NBAL*mp, NBAL*k] for
    the plain version, and for CUDA also the kernel's tile layout
    [ceil(m/2), k, 2048] int8 (see band_gemm._gemm_band)."""
    band, mp = _band_host(mat_key)
    k, m = len(mat_key), len(mat_key[0])
    ref = torch.from_numpy(band[0]).to(device)
    kern = None
    if device.type == "cuda":
        kern = torch.from_numpy(_gemm_band(band[0], mp, k, m)).to(device)
    return ref, kern, mp


def _band_matmul_plain(packed, mat_key: tuple):
    """Plain PyTorch version: packed int32 [PL, B, k] -> [PL, B, m]."""
    k, m = len(mat_key), len(mat_key[0])
    band, _, mp = _band_device(mat_key, packed.device)
    planes = _planes_of_packed(packed.transpose(1, 2))    # [NBAL*k, B]
    out = _pack16(_band_dot_fold(band, planes, mp, _bal_fold_init(k),
                                 _bal_bias(k)))            # [PL, mp, B]
    return out[:, :m].transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _band_launcher(mat_key: tuple, device: torch.device):
    """Everything a launch needs that does not depend on the operand: the
    kernel entry, the band on the device, the fold constants and the SM
    count. Cached, so a call costs one allocation and one launch."""
    from .._build import lib
    fn = lib().hb_band_matmul
    k, m = len(mat_key), len(mat_key[0])
    _, band, _ = _band_device(mat_key, device)
    fold = _fold_array(_bal_fold_init(k), _bal_bias(k))
    nsm = torch.cuda.get_device_properties(device).multi_processor_count

    def launch(packed):
        B = packed.shape[1]
        out = torch.empty((PL, m, B), dtype=torch.int32, device=device)
        rc = fn(packed.data_ptr(), band.data_ptr(), out.data_ptr(), B, k, m,
                _gemm_plan(k, B, nsm), fold, _launch_stream(packed))
        return rc, out.transpose(1, 2)

    return launch


def _band_matmul_cuda(packed, mat_key: tuple):
    """Launch csrc/band_matmul.cu: packed int32 [PL, B, k] -> [PL, B, m],
    the transposed view of the kernel's lane-contiguous [PL, m, B]."""
    global launches
    rc, out = _band_launcher(mat_key, packed.device)(packed)
    launches += 1
    if rc != 0:
        raise RuntimeError(
            f"band_matmul kernel launch failed: CUDA error {rc}")
    return out


def band_matmul_packed(packed, mat_key: tuple):
    """packed int32 [PL, B, k] x plain-int mat[k][m] -> packed [PL, B, m]:
    the kernel on a CUDA tensor (a view with the lanes contiguous), the
    plain version on a CPU tensor (contiguous)."""
    k, m = len(mat_key), len(mat_key[0])
    if packed.dtype != torch.int32 or packed.dim() != 3 \
            or packed.shape[0] != PL or packed.shape[2] != k:
        raise ValueError(f"packed must be int32 [{PL}, B, {k}], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed operand must be contiguous")
    if not band_fits(k, m):
        raise ValueError(f"band matmul needs k <= {KMAX}, m <= 128, "
                         f"got k={k}, m={m}")
    if packed.is_cuda:
        return _band_matmul_cuda(packed, mat_key)
    return _band_matmul_plain(packed, mat_key)


def band_matmul_limbs(a_limbs, mat_key: tuple):
    """a[L, B, k] (Montgomery limbs) x plain-int mat[k][m] -> [L, B, m]."""
    packed = pack_limbs(a_limbs)                   # [PL, B, k], contiguous
    return unpack_limbs(band_matmul_packed(packed, mat_key))
