"""Port parity: the host-side band construction and the packed format of
honeybadgermpc_tpu_torch against the JAX reference's. The int8 bands must
be byte-identical; tolerance everywhere: exact equality."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fused_open as ref_fo
from honeybadgermpc_tpu.ops import fused_open_direct as ref_fod
from honeybadgermpc_tpu_torch.interop import (from_reference_packed,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import band_matmul as port_bm
from honeybadgermpc_tpu_torch.ops import fused_open as port_fo
from honeybadgermpc_tpu_torch.ops import fused_open_direct as port_fod
from honeybadgermpc_tpu_torch.ops import limbs as port_limbs
from honeybadgermpc_tpu_torch.ops.fpmatmul import _vandermonde_int_rows

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

P = port_limbs.P


def _rand_ints(seed, count):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(count)]


@pytest.mark.parametrize("name", ["TB", "PL", "NBAL", "_BAL_ROUNDS", "KMAX"])
def test_scheme_constants_match_reference(name):
    assert getattr(port_fo, name) == getattr(ref_fo, name)


def test_direct_constants_match_reference():
    assert port_fod.ZG == ref_fod.ZG
    assert port_fod.KMAX_DIRECT == ref_fod.KMAX_DIRECT


@pytest.mark.parametrize("k", [1, 3, 22, 43, 64, 128])
def test_bias_and_fold_init_match_reference(k):
    assert port_fo._bal_bias(k) == ref_fo._bal_bias(k)
    assert port_fo._bal_fold_init(k) == ref_fo._bal_fold_init(k)


def test_bal_digits_and_lam_int_match_reference():
    for x in [0, 1, 127, 128, 255, 256, P - 1] + _rand_ints(5, 20):
        d = port_fo._bal_digits(x)
        assert d == ref_fo._bal_digits(x)
        assert sum(v << (8 * i) for i, v in enumerate(d)) == x
        assert all(-128 <= v <= 127 for v in d)
    xs = tuple(_rand_ints(6, 5))
    for x0 in (0, 7, xs[2]):
        assert port_fo._lam_int(xs, x0) == ref_fo._lam_int(xs, x0)
    assert [port_fo._round8(v) for v in (1, 8, 9, 43)] == \
        [ref_fo._round8(v) for v in (1, 8, 9, 43)]


def test_folded_band_host_byte_identical():
    mat = [_rand_ints(7 + i, 5) for i in range(3)]          # [k=3][ncols=5]
    got = port_fo._folded_band_host(mat, 2, 8)
    want = ref_fo._folded_band_host(mat, 2, 8)
    assert got.dtype == np.int8 and got.shape == (32 * 8, 32 * 3)
    assert np.array_equal(got, want)
    assert np.array_equal(port_fo._pad_band(got, 128),
                          ref_fo._pad_band(want, 128))


@pytest.mark.parametrize("n,k", [(8, 3), (7, 3), (64, 22)])
def test_direct_band_byte_identical(n, k):
    points = tuple(range(1, n + 1))
    got, ngrp, kcols = port_fod._direct_band(points, k)
    want, ngrp_r, kcols_r = ref_fod._direct_band(points, k)
    assert (ngrp, kcols) == (ngrp_r, kcols_r)
    assert got.dtype == np.int8 and np.array_equal(got, want)


def test_matmul_band_byte_identical():
    mat_key = _vandermonde_int_rows(tuple(range(1, 9)), 3)
    band, mp = port_bm._band_host(mat_key)
    want = ref_fo._pad_band(ref_fo._folded_band_host(
        [list(r) for r in mat_key], 2, ref_fo._round8(8)), 3 * 32)
    assert mp == 8 and np.array_equal(band, want)


@pytest.mark.parametrize("ncp,k", [(8, 3), (16, 5)])
def test_kernel_band_is_the_reference_dot(ncp, k):
    """The CUDA kernels' band layout is the A operand of
    ``mma.sync.m16n8k32.s8`` in thread-fragment order. Rebuild each 16x32
    A tile from the fragments by the PTX layout (register j of thread l:
    row g + 8*(j & 1), columns 16*(j >> 1) + 4*tg + 0..3), multiply it with
    a lane's balanced digits of operand kk (the B operand of k-step kk) and
    sum over the k-steps: that must give the reference band's diagonals."""
    rng = np.random.default_rng(17)
    band = rng.integers(-128, 128, (32 * ncp, 32 * k), dtype=np.int8)
    digits = rng.integers(-128, 128, (k, 32), dtype=np.int8)   # [kk][s]
    planes = digits.T.reshape(32 * k).astype(np.int64)          # row s*k+kk
    want = (band.astype(np.int64) @ planes).reshape(32, ncp)    # [r][col]
    frag = port_fo._kernel_band(band, ncp, k)
    assert frag.dtype == np.int32 and frag.shape == (ncp, k, 2, 32, 4)
    fb = np.ascontiguousarray(frag).view(np.int8).reshape(
        ncp, k, 2, 32, 4, 4)                     # col, kk, mt, l, j, e
    got = np.zeros((32, ncp), np.int64)
    for col in range(ncp):
        for kk in range(k):
            for mt in range(2):
                tile = np.zeros((16, 32), np.int64)
                for l in range(32):
                    g, tg = l >> 2, l & 3
                    for j in range(4):
                        row = g + 8 * (j & 1)
                        c0 = 16 * (j >> 1) + 4 * tg
                        tile[row, c0:c0 + 4] = fb[col, kk, mt, l, j]
                got[16 * mt:16 * mt + 16, col] += \
                    tile @ digits[kk].astype(np.int64)
    assert np.array_equal(got, want)


def test_smem_plan_fits_a_hopper_block():
    for k in (1, 3, 22, 43, 64, 100, 128):
        tl, wg = port_fo._smem_plan(k)
        warps = tl * wg // 32
        assert tl % 32 == 0 and tl * wg in (256, 512)
        smem = 8 * k * (tl + 8) * 4 + warps * 32 * 40 * 4 + 4 * 255
        assert smem <= 227 * 1024, (k, smem)
    assert port_fo._smem_plan(22) == (64, 8)


def test_pack_unpack_roundtrip_and_reference_words():
    vals = [0, 1, P - 1, 0xFFFF, 0x8000 << 16, (1 << 256) - 1] + \
        _rand_ints(9, 26)
    limbs = port_limbs.ints_to_limbs(np.array(vals, object).reshape(4, 8))
    t = torch.from_numpy(limbs.view(np.int32))
    packed = port_fo.pack_limbs(t)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (8, 4, 8)
    assert torch.equal(port_fo.unpack_limbs(packed), t)
    want = np.asarray(ref_fo.pack_limbs(jnp.asarray(limbs)))
    assert np.array_equal(to_reference_packed(packed), want)
    assert torch.equal(from_reference_packed(want, "cpu"), packed)
    assert np.array_equal(
        np.asarray(ref_fo.unpack_limbs(jnp.asarray(want))),
        port_fo.unpack_limbs(packed).numpy().view(np.uint32))


def test_cuda_header_constants_match_limbs():
    """csrc/field_core.cuh hard-codes p's limbs and N0; hold them against
    ops/limbs.py (the CUDA sources cannot be compiled on the CPU)."""
    path = os.path.join(os.path.dirname(port_fo.__file__), "..", "csrc",
                        "field_core.cuh")
    src = open(path).read()
    body = re.search(r"kP\[L\] = \{([^}]*)\}", src).group(1)
    got = [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    assert got == [int(x) for x in port_limbs.P_LIMBS]
    n0 = re.search(r"N0 = (0x[0-9A-Fa-f]+)u", src).group(1)
    assert int(n0, 16) == port_limbs.N0
    for name, val in (("L", 16), ("PL", 8), ("NBAL", 32), ("NL", 19),
                      ("BAL_ROUNDS", 2), ("D_STRIDE", port_fo._D_STRIDE)):
        assert re.search(rf"constexpr int {name} = {val};", src), name
