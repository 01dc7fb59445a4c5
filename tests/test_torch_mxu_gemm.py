"""Port parity: the host side of rows 13 and 14 on the wgmma core
(honeybadgermpc_tpu_torch/ops/mxu_matmul.py, csrc/band_gemm.cuh's
mxu_gemm_body). The kernels run only on the card (chip_smoke.py holds them
against their plain versions there); here their layouts are read back the
way their shared-memory descriptors walk them, the plane build and the
epilogue's shuffle exchange are run by their plain twins, and the whole
model (planes, band tiles, dot, epilogue) is held against the plain
versions and against the reference's words (golden vectors,
tests/_golden.py). Inputs come from numpy seeds; tolerance: exact equality
everywhere."""

import numpy as np
import pytest
import torch

from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import mxu_matmul as mxu
from honeybadgermpc_tpu_torch.ops.band_gemm import _desc_walk
from honeybadgermpc_tpu_torch.ops.limbs import P, ints_to_limbs

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

TM = mxu.TM
OCT = TM // 8


def _limbs(seed, *shape):
    """int32 Montgomery limbs [L, *shape] of uniform values below p."""
    rng = np.random.default_rng(seed)
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(count)]
    return from_reference_limbs(
        ints_to_limbs(np.array(vals, object).reshape(shape)), "cpu")


def _walk_tiles(tiles):
    """Band tiles int8 [ntiles, ksteps, 2560] read through their B
    descriptors (LBO 1280, SBO 128) -> int64 [ntiles, 80, 32 ksteps]."""
    t = tiles.numpy().astype(np.int64)
    nt, ks, _ = t.shape
    out = np.zeros((nt, mxu.TN, 32 * ks), np.int64)
    for i in range(nt):
        for s in range(ks):
            out[i, :, 32 * s:32 * s + 32] = _desc_walk(
                t[i, s], 0, (mxu.TN // 8) * 128, 128, mxu.TN)
    return out


def _walk_planes(a):
    """Every chunk image of a [L, B, k] (the plane warpgroup's twin) read
    through the A descriptors of both 64-lane blocks -> int64 [blocks *
    128, 32 ksteps]: the digit rows of every lane in the kernel's
    contraction order."""
    _, B, k = a.shape
    nblk = -(-B // TM)
    out = np.zeros((nblk * TM, 32 * mxu._mxu_ksteps(k)), np.int64)
    ks = 0
    for c in range(-(-k // mxu.MXU_KC)):
        img = mxu._mxu_chunk_image(a, c).astype(np.int64)
        # nothing past the chunk's k-steps: a resident last chunk ends there
        assert not img[:, 32 * TM * mxu._chunk_steps(k, c):].any()
        for kl in range(mxu._chunk_steps(k, c)):
            for blk in range(nblk):
                for mb in range(2):
                    rows = slice(blk * TM + 64 * mb, blk * TM + 64 * mb + 64)
                    out[rows, 32 * (ks + kl):32 * (ks + kl) + 32] = \
                        _desc_walk(img[blk], (2 * kl * OCT + 8 * mb) * 128,
                                   16 * TM, 128, 64)
        ks += mxu._chunk_steps(k, c)
    return out


def _band(row, v, k):
    """(band digits [n, nd, k, 37] (column, diagonal, operand, digit),
    band tiles) of row 13 (folded digits) or row 14 (the scaled planes'
    dense band)."""
    if row == 13:
        wd = mxu._folded_band_digits(v, mxu._rounds_for(k))
        return wd.permute(1, 3, 0, 2), mxu._fused2_tiles(wd)
    v8 = mxu._scaled_planes(v)                                # [k, n, 37]
    band = torch.zeros((v8.shape[1], mxu.NOUT, k, mxu.NPLANES),
                       dtype=torch.int8)
    for l in range(mxu.NOUT):
        for d in range(max(0, l - 36), min(l, 36) + 1):
            band[:, l, :, d] = v8[:, :, l - d].t()
    return band, mxu._fused_tiles(v8)


@pytest.mark.parametrize("row", [13, 14])
@pytest.mark.parametrize("n", [4, 5, 43])
@pytest.mark.parametrize("k", [1, 22, 33])
def test_band_tiles_walked_by_their_descriptor_are_the_band_digits(row, n, k):
    """Tile t at k-step s, read through its B descriptor, is 80 rows x 32
    digit rows: row r holds column t * (4 / h) + c, diagonal dg
    (_mxu_tile_rows), at digit row (kk, d) of _mxu_digit_rows, and zero at
    padding rows and padding digit rows. Digit rows cross the chunk edge
    (16 operands) at k = 22 and 33."""
    h = 2 if row == 13 else 4
    digits, tiles = _band(row, _limbs(7 * n + k, k, n), k)
    want = digits.numpy().astype(np.int64)
    nd = want.shape[1]
    got = _walk_tiles(tiles)
    cpt = 4 // h
    assert got.shape == (-(-n // cpt), mxu.TN, 32 * mxu._mxu_ksteps(k))
    col, dg = (x.numpy() for x in mxu._mxu_tile_rows(h))
    qrows = mxu._mxu_digit_rows(k).numpy()
    full = np.zeros(got.shape, np.int64)
    for t in range(got.shape[0]):
        for r in range(mxu.TN):
            c = t * cpt + col[r]
            if c < n and dg[r] < nd:
                full[t, r, qrows] = want[c, dg[r]].reshape(-1)
    assert np.array_equal(got, full)


@pytest.mark.parametrize("B,k", [(1, 1), (130, 17), (200, 22), (64, 33)])
def test_planes_walked_by_their_descriptor_are_planes7(B, k):
    """The plane warpgroup's chunk images (items of 4 operands as 37
    words), read through the wgmma A descriptors, hold _planes7's digit d
    of operand kk of every lane at digit row (kk, d) of _mxu_digit_rows;
    lanes past B and operands past k are zero, and no item writes past its
    chunk's k-steps (k = 17, 22: a last chunk of 1 and 6 operands)."""
    a = _limbs(B + 3 * k, B, k)
    got = _walk_planes(a)
    want = np.zeros(got.shape, np.int64)
    want[:B, mxu._mxu_digit_rows(k).numpy()] = \
        mxu._planes7(a).reshape(B, -1).numpy()
    assert np.array_equal(got, want)


def _diagonals(seed, B, n, nd, k):
    """Random diagonals int64 [B, n, nd] of a contraction over k operands
    (each below 37 k 127^2, the largest an int8 dot of 7-bit digits
    gives), their largest values at the top."""
    rng = np.random.default_rng(seed)
    top = mxu.NPLANES * k * 127 * 127
    d = rng.integers(0, top, size=(B, n, nd), dtype=np.int64)
    d[0] = top - 1
    return torch.from_numpy(d)


@pytest.mark.parametrize("k", [16, 17, 27, 28, 55, 56])
def test_epilogue_model_equals_the_plain_epilogues(k):
    """mxu_gemm_body's exchange (each of a column's h threads sends the
    diagonals of the lane slots the others own, over xor shuffles) and its
    fold, modelled by _mxu_epilogue, equal _fold_reduce (row 13: 1 REDC
    round at k <= 27, 2 above; pairs only to k = 55) and _redc_diagonals
    (row 14) on the same diagonals, at a ragged batch (200 lanes: two
    blocks, the second part empty) and column count."""
    B, n = 200, 5
    d37 = _diagonals(k, B, n, mxu.NPLANES, k)
    r = mxu._rounds_for(k)
    fold = (lambda ds: mxu._fold_reduce(ds, r))
    got = mxu._mxu_epilogue(d37, 2, fold)
    want = fold(d37.permute(2, 0, 1).reshape(mxu.NPLANES, -1))
    assert torch.equal(got, want.reshape(-1, B, n))
    d73 = _diagonals(k + 1, B, n, mxu.NOUT, k)
    got = mxu._mxu_epilogue(d73, 4, mxu._redc_diagonals)
    want = mxu._redc_diagonals(d73.permute(2, 0, 1).reshape(mxu.NOUT, -1))
    assert torch.equal(got, want.reshape(-1, B, n))


def _model(row, a, v):
    """The kernel's arithmetic end to end on the CPU: the planes from the
    plane warpgroup's twin and the band tiles, both read through their
    descriptors, an exact integer dot per tile row, the diagonals taken
    from the tile rows as the accumulators hold them, the epilogue's twin.
    -> int32 [L, B, n]."""
    _, B, k = a.shape
    n = v.shape[2]
    h = 2 if row == 13 else 4
    planes = _walk_planes(a)                               # [lanes, q]
    band = _walk_tiles(_band(row, v, k)[1])                # [tiles, 80, q]
    # exact in float64: every sum is below 37 k 127^2 < 2^31
    nt = band.shape[0]
    acc = (planes.astype(np.float64) @ band.reshape(nt * mxu.TN, -1).T.astype(
        np.float64)).astype(np.int64).reshape(-1, nt, mxu.TN)  # [lanes, t, 80]
    col, dg = (x.numpy() for x in mxu._mxu_tile_rows(h))
    nd = mxu.NPLANES if row == 13 else mxu.NOUT
    cpt = 4 // h
    diag = np.zeros((acc.shape[0], band.shape[0] * cpt, h * mxu.HALF),
                    np.int64)
    for r in range(mxu.TN):
        diag[:, col[r]::cpt, dg[r]] = acc[:, :, r]
    diag = torch.from_numpy(diag[:B, :n, :nd])
    if row == 13:
        r = mxu._rounds_for(k)
        return mxu._mxu_epilogue(diag, h, lambda ds: mxu._fold_reduce(ds, r))
    return mxu._mxu_epilogue(diag, h, mxu._redc_diagonals)


def _mat(seed, rows, cols):
    """tests/test_torch_fp_matmul.py's inputs (the golden vectors')."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % P
            for _ in range(rows * cols)]
    return ints_to_limbs(np.array(vals, object).reshape(rows, cols))


@pytest.mark.parametrize("B,k,n", [(256, 5, 7), (256, 22, 64), (130, 31, 8)])
def test_row13_model_equals_the_reference_and_the_plain_version(B, k, n):
    """Row 13's model at tests/test_torch_fp_matmul.py's fused2 shapes (1
    and 2 REDC rounds, one and two chunks, ragged blocks) gives the
    reference fp_matmul_mxu2's words (golden vectors) and the plain
    version's."""
    a, v = _mat(B + k, B, k), _mat(n, k, n)
    ta, tv = from_reference_limbs(a, "cpu"), from_reference_limbs(v, "cpu")
    got = _model(13, ta, tv)
    want = golden("fp_matmul_fused2_route")[f"{B}_{k}_{n}"]
    assert np.array_equal(to_reference_limbs(got), want)
    r = mxu._rounds_for(k)
    assert torch.equal(got, mxu._fused2_plain(
        ta.contiguous(), mxu._folded_band_digits(tv, r), r))


def test_row14_model_equals_the_reference_and_the_plain_version():
    """Row 14's model at the reference's fast-tier shape (B=256, k=9,
    n=12) gives its fp_matmul_mxu words (golden vectors) and the plain
    version's; and at k = 40 (three chunks) the plain version's."""
    a, v = _mat(7, 256, 9), _mat(8, 9, 12)
    ta, tv = from_reference_limbs(a, "cpu"), from_reference_limbs(v, "cpu")
    got = _model(14, ta, tv)
    assert np.array_equal(to_reference_limbs(got),
                          golden("fp_matmul_mxu_fused_route")["out"])
    assert torch.equal(got, mxu._fused_plain(ta.contiguous(), tv))
    ta, tv = _limbs(40, 70, 40), _limbs(41, 40, 3)
    assert torch.equal(_model(14, ta, tv), mxu._fused_plain(ta, tv))


@pytest.mark.parametrize("k,n,h,want,scratch", [
    (22, 43, 2, (1, 2), True), (38, 4, 2, (1, 3), True),
    (39, 4, 2, (1, 2), True), (80, 43, 2, (11, 2), False),
    (438, 4, 2, (1, 2), True), (512, 4, 4, (2, 2), False),
    (204, 16, 4, (8, 2), False), (9, 12, 4, (1, 1), True),
    (1, 200, 2, (1, 1), False)])
def test_mxu_plan(k, n, h, want, scratch):
    """Resident planes (one chunk buffer per chunk, one block per 128
    lanes) up to k = 38; above, two chunk buffers and one tile per
    consumer warpgroup: ceil(tiles / 2) blocks per 128 lanes. Both fit a
    Hopper block's 227 KB. The results go out through the scratch tensor
    where one block holds all columns and one limb of them fits in the
    planes and rings (not at k=1, n=200: 2 k-steps)."""
    tgroups, nbuf, smem = mxu._mxu_plan(k, n, h)
    assert (tgroups, nbuf) == want
    assert smem <= mxu.SMEM_MAX
    assert smem == mxu._mxu_smem_bytes(k, nbuf)
    assert mxu._mxu_out_plan(k, n, h) == scratch
