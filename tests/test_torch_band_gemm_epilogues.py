"""Port parity: the kernels on the wgmma band core that bring their own
operand source or epilogue policy (csrc/band_gemm.cuh): the compare and
count (CompareEpi) of K2 of the three-kernel open and of the per-column
check (csrc/open_fused.cu) and of the direct open (csrc/open_direct.cu),
each with its own charge, the per-column and the aggregated extraction
(csrc/randousha_extract.cu, ExtractPcEpi and ExtractAggEpi) and the deal
(csrc/randousha_deal.cu, DrawSrc). The kernels
run only on the card (chip_smoke.py holds them against their plain
versions there); here their host layouts are held against the reference's
bands, and a plain model of what they do (the lane maps of their C
entries, the drawn operands, the planes and the dot as the descriptors
walk them, the core's split of (lane, column) pairs over consumer threads,
the policy's store, compare and count) is held against the port's plain
versions and the reference's golden stage outputs (tests/_golden.py).
Tolerance: exact equality everywhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from honeybadgermpc_tpu.ops import fused_open as ref_fo
from honeybadgermpc_tpu.ops.fused_open_direct import \
    sim_open_direct_packed as ref_direct
from honeybadgermpc_tpu_torch.interop import (from_reference_check,
                                              from_reference_packed,
                                              from_reference_receive,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import band_gemm as bg
from honeybadgermpc_tpu_torch.ops import fused_open as fo
from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod
from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
from honeybadgermpc_tpu_torch.ops import montgomery as mont
from honeybadgermpc_tpu_torch.ops.limbs import P

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

TILE = bg.STEP_BYTES
M32 = 0xFFFFFFFF
JUNK = 0x5A5A5A5A          # what an output holds before the kernel writes


def _walk_tiles(tiles, band, ncp, k, m, order=None):
    """Every tile of `tiles`, read through the kernel's B descriptor, is
    the reference band's rows (diagonal r of kernel column col, which is
    reference column col or order[col]; digits s at column s*k + kk);
    columns m.. of an odd last tile are zero."""
    colt, diag = bg._tile_rows()
    ntiles = -(-m // 2)
    assert tiles.shape == (ntiles, k, TILE)
    ref = np.arange(2 * ntiles) if order is None else \
        np.array(list(order) + [0] * (2 * ntiles - m))
    for ct in range(ntiles):
        cols = 2 * ct + colt
        want_rows = diag * ncp + ref[cols]
        for kk in range(k):
            got = bg._desc_walk(tiles[ct, kk], 0, 1024, 128, 64)
            want = band[want_rows, kk::k][:, :32].copy()
            want[cols >= m] = 0
            assert np.array_equal(got, want), (ct, kk)
            assert not got[cols >= m].any()


@pytest.mark.parametrize("k", [22, 43])
def test_k2_tiles_walked_by_their_descriptor_are_the_reference_band(k):
    """K2's band at n=64 in band_gemm tiles (nv+1 = 43 columns at k=22: a
    half-empty last tile; 22 at k=43) is the reference's R1 band; the
    per-column check runs on the same tiles. Every stage of the open runs
    on the core: the kernel bands are tiles only (no mma.sync fragment
    band), K1's the reference's encode band."""
    n = 64
    points = tuple(range(1, n + 1))
    band, ncp = ref_fo._bands_np(points, k)[1]
    bands = fo._open_kernel_bands(points, k)
    assert len(bands) == 3
    _walk_tiles(bands[1], band[0], ncp, k, n - k + 1)
    enc, n1 = ref_fo._bands_np(points, k)[0]
    _walk_tiles(bands[0], enc[0], n1, k, n)


@pytest.mark.parametrize("n,k", [(64, 22), (64, 43), (8, 3), (8, 2)])
def test_direct_tiles_are_k2s_tiles(n, k):
    """The direct open's band (the reference's _direct_band: groups of 8
    columns [lam(points[k:]) | lam0]) laid side by side and re-laid by
    _gemm_band gives K2's R1 tiles byte for byte, so the direct open and
    K2 run the same band (nv+1 = 43, 22, 6 and 7 columns: half-empty last
    tiles at 43 and 7); at n=8, walked by the B descriptor, it is the
    reference's R1 band (at n=64 the K2 test above walks the same bytes)."""
    points = tuple(range(1, n + 1))
    tiles = fod._direct_tiles(points, k)
    assert np.array_equal(tiles, fo._open_kernel_bands(points, k)[1])
    if n == 8:
        band, ncp = ref_fo._bands_np(points, k)[1]
        _walk_tiles(tiles, band[0], ncp, k, n - k + 1)


def test_direct_route_pins_the_core_and_the_large_k_kernel():
    """The direct open runs on the core wherever a 64-lane block's planes
    fit shared memory beside its rings (k <= 81) and on the mma.sync
    kernel from k = 82 to KMAX_DIRECT = 128; the launch plan at the open's
    shape (B = 16,896 = 132 x 128 lanes) and at the triple call's k = 43
    opens (B = 43 x 392) is 128-lane blocks, the check's at k = 22 256
    lanes."""
    assert bg.smem_bytes(81, 1) <= bg.SMEM_MAX < bg.smem_bytes(82, 1)
    assert [fod._direct_route(k) for k in (1, 22, 43, 64, 81)] == \
        ["wgmma"] * 5
    assert [fod._direct_route(k) for k in (82, 86, 128)] == ["mma_sync"] * 3
    assert fod.KMAX_DIRECT == 128 and not fod.direct_fits(200, 129)
    assert bg._gemm_plan(22, 16896) == 2
    assert bg._gemm_plan(43, 43 * 392) == 2
    assert fr._deal_plan(22, 48 * 4096) == bg._gemm_plan(22, 48 * 4096) == 4


@pytest.mark.parametrize("ncp,k,rowlen", [(8, 8, 256), (64, 64, 2048)])
def test_gemm_band_index_relays_a_band_into_the_tiles(ncp, k, rowlen):
    """The per-column extraction re-lays its reference-layout band on the
    device with one gather through _gemm_band_index: the gather gives
    exactly _gemm_band's bytes, and every byte of the m columns once."""
    rng = np.random.default_rng(ncp + k)
    band = rng.integers(-128, 128, (32 * ncp, rowlen)).astype(np.int8)
    idx = bg._gemm_band_index(ncp, k, k, rowlen)
    got = torch.from_numpy(band).reshape(-1)[torch.from_numpy(idx)]
    assert np.array_equal(got.numpy(), bg._gemm_band(band, ncp, k, k))
    assert len(np.unique(idx)) == idx.size == 32 * k * 32 * k


# -- a plain model of the core's epilogue ------------------------------------

def _owners(nlanes, m, mb, groups=1):
    """The consumer threads of band_gemm_body<mb> as it splits the work,
    in order (so 32 consecutive threads are one warp): per thread (its
    lanes, one per 64-lane block; the columns of its tiles; its part among
    the threads of its lanes; their count). With column groups (SPLIT),
    block b serves lane block b // groups and the group b % groups of
    ceil(tiles / groups) consecutive tiles."""
    tm, cons = 64 * mb, bg.consumers(mb)
    ntiles = -(-m // 2)
    tpg = -(-ntiles // groups)
    for blk in range(-(-nlanes // tm)):
        for grp in range(groups):
            t0, t1 = grp * tpg, min(grp * tpg + tpg, ntiles)
            for wgi in range(cons):
                for wl in range(4):
                    for laneid in range(32):
                        g, tg = laneid >> 2, laneid & 3
                        hf, cl = tg & 1, tg >> 1
                        lanes = [blk * tm + 64 * b + 16 * wl + g + 8 * hf
                                 for b in range(mb)]
                        cols = [2 * ct + cl
                                for ct in range(t0 + wgi, t1, cons)]
                        yield lanes, cols, wgi * 2 + cl, cons * 2


def _results(flat, mp, band, ncp):
    """The core's result words of every (lane, column): operands through
    the lane map mp = (nlanes, C, sw, sp, sc, si, k) of the C entry, the
    reference band's diagonals, the kernel's 32-bit fold
    (_fold_reduce_words). -> int64 [PL, ncp, nlanes] (uint32 values)."""
    nlanes, C, sw, sp, sc, si, k = mp
    g = torch.arange(nlanes)
    base = (g // C) * sp + (g % C) * sc
    ops = torch.stack([torch.stack([flat[w * sw + base + i * si]
                                    for i in range(k)]) for w in range(8)])
    d = fo._int_dot(torch.from_numpy(band[:, :32 * k]),
                    fo._planes_of_packed(ops))
    fold = bg._word_fold_consts(fo._bal_fold_init(k), fo._bal_bias(k))
    words = bg._fold_reduce_words([d[r * ncp:(r + 1) * ncp]
                                   for r in range(32)], fold)
    return words.to(torch.int64) & M32


def _compare_model(flat, mp, band, ncp, nv, mb, charge, ns=1, groups=1):
    """CompareEpi on the core as the kernel runs it, for the lanes of the
    map mp (every caller's map puts operand i, word w of lane g at
    flat[w*sw + i*si + g]): column col < nv compared with the words fetched
    at operand k + col, columns nv .. nv+ns-1 stored to vals [PL, ns,
    nlanes] at the lane (K2, the check, the direct open: ns = 1, vals
    [PL, nlanes]), a column past them nothing; with `groups` column groups
    over blocks. The charge: "group" (K2) and "lane" (the check) add a
    thread's count of a lane to errs[g // C] or errs[g] in finish, one
    atomic when not 0; "source" (the direct open) counts the 16 lanes of a
    warp's column half together (key: the lane's 16-lane group of its warp
    and 64-lane block, and the column) and adds the count to errs[col] in
    one atomic when not 0; "total" (K3) sums the counts of a warp's 32
    threads for each of their 64-lane blocks in finish and adds the sum to
    errs[0] in one atomic when not 0. -> (vals int32 [PL * ns * nlanes],
    errs int64 dict index -> count, the number of atomics). vals starts as
    junk, so a word nobody writes shows."""
    nlanes, C, sw, _, _, si, k = mp
    words = _results(flat, mp, band, ncp)
    vals = torch.full((8 * ns * nlanes,), JUNK, dtype=torch.int64)
    errs, warp, atomics = {}, {}, 0
    for th, (lanes, tcols, _, _) in enumerate(
            _owners(nlanes, nv + ns, mb, groups)):
        for b, g in enumerate(lanes):
            bad = 0
            for col in tcols:
                miss = False
                if g < nlanes and col < nv:
                    recv = flat[[w * sw + (k + col) * si + g
                                 for w in range(8)]]
                    miss = bool((words[:, col, g] != recv).any())
                elif g < nlanes and col < nv + ns:
                    vals[[(w * ns + col - nv) * nlanes + g
                          for w in range(8)]] = words[:, col, g]
                if charge == "source":
                    key = (g // 16, col)
                    warp[key] = warp.get(key, 0) + miss
                bad += miss
            if charge == "total":
                warp[th // 32, b] = warp.get((th // 32, b), 0) + bad
            elif charge != "source" and bad:
                at = g // C if charge == "group" else g
                errs[at] = errs.get(at, 0) + bad
                atomics += 1
    for key, cnt in warp.items():
        if cnt:
            at = 0 if charge == "total" else key[1]
            errs[at] = errs.get(at, 0) + cnt
            atomics += 1
    return _signed(vals, (8 * ns * nlanes,)), errs, atomics


def _k2_model(cols, points, k, mb):
    """hb_open_fused_k2 as the kernel runs it: lane j*C + c, CompareEpi
    charged to the destination errs[lane // C]."""
    _, n, _, C = cols.shape
    nv = n - k
    mp = (n * C, C, n * n * C, C, 1, n * C, k)
    flat = cols.reshape(-1).to(torch.int64) & M32
    band, ncp = fo._bands_np(points, k)[1]
    vals, errs, _ = _compare_model(flat, mp, band[0], ncp, nv, mb, "group")
    out = torch.zeros(n, dtype=torch.int32)
    for j, cnt in errs.items():
        out[j] = cnt
    return vals.reshape(8, n, C), out


def _direct_model(packed, points, k, mb):
    """hb_open_direct as the kernel runs it: one group of B lanes (lane
    b), operand i at packed[w, i, b], the direct band re-laid side by side
    (_direct_band_flat), CompareEpi charged to the source party: nerr[k +
    col]. -> (sec [PL, B], nerr int32 [n], the number of atomics)."""
    _, n, B = packed.shape
    mp = (B, B, n * B, 0, 1, B, k)
    flat = packed.reshape(-1).to(torch.int64) & M32
    band, ncp = fod._direct_band_flat(points, k)
    sec, errs, atomics = _compare_model(flat, mp, band, ncp, n - k, mb,
                                        "source")
    nerr = torch.zeros(n, dtype=torch.int32)
    for col, cnt in errs.items():
        nerr[k + col] = cnt
    return sec.reshape(8, B), nerr, atomics


def _check_model(chk, points, k, mb):
    """hb_randousha_check as the kernel runs it: one group of ncheckp*sp
    lanes (lane col*sp + slot), operand i at chk[w, i, col, slot], K2's
    band, CompareEpi charged to the lane. -> (vals [PL, ncheckp, sp], errs
    int32 [ncheckp, sp], the number of atomics)."""
    _, n, ncheckp, sp = chk.shape
    lanes = ncheckp * sp
    mp = (lanes, lanes, n * lanes, 0, 1, lanes, k)
    flat = chk.reshape(-1).to(torch.int64) & M32
    band, ncp = fo._bands_np(points, k)[1]
    vals, errs, atomics = _compare_model(flat, mp, band[0], ncp, n - k, mb,
                                         "lane")
    out = torch.zeros(lanes, dtype=torch.int32)
    for g, cnt in errs.items():
        out[g] = cnt
    return vals.reshape(8, ncheckp, sp), out.reshape(ncheckp, sp), atomics


def _cols_of_shares(n, k, C, seed):
    """Consistent K2 input [PL, n_src, n_dst, C]: over the sources, every
    (destination, chunk) is a degree k-1 codeword (K1 of dealt shares)."""
    rng = np.random.default_rng(seed)
    points = tuple(range(1, n + 1))
    coef = [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]
            for _ in range(k * C)]
    shares = np.array([[sum(c * pow(x, a, P) for a, c in enumerate(cf)) % P
                        for cf in coef] for x in points], object)
    view = np.stack([(shares >> (32 * w)) & M32 for w in range(8)])
    view = torch.from_numpy(view.astype(np.uint32).view(np.int32)
                            .reshape(8, n, k, C).copy())
    return fo._k1_plain(view, points), points


@pytest.mark.parametrize("n,k,C,mb", [(8, 3, 40, 1), (8, 2, 40, 2),
                                      (8, 4, 33, 4)])
def test_k2_compare_and_count_model_is_k2_plain(n, k, C, mb):
    """K2's epilogue on the core, modelled: a 64-lane block spans two
    destinations (C = 40, 33), nv+1 is odd at k=2 and k=4 (a half-empty
    last tile). Honest shares: vals equal _k2_plain's, no errors. Faults in
    the last compare column (source n-1) at two destinations inside one
    block, and in the first (source k) at a third: the per-destination
    counts equal _k2_plain's."""
    cols, points = _cols_of_shares(n, k, C, 7 * n + k)
    vals, errs = _k2_model(cols, points, k, mb)
    want_vals, want_errs = fo._k2_plain(cols, points, k)
    assert torch.equal(vals, want_vals)
    assert torch.equal(errs, want_errs) and not errs.any()
    bad = cols.clone()
    bad[3, n - 1, 0, C - 1] ^= 0x10           # dst 0, last compare column
    bad[0, n - 1, 1, 5] ^= 1                  # dst 1, same 64-lane block
    bad[7, k, n - 1, 0] ^= -(1 << 31)         # dst n-1, first compare col
    vals, errs = _k2_model(bad, points, k, mb)
    want_vals, want_errs = fo._k2_plain(bad, points, k)
    assert torch.equal(vals, want_vals)
    assert torch.equal(errs, want_errs)
    assert errs.tolist() == [1, 1] + [0] * (n - 3) + [1]


# -- K3 on the core: the stored range, the one count, column groups --------

@pytest.mark.parametrize("n,k", [(64, 22), (64, 43), (8, 3)])
def test_k3_tiles_walked_by_their_descriptor_are_the_reference_band(n, k):
    """K3's band in band_gemm tiles, walked by the B descriptor, is the
    reference's R2 band [Minv | lam(points[k:])] with its columns in
    _k3_columns order: the nv compare columns first, then the k
    coefficients (32 tiles at n=64; at n=8 four, k = 3 coefficient
    columns after 5 compare columns)."""
    points = tuple(range(1, n + 1))
    band, ncp = ref_fo._bands_np(points, k)[2]
    order = fo._k3_columns(n, k)
    assert sorted(order) == list(range(n)) and order[0] == k
    _walk_tiles(fo._open_kernel_bands(points, k)[2], band[0], ncp, k, n,
                order=order)


def _vals_of_polys(n, k, C, seed):
    """Consistent K3 input vals [PL, n, C]: chunk c holds the values at the
    points 1..n of a random polynomial of degree k-1 (its coefficients as
    ints [C][k])."""
    rng = np.random.default_rng(seed)
    coef = [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]
            for _ in range(C)]
    ys = np.array([[sum(a * pow(x, e, P) for e, a in enumerate(cf)) % P
                    for cf in coef] for x in range(1, n + 1)], object)
    words = np.stack([(ys >> (32 * w)) & M32 for w in range(8)])
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)
                            .copy()), coef


def _k3_model(vals, points, k, mb, groups):
    """hb_open_fused_k3 as the kernel runs it: one group of C lanes (lane
    c), operand i at vals[w, i, c], the R2 band's columns in _k3_columns
    order, CompareEpi charged to errs[0] (the warp's sum, one atomic per
    warp and 64-lane block), the k coefficient columns stored to sec [PL,
    k, C], `groups` column groups. -> (sec, errs int32 [1], atomics)."""
    _, n, C = vals.shape
    mp = (C, C, n * C, 0, 1, C, k)
    flat = vals.reshape(-1).to(torch.int64) & M32
    band, ncp = fo._bands_np(points, k)[2]
    order = list(fo._k3_columns(n, k))
    band = band[0].reshape(32, ncp, -1)[:, order].reshape(32 * n, -1)
    sec, errs, atomics = _compare_model(flat, mp, band, n, n - k, mb,
                                        "total", ns=k, groups=groups)
    return (sec.reshape(8, k, C),
            torch.tensor([errs.get(0, 0)], dtype=torch.int32), atomics)


@pytest.mark.parametrize("n,k,C,mb,groups", [
    (8, 3, 40, 1, 1), (16, 6, 70, 1, 2), (9, 4, 33, 4, 2),
    (16, 5, 130, 2, 2), (64, 22, 70, 1, 2)])
def test_k3_compare_and_count_model_is_k3_plain(n, k, C, mb, groups):
    """K3's epilogue on the core, modelled: ragged 64-lane blocks (C = 40,
    70, 33, 130), an odd column count (n = 9: a half-empty last tile),
    column groups (two groups of 4, 3 + 2, 4 and 16 tiles). Honest: the
    secrets equal _k3_plain's and are the polynomials' coefficients
    (Python ints), no count, no atomic. Faults in the last compare column
    at two lanes of one warp, in the first at the last lane and in an
    interpolating operand (every compare column of its lane): the count
    is _k3_plain's, 3 + (n - k), in one atomic per warp and 64-lane
    block that saw one."""
    points = tuple(range(1, n + 1))
    vals, coef = _vals_of_polys(n, k, C, 11 * n + k)
    sec, errs, atomics = _k3_model(vals, points, k, mb, groups)
    want_sec, want_errs = fo._k3_plain(vals, points, k)
    assert torch.equal(sec, want_sec)
    assert torch.equal(errs, want_errs) and errs.tolist() == [0]
    assert atomics == 0
    got = (sec.to(torch.int64) & M32).numpy().astype(object)
    for c in (0, C // 2, C - 1):
        assert [sum(int(got[w, i, c]) << (32 * w) for w in range(8))
                for i in range(k)] == coef[c]
    bad = vals.clone()
    bad[3, n - 1, 0] ^= 0x10                  # last compare column, lane 0
    bad[0, n - 1, 3] ^= 1                     # ... and lane 3, one warp
    bad[7, k, C - 1] ^= -(1 << 31)            # first compare column
    bad[2, 0, C // 2] ^= 0x100                # an interpolating operand
    sec, errs, atomics = _k3_model(bad, points, k, mb, groups)
    want_sec, want_errs = fo._k3_plain(bad, points, k)
    assert torch.equal(sec, want_sec)
    assert torch.equal(errs, want_errs)
    assert errs.tolist() == [3 + n - k]
    assert 1 <= atomics <= 3 + n - k


def test_k3_column_groups_fill_one_wave_and_the_core_kernels_keep_one():
    """K3 at the programs' shapes (n = 64: 32 tiles; C = 7,820 and 4,001
    chunks) runs 128-lane blocks and splits its tiles into 2 and 4 groups:
    124 and 128 blocks, one wave on 132 SMs (a second wave lost on the
    card). Few chunks take the most groups that keep a tile per consumer
    warpgroup; k = 64's 128-lane planes do not fit, so 64-lane blocks.
    The eight kernels already on the core, at their main-path shapes in
    chip_smoke.py, fill the card with their lane blocks: their plan is
    _gemm_plan's, one group."""
    for k, C, groups, blocks in ((22, 7820, 2, 124), (43, 4001, 4, 128)):
        assert bg._gemm_split(k, C, 64) == (2, groups)
        assert -(-C // 128) * groups == blocks <= 132
        assert bg.smem_bytes(k, 2) <= bg.SMEM_MAX
    assert bg._gemm_split(22, 31, 64) == (2, 10)
    assert bg._gemm_split(3, 5, 8) == (2, 1)          # four tiles
    assert bg._gemm_split(64, 1000, 64) == (1, 8)
    lanes = 64 * 4096
    shapes = [(22, 16896, 64), (22, 16896, 43), (43, 43 * 392, 22),
              (22, 64 * 7820, 64), (43, 64 * 4001, 64), (22, 64 * 7820, 43),
              (43, 64 * 4001, 22), (22, 48 * 4096, 43), (43, 48 * 4096, 22),
              (22, lanes, 64), (43, lanes, 64), (64, lanes, 64),
              (64, lanes, 23)]
    for k, nl, m in shapes:
        assert bg._gemm_split(k, nl, m) == (bg._gemm_plan(k, nl), 1)


def _direct_faults(packed, n, k):
    """Faults of the direct open's and the check's tests (lanes along the
    last axis): source n-1 (the last compare column) at lanes 3 and 12 (16
    lanes of one warp, one 64-lane block), source k (the first compare
    column) at lane 70, interpolating party 0 at the last lane (every
    compare column of that lane)."""
    bad = packed.clone().reshape(8, n, -1)
    bad[3, n - 1, 3] ^= 0x10
    bad[0, n - 1, 12] ^= 1
    bad[7, k, 70] ^= -(1 << 31)
    bad[5, 0, -1] ^= 0x100
    return bad.reshape(packed.shape)


@pytest.mark.parametrize("n,k,C,mb", [(8, 3, 12, 1), (8, 3, 12, 2),
                                      (8, 3, 12, 4), (8, 2, 12, 2),
                                      (7, 3, 14, 1), (7, 2, 14, 4)])
def test_direct_compare_and_count_model_is_the_plain_open(n, k, C, mb):
    """The direct open on the core, modelled (B = n*C = 96 or 98 lanes: a
    ragged 64-lane block; nv+1 = 6 or 7 columns, the last tile half empty
    at 7). Honest shares: the secrets equal _open_direct_plain's, nerr 0,
    no atomic. With _direct_faults the per-source counts equal the plain
    version's: source n-1 three (two lanes of one warp in one atomic, and
    the interpolating party's lane), source k two, every other validating
    source one; one atomic per warp, column and 64-lane block that saw a
    mismatch."""
    cols, points = _cols_of_shares(n, k, C, 31 * n + k)
    packed = cols.reshape(8, n, n * C)
    sec, nerr, atomics = _direct_model(packed, points, k, mb)
    want_sec, want_nerr = fod._open_direct_plain(packed, n, k, points)
    assert torch.equal(sec, want_sec) and torch.equal(nerr, want_nerr)
    assert not nerr.any() and atomics == 0
    bad = _direct_faults(packed, n, k)
    sec, nerr, atomics = _direct_model(bad, points, k, mb)
    want_sec, want_nerr = fod._open_direct_plain(bad, n, k, points)
    assert torch.equal(sec, want_sec) and torch.equal(nerr, want_nerr)
    assert nerr.tolist() == [0] * k + [2] + [1] * (n - k - 2) + [3]
    assert atomics == 2 + (n - k)


@pytest.mark.parametrize("n,k,C,mb", [(8, 3, 40, 1), (8, 3, 40, 2),
                                      (8, 4, 40, 4), (7, 3, 14, 2)])
def test_check_compare_and_count_model_is_the_plain_check(n, k, C, mb):
    """The per-column check on the core, modelled on check tensors whose
    every (column, slot) lane is a codeword over the n parties (320 lanes
    as 8 columns x 40 slots; 98 as 7 x 14: ragged 64-lane blocks; nv+1 = 5
    at k=4, the last tile half empty). Honest: vals equal
    _randousha_check_plain's, no error, no atomic. With _direct_faults the
    per-lane counts equal the plain version's: 1 at lanes 3, 12 and 70,
    n-k at the last lane."""
    cols, points = _cols_of_shares(n, k, C, 17 * n + k)
    chk = cols.reshape(8, n, n, C)
    vals, errs, atomics = _check_model(chk, points, k, mb)
    want_vals, want_errs = fr._randousha_check_plain(chk, k, points)
    assert torch.equal(vals, want_vals) and torch.equal(errs, want_errs)
    assert not errs.any() and atomics == 0
    bad = _direct_faults(chk, n, k)
    vals, errs, _ = _check_model(bad, points, k, mb)
    want_vals, want_errs = fr._randousha_check_plain(bad, k, points)
    assert torch.equal(vals, want_vals) and torch.equal(errs, want_errs)
    flat = errs.reshape(-1)
    assert {i: int(flat[i]) for i in flat.nonzero().reshape(-1).tolist()} \
        == {3: 1, 12: 1, 70: 1, n * C - 1: n - k}


# -- the direct open and the check against the reference (golden vectors) ---

DIRECT = (8, 2, 12)        # n, t, chunks: 96 opened shares


def _direct_input():
    n, t, c = DIRECT
    cols, points = _cols_of_shares(n, t + 1, c, 811)
    return cols.reshape(8, n, n * c), points


def _ref_direct_open():
    """The reference's detect-only direct open (its Pallas _direct_kernel
    in interpret mode, replicate=False) at n=8, t=2 over 96 shares, honest
    and with _direct_faults."""
    n, t, _ = DIRECT
    packed, points = _direct_input()
    out = {}
    for case, x in (("honest", packed),
                    ("faulted", _direct_faults(packed, n, t + 1))):
        sec, nerr = ref_direct(jnp.asarray(to_reference_packed(x)), n, t,
                               points, replicate=False)
        out[case + ".packed"] = to_reference_packed(x)
        out[case + ".sec"] = np.asarray(sec)
        out[case + ".nerr"] = np.asarray(nerr)
    return out


def _check_direct_vs_reference(ref, case, mb):
    n, t, _ = DIRECT
    packed, points = _direct_input()
    x = packed if case == "honest" else _direct_faults(packed, n, t + 1)
    assert np.array_equal(to_reference_packed(x), ref[case + ".packed"])
    sec, nerr, atomics = _direct_model(
        from_reference_packed(ref[case + ".packed"], "cpu"), points, t + 1,
        mb)
    assert np.array_equal(to_reference_packed(sec), ref[case + ".sec"])
    assert nerr.tolist() == ref[case + ".nerr"].tolist()
    assert (atomics == 0) == (case == "honest")


@pytest.mark.parametrize("case", ["honest", "faulted"])
@pytest.mark.parametrize("mb", [1, 2, 4])
def test_direct_model_is_the_reference_direct_open(case, mb):
    """The direct open on the core, modelled, against the reference's
    _direct_kernel (golden vectors, tests/_golden.py): secrets word for
    word and the per-source counts, honest and faulted."""
    _check_direct_vs_reference(golden("direct_open"), case, mb)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["honest", "faulted"])
def test_direct_model_is_the_reference_direct_open_live_reference(case):
    _check_direct_vs_reference(_ref_direct_open(), case, 2)


def _check_vs_reference(flat, deg, mb):
    chk = from_reference_check(flat[deg + ".chk"], CPU)
    k = GT + 1 if deg != "2t" else 2 * GT + 1
    vals, errs, _ = _check_model(chk, tuple(range(1, GN + 1)), k, mb)
    assert np.array_equal(to_reference_packed(vals), flat[deg + ".vals"])
    assert np.array_equal(errs.numpy(), flat[deg + ".errs"][0])
    assert bool(errs.any()) == (deg == "bad")


@pytest.mark.parametrize("deg,mb", [("t", 1), ("2t", 2), ("bad", 4)])
def test_check_model_is_the_reference_check(deg, mb):
    """The per-column check on the core, modelled on the reference's check
    tensors at n=8, t=2, 128 slots (1,024 lanes; golden vectors of
    tests/test_torch_randousha_per_column.py): vals and per-lane errs equal
    the reference's _kc_kernel at both degrees and with its flipped word."""
    _check_vs_reference(golden("per_column_stages"), deg, mb)


@pytest.mark.slow
@pytest.mark.parametrize("deg", ["t", "2t", "bad"])
def test_check_model_is_the_reference_check_live_reference(deg):
    from test_torch_randousha_per_column import _ref_stages
    _check_vs_reference(_ref_stages(), deg, 2)


GOLDEN = {"direct_open": _ref_direct_open}


def _extract_pc_model(cols, band, n_out, n_outp, ncheckp, mb):
    """hb_randousha_extract_pc as the kernel runs it: lane dst*sp + sl;
    column col stored to keep when col < n_outp and to chk at row
    col - n_out when n_out <= col < n; check rows ncheck..ncheckp-1 written
    zero by the threads of a lane between them. The outputs start as junk,
    so a row nobody writes shows."""
    _, n, _, sp = cols.shape
    ncheck = n - n_out
    mp = (n * sp, sp, n * n * sp, n * sp, 1, sp, n)
    flat = cols.reshape(-1).to(torch.int64) & M32
    ncp = band.shape[0] // 32
    words = _results(flat, mp, band.numpy(), ncp)
    keep = torch.full((8 * n * n_outp * sp,), JUNK, dtype=torch.int64)
    chk = torch.full((8 * n * ncheckp * sp,), JUNK, dtype=torch.int64)
    for lanes, tcols, part, parts in _owners(n * sp, n, mb):
        for g in lanes:
            if g >= n * sp:
                continue
            dst, sl = g // sp, g % sp
            kat = dst * n_outp * sp + sl
            cat = dst * ncheckp * sp + sl
            for col in tcols:
                if col < n_outp:
                    keep[[w * n * n_outp * sp + kat + col * sp
                          for w in range(8)]] = words[:, col, g]
                if n_out <= col < n:
                    chk[[w * n * ncheckp * sp + cat + (col - n_out) * sp
                         for w in range(8)]] = words[:, col, g]
            for r in range(ncheck + part, ncheckp, parts):
                chk[[w * n * ncheckp * sp + cat + r * sp
                     for w in range(8)]] = 0

    def out(x, rows):
        x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
        return x.reshape(8, n, rows, sp)

    return out(keep, n_outp), out(chk, ncheckp)


@pytest.mark.parametrize("n,t,mb", [(8, 2, 1), (16, 5, 2)])
def test_extract_pc_two_output_store_model_is_the_plain_extraction(n, t, mb):
    """The per-column extraction's two-output store on the core, modelled:
    at n=8, t=2 all 8 columns are keep columns, keep rows 4-7 are check
    columns 0-3 and check rows 4-7 are zero; at n=16, t=5 keep rows 6-7 are
    check columns 0-1 and check rows 10-15 zero. Equal to
    _randousha_extract_plain's keep and chk in every word."""
    sp = 128
    points = fr._party_points(n)
    n_out, n_outp = n - 2 * t, -(-(n - 2 * t) // 8) * 8
    ncheckp = -(-2 * t // 8) * 8
    cols = fr.randousha_deal((n, t), n, t, t, sp, points, "cpu")
    band = fr._encode_band_device(points, n, torch.device("cpu"))[0]
    keep, chk = _extract_pc_model(cols, band, n_out, n_outp, ncheckp, mb)
    want_keep, want_chk = fr._randousha_extract_plain(cols, band, n_out,
                                                      n_outp, ncheckp)
    assert torch.equal(keep, want_keep) and torch.equal(chk, want_chk)
    assert torch.equal(keep[:, :, n_out:], chk[:, :, :n_outp - n_out])
    assert not chk[:, :, 2 * t:].any()


# -- the deal (DrawSrc) and the aggregated extraction (ExtractAggEpi) --------

GN, GT, GSP, GKEY = 8, 2, 128, (5, 6)       # the golden stages' run
CPU = torch.device("cpu")


@pytest.mark.parametrize("n,kk", [(64, 22), (64, 43), (8, 3), (8, 5)])
def test_deal_tiles_walked_by_their_descriptor_are_the_encode_band(n, kk):
    """The deal's band (n columns, kk = t+1 or 2t+1 k-steps, a full last
    tile) read through the B descriptor is the reference's encode band."""
    points = fr._party_points(n)
    band, n1 = ref_fo._bands_np(points, kk)[0]
    _walk_tiles(fr._deal_band_tiles(points, kk), band[0], n1, kk, n)


def test_redc384_words_is_the_16_bit_redc():
    """The draw's 32-bit REDC (four 32-bit rounds, one 16-bit round) gives
    redc384's words: random 384-bit values and the edges (0, 2^384 - 1,
    multiples of p and of p * 2^144, one below and above them)."""
    rng = np.random.default_rng(2024)
    vals = [0, 1, (1 << 384) - 1, P, P - 1, P << 144, (P << 144) - 1,
            (P << 144) + 1, ((1 << 384) - 1) // P * P, P << 128,
            (2 * P) << 144, (1 << 255) << 128]
    vals += [int.from_bytes(rng.bytes(48), "little") for _ in range(500)]
    x = [torch.tensor([(v >> (32 * j)) & M32 for v in vals],
                      dtype=torch.int64) for j in range(12)]
    rows = []
    for w in x:
        rows += [w & 0xFFFF, w >> 16]
    want = fo._pack16(mont._redc384_rows(rows))
    assert torch.equal(bg._redc384_words(x), want)


@pytest.mark.parametrize("degree", [GT, 2 * GT])
@pytest.mark.parametrize("mb", [1, 2, 4])
def test_draw_src_planes_are_the_plain_deal_coefficients(degree, mb):
    """DrawSrc's plain twin (the drawn words of lane g = src*sp + slot,
    coefficient i) through the plane build: every block's planes, walked
    by the A descriptor, are the balanced digits of the plain deal's
    coefficients; lanes past the end (none here) would be zero."""
    rows = fr._deal_rows(GT, degree)
    kk, tm, lanes = len(rows), 64 * mb, GN * GSP
    words = fr._draw_words(GKEY, kk, rows[1], torch.arange(lanes))
    img = bg._gemm_planes(words, tm)
    limbs = fr._deal_coeff_limbs(GKEY, GN, GT, degree, GSP, 0, GSP, CPU)
    want = fo._planes_of(limbs).reshape(32, kk, lanes)
    for blk in range(lanes // tm):
        for i in range(kk):
            got = bg._desc_walk(img[blk], 2 * i * (tm // 8) * 128, 16 * tm,
                                128, tm).view(np.int8)
            assert np.array_equal(got.T, want[:, i, blk * tm:(blk + 1) * tm]
                                  .numpy()), (blk, i)


def _owned(nlanes, m, mb):
    """(lane, column) pairs of band_gemm_body<mb>'s consumer threads as
    numpy arrays (lanes < nlanes), and (lane, part, parts) of the finish
    calls; every pair and every part of a lane exactly once."""
    g, c, fin = [], [], []
    for lanes, cols, part, parts in _owners(nlanes, m, mb):
        for lane in lanes:
            if lane < nlanes:
                g += [lane] * len(cols)
                c += cols
                fin.append((lane, part, parts))
    assert len(set(zip(g, c))) == len(g)
    g, c = torch.tensor(g), torch.tensor(c)
    keep = c < m
    assert int(keep.sum()) == nlanes * m
    return g[keep], c[keep], fin


def _core_words(img, tiles, tm, k, m):
    """The core's dot as its descriptors walk it, then its fold: per block,
    tile and k-step, A (the planes; LBO 16 tm, SBO 128) times B^T (the band
    tile; LBO 1024, SBO 128), accumulator row r of tile ct being column
    2 ct + colt[r], diagonal diag[r]; then _fold_reduce_words. -> int64
    [PL, m, lanes] (uint32 values)."""
    colt, diag = bg._tile_rows()
    nblk, ntiles = img.shape[0], tiles.shape[0]
    d = np.zeros((32, 2 * ntiles, nblk * tm), np.int64)
    for blk in range(nblk):
        a = np.stack([bg._desc_walk(img[blk], 2 * kk * (tm // 8) * 128,
                                    16 * tm, 128, tm) for kk in range(k)])
        a = a.view(np.int8).astype(np.int64)            # [k, tm, 32]
        for ct in range(ntiles):
            b = np.stack([bg._desc_walk(tiles[ct, kk], 0, 1024, 128, 64)
                          for kk in range(k)]).astype(np.int64)
            acc = np.einsum("kls,krs->rl", a, b)         # [64 rows, tm]
            d[diag, 2 * ct + colt, blk * tm:(blk + 1) * tm] = acc
    fold = bg._word_fold_consts(fo._bal_fold_init(k), fo._bal_bias(k))
    words = bg._fold_reduce_words([torch.from_numpy(d[r, :m])
                                   for r in range(32)], fold)
    return words.to(torch.int64) & M32


def _signed(x, shape):
    x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    return x.reshape(shape)


def _deal_model(key, n, t, degree, sp, mb):
    """hb_randousha_deal as the kernel runs it: one group of B = n*sp
    lanes (lane g = src*sp + slot), DrawSrc's words, the planes and the dot
    on the deal's tiles, the fold, and StoreEpi's map: column col (the
    destination) of lane g at out[w*n*B + col*B + g]. The output starts as
    junk, so a word nobody writes shows."""
    rows = fr._deal_rows(t, degree)
    kk, B, tm = len(rows), n * sp, 64 * mb
    words = fr._draw_words(key, kk, rows[1], torch.arange(B))
    img = bg._gemm_planes(words, tm)
    res = _core_words(img, fr._deal_band_tiles(tuple(range(1, n + 1)), kk),
                      tm, kk, n)
    g, c, _ = _owned(B, n, mb)
    out = torch.full((8 * n * B,), JUNK, dtype=torch.int64)
    for w in range(8):
        out[w * n * B + c * B + g] = res[w, c, g]
    return _signed(out, (8, n, n, sp))


@pytest.fixture(scope="module")
def golden_stages():
    return golden("randousha_stages")


@pytest.mark.parametrize("deg", ["t", "2t"])
@pytest.mark.parametrize("mb", [1, 2, 4])
def test_deal_model_on_the_core_is_the_plain_deal_and_the_reference(
        golden_stages, deg, mb):
    """The deal on the core, modelled at n=8, t=2, 128 slots (1,024 lanes:
    16, 8 or 4 blocks): equal to _randousha_deal_plain and, permuted into
    the port's layout, to the reference's receive tensor at both degrees."""
    degree = GT if deg == "t" else 2 * GT
    got = _deal_model(GKEY, GN, GT, degree, GSP, mb)
    want = fr._randousha_deal_plain(GKEY, GN, GT, degree, GSP,
                                    tuple(range(1, GN + 1)), CPU)
    assert torch.equal(got, want)
    assert torch.equal(got, from_reference_receive(golden_stages["cols_" +
                                                                 deg], CPU))


def _extract_agg_model(cols, band, n_out, n_outp, mb):
    """hb_randousha_extract as the kernel runs it: lane dst*sp + sl, its n
    operands through the EncodeMap; m = n_out + 1 columns of the rho-folded
    band re-laid by _gemm_band_index (the last tile half empty when m is
    odd); column col < min(m, n_outp) to keep at row col, column n_out
    also to z; keep rows n_out+1 .. n_outp-1 written zero by the lane's
    threads in finish. The outputs start as junk."""
    _, n, _, sp = cols.shape
    m, B, tm = n_out + 1, n * sp, 64 * mb
    sw, C, ssp, sc, si = n * n * sp, sp, n * sp, 1, sp
    flat = cols.reshape(-1).to(torch.int64) & M32
    g = torch.arange(B)
    base = (g // C) * ssp + (g % C) * sc
    ops = torch.stack([torch.stack([flat[w * sw + base + i * si]
                                    for i in range(n)]) for w in range(8)])
    img = bg._gemm_planes(_signed(ops, ops.shape), tm)
    idx = bg._gemm_band_index(band.shape[0] // 32, n, m, band.shape[1])
    tiles = band.reshape(-1)[torch.from_numpy(idx)].numpy()
    res = _core_words(img, tiles, tm, n, m)
    gl, c, fin = _owned(B, m, mb)
    keep = torch.full((8 * n * n_outp * sp,), JUNK, dtype=torch.int64)
    z = torch.full((8 * n * sp,), JUNK, dtype=torch.int64)
    kat = (gl // sp) * n_outp * sp + gl % sp
    for w in range(8):
        sel = c < min(m, n_outp)
        keep[w * n * n_outp * sp + kat[sel] + c[sel] * sp] = \
            res[w, c[sel], gl[sel]]
        sel = c == n_out
        z[w * n * sp + (gl[sel] // sp) * sp + gl[sel] % sp] = \
            res[w, c[sel], gl[sel]]
    for lane, part, parts in fin:
        at = (lane // sp) * n_outp * sp + lane % sp
        for r in range(n_out + 1 + part, n_outp, parts):
            keep[[w * n * n_outp * sp + at + r * sp for w in range(8)]] = 0
    return _signed(keep, (8, n, n_outp, sp)), _signed(z, (8, n, sp))


@pytest.mark.parametrize("deg", ["t", "2t"])
@pytest.mark.parametrize("mb", [1, 2, 4])
def test_extract_agg_store_model_is_the_plain_extraction_and_reference(
        golden_stages, deg, mb):
    """The aggregated extraction on the core, modelled at n=8, t=2 on the
    reference's receive tensors and the run's rho-folded band: m = 5
    columns (three tiles, the last half empty), keep rows 5-7 zero rows
    of no column. Equal to _randousha_extract_plain in aggregate mode and
    to the reference's keep and z."""
    cols = from_reference_receive(golden_stages["cols_" + deg], CPU)
    run = fr._randousha_calls(GN, GT, GSP, tuple(range(1, GN + 1)),
                              device=CPU)
    n_out, n_outp = run.meta[:2]
    band = run.folded_band(GKEY)[0]
    keep, z = _extract_agg_model(cols, band, n_out, n_outp, mb)
    want_keep, want_z = fr._randousha_extract_plain(cols, band, n_out,
                                                    n_outp)
    assert torch.equal(keep, want_keep) and torch.equal(z, want_z)
    assert np.array_equal(to_reference_packed(keep),
                          golden_stages["keep_" + deg])
    assert np.array_equal(to_reference_packed(z), golden_stages["z_" + deg])
    assert torch.equal(keep[:, :, n_out], z) and not keep[:, :, n_out + 1:].any()


def test_extract_agg_store_model_at_an_even_column_count():
    """n=16, t=5: m = 7 columns (four tiles, the last half empty), one
    zero keep row (7); n = 16, t = 4: m = 9 (five tiles), no zero row
    (n_outp = 8 = n_out: column 8 goes to z alone). Equal to the plain
    aggregated extraction."""
    for n, t in ((16, 5), (16, 4)):
        points = tuple(range(1, n + 1))
        run = fr._randousha_calls(n, t, 128, points, device=CPU)
        n_out, n_outp = run.meta[:2]
        cols = fr.randousha_deal((n, t), n, t, t, 128, points, CPU)
        band = run.folded_band((n, t))[0]
        keep, z = _extract_agg_model(cols, band, n_out, n_outp, 2)
        want_keep, want_z = fr._randousha_extract_plain(cols, band, n_out,
                                                        n_outp)
        assert torch.equal(keep, want_keep) and torch.equal(z, want_z)


def test_deal_and_extract_plans():
    """The lane tiles the deal and the aggregated extraction launch at the
    main-path shapes (n=64, 4096 slots: 262,144 lanes on 132 SMs): 256
    lanes at k = 22, 128 at k = 43 (the 256-lane planes do not fit), 64 at
    k = n = 64. Few lanes take small tiles; every planned tile fits a
    block's shared memory."""
    lanes = 64 * 4096
    assert fr._deal_plan(22, lanes) == 4
    assert fr._deal_plan(43, lanes) == 2
    assert bg.smem_bytes(43, 4) > bg.SMEM_MAX >= bg.smem_bytes(43, 2)
    assert bg._gemm_plan(64, lanes) == 1
    assert bg.smem_bytes(64, 2) > bg.SMEM_MAX >= bg.smem_bytes(64, 1)
    assert fr._deal_plan(3, 1024) == bg._gemm_plan(8, 1024) == 1
