"""Port parity: the kernels on the wgmma band core that bring their own
epilogue policy (csrc/band_gemm.cuh): K2 of the three-kernel open
(csrc/open_fused.cu, K2Epi) and the per-column extraction
(csrc/randousha_extract.cu, ExtractPcEpi). The kernels run only on the
card (chip_smoke.py holds them against their plain versions there); here
their host layouts are held against the reference's bands, and a plain
model of what their epilogues do (the lane maps of their C entries, the
core's split of (lane, column) pairs over consumer threads, the policy's
store, compare and count) is held against the port's plain versions.
Tolerance: exact equality everywhere."""

import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fused_open as ref_fo
from honeybadgermpc_tpu_torch.ops import band_gemm as bg
from honeybadgermpc_tpu_torch.ops import fused_open as fo
from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
from honeybadgermpc_tpu_torch.ops.limbs import P

TILE = bg.STEP_BYTES
M32 = 0xFFFFFFFF
JUNK = 0x5A5A5A5A          # what an output holds before the kernel writes


def _walk_tiles(tiles, band, ncp, k, m):
    """Every tile of `tiles`, read through the kernel's B descriptor, is
    the reference band's rows (diagonal r of column col, digits s at
    column s*k + kk); columns m.. of an odd last tile are zero."""
    colt, diag = bg._tile_rows()
    ntiles = -(-m // 2)
    assert tiles.shape == (ntiles, k, TILE)
    for ct in range(ntiles):
        cols = 2 * ct + colt
        want_rows = diag * ncp + cols
        for kk in range(k):
            got = bg._desc_walk(tiles[ct, kk], 0, 1024, 128, 64)
            assert np.array_equal(got, band[want_rows, kk::k][:, :32]), \
                (ct, kk)
            assert not got[cols >= m].any()


@pytest.mark.parametrize("k", [22, 43])
def test_k2_tiles_walked_by_their_descriptor_are_the_reference_band(k):
    """K2's band at n=64 in band_gemm tiles (nv+1 = 43 columns at k=22: a
    half-empty last tile; 22 at k=43) is the reference's R1 band; the
    per-column check keeps K2's fragment layout beside it."""
    n = 64
    points = tuple(range(1, n + 1))
    band, ncp = ref_fo._bands_np(points, k)[1]
    frag, tiles = fo._open_kernel_bands(points, k)[1]
    _walk_tiles(tiles, band[0], ncp, k, n - k + 1)
    assert np.array_equal(
        frag, fo._kernel_band(band[0], ncp, k)[:n - k + 1])
    enc, n1 = ref_fo._bands_np(points, k)[0]
    _walk_tiles(fo._open_kernel_bands(points, k)[0][1], enc[0], n1, k, n)


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

def _owners(nlanes, m, mb):
    """The consumer threads of band_gemm_body<mb> as it splits the work:
    per thread (its lanes, one per 64-lane block; the columns of its tiles;
    its part among the threads of its lanes; their count)."""
    tm, cons = 64 * mb, bg.consumers(mb)
    ntiles = -(-m // 2)
    for blk in range(-(-nlanes // tm)):
        for wgi in range(cons):
            for wl in range(4):
                for laneid in range(32):
                    g, tg = laneid >> 2, laneid & 3
                    hf, cl = tg & 1, tg >> 1
                    lanes = [blk * tm + 64 * b + 16 * wl + g + 8 * hf
                             for b in range(mb)]
                    cols = [2 * ct + cl for ct in range(wgi, ntiles, cons)]
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


def _k2_model(cols, points, k, mb):
    """hb_open_fused_k2 as the kernel runs it: lane j*C + c; columns
    0..nv-1 compared with the received words fetched at operand k + col,
    counted per thread and lane and added to errs[lane // C] when not 0;
    column nv stored to vals at the lane; column nv+1 nothing."""
    _, n, _, C = cols.shape
    nv = n - k
    mp = (n * C, C, n * n * C, C, 1, n * C, k)
    flat = cols.reshape(-1).to(torch.int64) & M32
    band, ncp = fo._bands_np(points, k)[1]
    words = _results(flat, mp, band[0], ncp)
    vals = torch.full((8 * n * C,), JUNK, dtype=torch.int64)
    errs = torch.zeros(n, dtype=torch.int64)
    for lanes, tcols, _, _ in _owners(n * C, nv + 1, mb):
        for g in lanes:
            if g >= n * C:
                continue
            at = (g // C) * C + g % C
            bad = 0
            for col in tcols:
                if col < nv:
                    recv = flat[[w * n * n * C + at + (k + col) * n * C
                                 for w in range(8)]]
                    bad += int((words[:, col, g] != recv).any())
                elif col == nv:
                    vals[[w * n * C + g for w in range(8)]] = words[:, col, g]
            if bad:
                errs[g // C] += bad
    vals = torch.where(vals >= 1 << 31, vals - (1 << 32), vals)
    return vals.to(torch.int32).reshape(8, n, C), errs.to(torch.int32)


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
