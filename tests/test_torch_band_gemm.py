"""Port parity: the host side of the wgmma band-encode core
(honeybadgermpc_tpu_torch/ops/band_gemm.py, csrc/band_gemm.cuh) against the
JAX reference's folded band, balanced planes and fold. The kernel itself
runs only on the card (chip_smoke.py holds it against its plain version);
here its layouts are read back the way its shared-memory descriptors walk
them, its accumulator fragments are taken apart the way its epilogue takes
them, and its epilogue arithmetic is run by its plain twin. Tolerance:
exact equality everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fused_open as ref_fo
from honeybadgermpc_tpu_torch.ops import band_gemm as bg
from honeybadgermpc_tpu_torch.ops import fused_open as port_fo
from honeybadgermpc_tpu_torch.ops.limbs import P

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

TILE = bg.STEP_BYTES


def _rand_ints(seed, count):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(count)]


def _ref_band(ncp, k, seed):
    """The reference's folded band of a random [k][ncp] matrix."""
    mat = [_rand_ints(seed + i, ncp) for i in range(k)]
    return ref_fo._folded_band_host(mat, 2, ncp)


def _packed(seed, k, lanes):
    """Random packed words int32 [PL, k, lanes] of values < p."""
    vals = np.array(_rand_ints(seed, k * lanes), object).reshape(k, lanes)
    words = np.stack([(vals >> (32 * w)) & 0xFFFFFFFF for w in range(8)])
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _ref_planes(words):
    """The reference's balanced planes [NBAL*k, lanes] of packed words."""
    w = jnp.asarray(words.numpy().view(np.uint32))
    k = w.shape[1]
    return np.asarray(ref_fo._planes_of_packed(
        lambda i: w[i], k, 32 * k)).astype(np.int64)


@pytest.mark.parametrize("ncp,k", [(8, 3), (16, 5), (64, 22)])
def test_gemm_band_walked_by_its_descriptor_is_the_reference_band(ncp, k):
    """Tile (ct, kk) read through the B descriptor (LBO 1024, SBO 128) is
    64 rows x 32 digits; row n must be the reference band's row
    r * ncp + col, digits s at column s * k + kk, with (col, r) from
    _tile_rows. Every band byte of the m columns appears exactly once."""
    band = _ref_band(ncp, k, 3 * ncp + k)
    m = ncp - 1 if ncp > 8 else ncp             # an odd m where it can be
    tiles = bg._gemm_band(band, ncp, k, m)
    ntiles = -(-m // 2)
    assert tiles.dtype == np.int8 and tiles.shape == (ntiles, k, TILE)
    colt, diag = bg._tile_rows()
    assert sorted(zip(colt, diag)) == [(c, r) for c in range(2)
                                       for r in range(32)]
    seen = np.zeros((32 * ncp, 32 * k), np.int64)
    for ct in range(ntiles):
        for kk in range(k):
            tile = bg._desc_walk(tiles[ct, kk], 0, 1024, 128, 64)
            for n in range(64):
                col, r = 2 * ct + colt[n], diag[n]
                row = band[r * ncp + col, kk::k]        # s = 0..31
                assert np.array_equal(tile[n], row), (ct, kk, n)
                seen[r * ncp + col, kk::k] += 1
    used = (np.arange(32)[:, None] * ncp
            + np.arange(2 * ntiles)[None, :]).ravel()
    assert (seen[used] == 1).all()


@pytest.mark.parametrize("ncp,k", [(8, 3), (16, 5), (64, 22)])
def test_gemm_dot_through_the_fragments_is_the_reference_dot(ncp, k):
    """The GEMM the kernel runs: per k-step, A (the planes, walked by the A
    descriptor) times B^T (the band tile) into int32 accumulators, summed
    over k. Taken apart in wgmma's accumulator layout (thread tg of a quad,
    register 4i + 2h + e = row g + 8h, entry 8i + 2tg + e) the way the
    epilogue takes it (diagonal 2i + e of half tg & 1 of column tg >> 1)
    it must give the reference band's diagonals times the reference's
    planes: the product inside _band_dot_fold."""
    lanes, tm = 64, 64
    band = _ref_band(ncp, k, 7 * ncp + k)
    words = _packed(11 + k, k, lanes)
    want = band.astype(np.int64) @ _ref_planes(words)     # [r*ncp+col, l]
    want = want.reshape(32, ncp, lanes)
    tiles = bg._gemm_band(band, ncp, k, ncp)
    img = bg._gemm_planes(words, tm)[0]
    for ct in range(ncp // 2):
        acc = np.zeros((64, 64), np.int64)                 # [lane, n]
        for kk in range(k):
            a = bg._desc_walk(img, 2 * kk * (tm // 8) * 128, 16 * tm, 128,
                              64).view(np.int8).astype(np.int64)
            b = bg._desc_walk(tiles[ct, kk], 0, 1024, 128, 64).astype(
                np.int64)
            acc += a @ b.T
        for wl in range(4):
            for lane in range(32):
                g, tg = lane >> 2, lane & 3
                reg = np.zeros(32, np.int64)
                for i in range(8):
                    for h in range(2):
                        for e in range(2):
                            reg[4 * i + 2 * h + e] = \
                                acc[16 * wl + g + 8 * h, 8 * i + 2 * tg + e]
                col = 2 * ct + (tg >> 1)
                for h in range(2):
                    row = 16 * wl + g + 8 * h
                    for i in range(8):
                        for e in range(2):
                            r = 16 * (tg & 1) + 2 * i + e
                            assert reg[4 * i + 2 * h + e] == \
                                want[r, col, row], (ct, wl, lane, h, i, e)


@pytest.mark.parametrize("k,lanes,tm", [(3, 64, 64), (5, 70, 128),
                                        (22, 200, 256)])
def test_gemm_planes_walked_by_their_descriptor_are_the_reference_planes(
        k, lanes, tm):
    """The shared-memory planes the kernel builds (balance_word's carry
    chain over the 8 words of an operand, stored K-major), read through
    the A descriptor of each 64-lane block and k-step, are the reference's
    _planes_of_packed digits; lanes past the end are zero."""
    words = _packed(5 * k + lanes, k, lanes)
    ref = _ref_planes(words).reshape(32, k, lanes)        # [s, kk, lane]
    img = bg._gemm_planes(words, tm)
    nblk = -(-lanes // tm)
    assert img.shape == (nblk, k * 2 * tm * 16)
    for blk in range(nblk):
        for mb in range(tm // 64):
            for kk in range(k):
                start = (2 * kk * (tm // 8) + 8 * mb) * 128
                a = bg._desc_walk(img[blk], start, 16 * tm, 128, 64).view(
                    np.int8)
                l0 = blk * tm + 64 * mb
                n = max(0, min(64, lanes - l0))
                assert np.array_equal(a[:n].astype(np.int64),
                                      ref[:, kk, l0:l0 + n].T)
                assert not a[n:].any()


def _fold_ref(ds, k):
    """The reference's _fold_reduce_bal (JAX, uint32) -> packed words."""
    limbs = ref_fo._fold_reduce_bal(
        [jnp.asarray(d.numpy().astype(np.int32)) for d in ds],
        tuple(ds[0].shape), ref_fo._bal_fold_init(k), ref_fo._bal_bias(k))
    lim = np.stack([np.asarray(x).astype(np.int64) for x in limbs])
    return port_fo._pack16([torch.from_numpy(x) for x in lim])


@pytest.mark.parametrize("k", [1, 22, 43, 64])
def test_word_fold_is_the_16_bit_fold(k):
    """The core's epilogue (two 16-diagonal halves, one 32-bit Montgomery
    step; plain twin _fold_reduce_words) equals the port's and the
    reference's _fold_reduce_bal (19 carry-save limbs, two 16-bit REDC
    rounds) on random diagonals and at the extremes |d| = bias."""
    bias = port_fo._bal_bias(k)
    init = port_fo._bal_fold_init(k)
    fold = bg._word_fold_consts(init, bias)
    rng = np.random.default_rng(k)
    cols = [rng.integers(-bias, bias + 1, (32, 400)),
            np.full((32, 1), bias), np.full((32, 1), -bias),
            np.where(np.arange(32) % 2 == 0, bias, -bias)[:, None],
            np.where(np.arange(32) < 16, -bias, bias)[:, None],
            rng.choice([-bias, bias], (32, 64)), np.zeros((32, 1), int)]
    d = np.concatenate(cols, axis=1).astype(np.int64)
    ds = [torch.from_numpy(d[r]) for r in range(32)]
    got = bg._fold_reduce_words(ds, fold)
    want = port_fo._pack16(port_fo._fold_reduce_bal(ds, init, bias))
    assert torch.equal(got, want)
    assert torch.equal(got, _fold_ref(ds, k))


def test_fold_constants_and_plan():
    for k in (1, 22, 43, 64):
        fold = bg._word_fold_consts(port_fo._bal_fold_init(k),
                                    port_fo._bal_bias(k))
        assert len(fold) == bg.NW and all(0 <= w < 1 << 32 for w in fold)
        assert bg.smem_bytes(k, bg._gemm_plan(k, 1 << 20)) <= bg.SMEM_MAX
    assert bg.P32[0] == 1                     # -p^-1 mod 2^32 = 2^32 - 1
    assert sum(w << (32 * j) for j, w in enumerate(bg.P32)) == P
    # the main-path shapes: fill the card first, then the most lanes
    assert bg._gemm_plan(22, 16896) == 2      # 132 blocks of 128 lanes
    assert bg._gemm_plan(22, 262144) == 4
    assert bg._gemm_plan(43, 262144) == 2     # 256 lanes do not fit
    assert bg._gemm_plan(64, 262144) == 1
    assert bg._gemm_plan(22, 5) == 1
    with pytest.raises(ValueError):
        bg._gemm_plan(128, 64)
