"""Port parity: the host bands and the per-run folded extraction band of the
fused RanDouSha pipeline (ops/fused_open.py::_bands_np, ops/
fused_randousha.py::_rho_plain, _bal_digits_device, folded_band) against
the JAX package on the CPU. Tolerance: exact equality of every byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fused_open as ref_fo
from honeybadgermpc_tpu.ops import fused_randousha as ref_fr
from honeybadgermpc_tpu_torch.interop import (from_reference_key,
                                              from_reference_limbs,
                                              to_reference_key,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import band_gemm as bg
from honeybadgermpc_tpu_torch.ops import fused_open as fo
from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
from honeybadgermpc_tpu_torch.ops.fpmatmul import _lagrange_int_rows
from honeybadgermpc_tpu_torch.ops.fused_open import NBAL, _bal_digits
from honeybadgermpc_tpu_torch.ops.limbs import (P, ints_to_limbs,
                                                limbs_to_ints)

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

N, T, K = 8, 2, 128
POINTS = tuple(range(1, N + 1))
KEYS = [(5, 6), (0xFFFFFFFF, 0x80000001)]
CPU = torch.device("cpu")


@pytest.mark.parametrize("k", [3, 5, 8])
def test_bands_np_byte_equal(k):
    got = fo._bands_np(POINTS, k)
    want = ref_fo._bands_np(POINTS, k)
    for i in range(3):
        assert got[i][1] == want[i][1]
        assert got[i][0].dtype == np.int8
        assert np.array_equal(got[i][0], want[i][0])
    assert got[3:] == want[3:]
    enc, n1 = fo._encode_band_np(POINTS, k)
    assert n1 == want[0][1] and np.array_equal(enc, want[0][0])


def test_lagrange_int_rows_interpolate():
    xs = (1, 2, 3, 5)
    rows = _lagrange_int_rows(xs)
    coeffs = [7, 11, 13, 17]
    ys = [sum(c * pow(x, i, P) for i, c in enumerate(coeffs)) % P
          for x in xs]
    back = [sum(ys[j] * rows[j][i] for j in range(4)) % P for i in range(4)]
    assert back == coeffs


@pytest.mark.parametrize("n,t", [(8, 2), (64, 21)])
def test_gemm_band_index_relays_the_rho_folded_band(n, t):
    """The aggregated extraction re-lays the run's rho-folded band (ncp2 =
    8 columns at n=8, 24 at n=64) on the device with one gather through
    _gemm_band_index into n_out + 1 columns of band_gemm tiles: the
    gather's tiles, read through the B descriptor, are that band (keep
    columns and the check column), the half of the last tile past column
    n_out zero; the index is a permutation of distinct band bytes."""
    run = fr._randousha_calls(n, t, 128, tuple(range(1, n + 1)), device=CPU)
    n_out = run.meta[0]
    band = run.folded_band((n, t))[0]
    ncp2, m = band.shape[0] // NBAL, n_out + 1
    assert ncp2 == -(-m // 8) * 8
    idx = bg._gemm_band_index(ncp2, n, m, band.shape[1])
    tiles = band.reshape(-1)[torch.from_numpy(idx)].numpy()
    assert np.array_equal(tiles, bg._gemm_band(band.numpy(), ncp2, n, m))
    assert len(np.unique(idx)) == idx.size
    colt, diag = bg._tile_rows()
    b = band.numpy()
    for ct in range(-(-m // 2)):
        cols = 2 * ct + colt
        for kk in range(n):
            got = bg._desc_walk(tiles[ct, kk], 0, 1024, 128, 64)
            want = b[diag * ncp2 + np.minimum(cols, ncp2 - 1), kk::n][:, :32]
            want = np.where((cols < m)[:, None], want, 0)
            assert np.array_equal(got, want), (ct, kk)


@pytest.mark.parametrize("key", KEYS)
def test_rho_plain_vs_reference(key):
    want = np.asarray(ref_fr._rho_plain(jnp.asarray(to_reference_key(key))))
    got = fr._rho_plain(key, CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, 64)
    assert np.array_equal(to_reference_limbs(got), want)
    assert all(int(v) < P for v in limbs_to_ints(want))
    assert from_reference_key(to_reference_key(key)) == key


def test_bal_digits_device_vs_reference_and_ints():
    rng = np.random.default_rng(3)
    vals = [0, 1, 127, 128, 255, 256, P - 1, P >> 1, 0x80 << 240] + \
        [int.from_bytes(rng.bytes(40), "little") % P for _ in range(23)]
    limbs = ints_to_limbs(np.array(vals, object).reshape(4, 8))
    want = np.asarray(ref_fr._bal_digits_device(jnp.asarray(limbs)))
    got = fr._bal_digits_device(from_reference_limbs(limbs, "cpu"))
    assert got.dtype == torch.int8 and tuple(got.shape) == (NBAL, 4, 8)
    assert np.array_equal(got.numpy(), want)
    flat = got.numpy().reshape(NBAL, -1)
    for i, v in enumerate(vals):
        assert flat[:, i].tolist() == _bal_digits(v)


@pytest.fixture(scope="module")
def ref_run():
    return ref_fr._randousha_calls(N, T, K, POINTS, aggregate=True)


@pytest.mark.parametrize("key", KEYS)
def test_folded_band_byte_equal(ref_run, key):
    want = np.asarray(ref_run.folded_band(
        jnp.asarray(to_reference_key(key))))
    run = fr._randousha_calls(N, T, K, POINTS, device=CPU)
    got = run.folded_band(key)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert run.meta == ref_run.meta
    # only the aggregated column depends on the key
    other = run.folded_band((key[0] ^ 1, key[1])).reshape(NBAL, -1, 32 * N)
    mine = got.reshape(NBAL, -1, 32 * N)
    n_out = run.meta[0]
    assert torch.equal(other[:, :n_out], mine[:, :n_out])
    assert not torch.equal(other[:, n_out], mine[:, n_out])
    assert not mine[:, n_out + 1:].any()


def test_folded_band_check_column_is_the_rho_combination(ref_run):
    """Python ints: the aggregated column holds the balanced digits of
    u_kk * 2^(8s+32), u_kk = sum_c rho_c * points[n_out+c]^kk (rho's limbs
    taken as the value itself)."""
    key = KEYS[0]
    run = fr._randousha_calls(N, T, K, POINTS, device=CPU)
    n_out, _, ncheck, _ = run.meta
    rho = [int(v) for v in limbs_to_ints(
        to_reference_limbs(fr._rho_plain(key, CPU)))[:ncheck]]
    band = run.folded_band(key).reshape(NBAL, -1, NBAL, N)   # r, col, s, kk
    for kk in (0, 1, N - 1):
        u = sum(r * pow(POINTS[n_out + c], kk, P)
                for c, r in enumerate(rho)) % P
        for s in (0, 5, NBAL - 1):
            want = _bal_digits(u * pow(2, 8 * s + 32, P) % P)
            assert band[:, n_out, s, kk].tolist() == want


def test_fused_fits_and_the_unported_mode():
    assert fr.fused_fits(64, 21) and fr.fused_fits(8, 2)
    assert not fr.fused_fits(7, 2) and not fr.fused_fits(128, 21)
    assert [fr.fused_fits(n, t) for n, t in ((64, 21), (8, 2), (7, 2))] == \
        [ref_fr.fused_fits(n, t) for n, t in ((64, 21), (8, 2), (7, 2))]
    assert fr._CTR_TAG == ref_fr._CTR_TAG and fr.TBW == ref_fr.TBW
    # the per-column mode builds: five stages, no folded band
    run = fr._randousha_calls(N, T, K, POINTS, aggregate=False, device=CPU)
    assert len(run.parts) == 5 and run.folded_band is None
    assert run.meta == fr._randousha_calls(N, T, K, POINTS,
                                           device=CPU).meta
