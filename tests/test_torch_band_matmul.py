"""Port parity: the folded-band matmul. The port's plain version against
the reference's Pallas band kernel (interpret mode on the CPU) and against
a Python-int matmul. Same numpy-seeded inputs on both sides; tolerance:
exact equality of every limb."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.band_matmul import \
    band_matmul_limbs as ref_band_matmul_limbs
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import band_matmul as bm
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.fpmatmul import (_vandermonde_int_rows,
                                                   vandermonde_batch_evaluate)
from honeybadgermpc_tpu_torch.ops.fused_open import pack_limbs, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)
from honeybadgermpc_tpu_torch.ops.rs import Encoding

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401


def _rand_ints(seed, count):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(count)]


def _mont_limbs(vals, shape):
    """Python ints -> np.uint32 Montgomery limbs [L, *shape]."""
    return ints_to_limbs(np.array([v * R_MOD_P % P for v in vals],
                                  object).reshape(shape))


def _plain_ints(limbs_u32):
    rinv = pow(R_MOD_P, P - 2, P)
    return [int(v) * rinv % P for v in limbs_to_ints(limbs_u32).reshape(-1)]


def test_band_matmul_bit_exact_vs_pallas_interpret():
    B, k, n = 37, 3, 8
    vals = _rand_ints(1, B * k)
    a = _mont_limbs(vals, (B, k))
    mat_key = _vandermonde_int_rows(tuple(range(1, n + 1)), k)
    want = np.asarray(jax.device_get(
        ref_band_matmul_limbs(jnp.asarray(a), mat_key)))
    got = to_reference_limbs(bm.band_matmul_limbs(
        from_reference_limbs(a, "cpu"), mat_key))
    assert got.shape == want.shape == (16, B, n)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("B,k,m", [(5, 1, 1), (9, 4, 7), (3, 22, 64)])
def test_band_matmul_vs_python_ints(B, k, m):
    vals = _rand_ints(10 + k, B * k)
    mat = [_rand_ints(20 + i, m) for i in range(k)]
    if k == 4:                       # edge operands and entries
        vals[:4] = [0, 1, P - 1, P - 2]
        mat[0][:3] = [0, 1, P - 1]
    mat_key = tuple(tuple(r) for r in mat)
    a = from_reference_limbs(_mont_limbs(vals, (B, k)), "cpu")
    got = _plain_ints(to_reference_limbs(bm.band_matmul_limbs(a, mat_key)))
    want = [sum(vals[b * k + i] * mat[i][c] for i in range(k)) % P
            for b in range(B) for c in range(m)]
    assert got == want


def test_band_matmul_packed_checks_its_input():
    mat_key = _vandermonde_int_rows((1, 2, 3, 4), 2)
    good = pack_limbs(from_reference_limbs(
        _mont_limbs(_rand_ints(3, 6), (3, 2)), "cpu"))
    out = bm.band_matmul_packed(good, mat_key)
    assert tuple(out.shape) == (8, 3, 4) and out.dtype == torch.int32
    assert torch.equal(unpack_limbs(out),
                       bm.band_matmul_limbs(unpack_limbs(good), mat_key))
    with pytest.raises(ValueError):
        bm.band_matmul_packed(good.to(torch.int64), mat_key)
    with pytest.raises(ValueError):
        bm.band_matmul_packed(good[:, :, :1], mat_key)
    with pytest.raises(ValueError):
        bm.band_matmul_packed(good.transpose(1, 2).contiguous()
                              .transpose(1, 2), mat_key)
    assert bm.band_fits(64, 128) and not bm.band_fits(65, 8) \
        and not bm.band_fits(8, 129)


def test_vandermonde_evaluate_and_encoding_points():
    n, k, B = 7, 3, 4
    coeffs = _rand_ints(40, B * k)
    fa = FpArray.from_ints(np.array(coeffs, object).reshape(2, 2, k),
                           device="cpu")
    enc = Encoding(n)
    assert enc.points == list(range(1, n + 1))
    out = enc.encode(fa)
    assert out.shape == (2, 2, n)
    want = [sum(coeffs[b * k + i] * pow(x, i, P) for i in range(k)) % P
            for b in range(B) for x in enc.points]
    assert out.to_ints().reshape(-1).tolist() == want
    # 199 points are past the band (m <= 128): fp_matmul against the
    # Vandermonde matrix serves them
    wide = vandermonde_batch_evaluate(range(1, 200), fa.reshape(B, k))
    assert wide.shape == (B, 199)
    assert wide.to_ints().reshape(-1).tolist() == \
        [sum(coeffs[b * k + i] * pow(x, i, P) for i in range(k)) % P
         for b in range(B) for x in range(1, 200)]


def test_encoding_omega_points_match_reference():
    from honeybadgermpc_tpu.ops.rs import Encoding as RefEncoding
    for n in (4, 7):
        port, ref = Encoding(n, use_omega_powers=True), \
            RefEncoding(n, use_omega_powers=True)
        assert (port.order, port.omega, port.omega2) == \
            (ref.order, ref.omega, ref.omega2)
        assert port.points == [int(x) for x in ref.points]
    enc = Encoding(4, use_omega_powers=True)
    coeffs = _rand_ints(50, 6)
    out = enc.encode(FpArray.from_ints(
        np.array(coeffs, object).reshape(3, 2), device="cpu"))
    want = [(coeffs[2 * b] + coeffs[2 * b + 1] * x) % P
            for b in range(3) for x in enc.points]
    assert out.to_ints().reshape(-1).tolist() == want
