"""Port parity: the four routes of the GF(p) matmul (rows 12-15 of PERF.md's
kernel table) and fp_matmul's routing, against the JAX reference
on the CPU (its Pallas kernels in interpret mode; the jnp scan) and a
Python-int oracle. On the CPU every route takes its plain version; the
kernels are held against those on the card (chip_smoke.py). Inputs come
from a numpy seed; tolerance: exact equality of every limb.

Shapes are the reference's own fast tests' (tests/test_pallas_field.py),
so one persistent XLA cache serves both."""

import jax.numpy as jnp
import numpy as np
import pytest

from honeybadgermpc_tpu.ops import fpmatmul as ref_fpm
from honeybadgermpc_tpu.ops import mxu_matmul as ref_mxu
from honeybadgermpc_tpu.ops.pallas_field import \
    fp_matmul_pallas as ref_cios
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_limbs)
from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops import mxu_matmul as mxu
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.fpmatmul import _route, fp_matmul
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)


def _mat(seed, rows, cols):
    """np.uint32 Montgomery limbs [L, rows, cols] of uniform ints."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % P
            for _ in range(rows * cols)]
    return ints_to_limbs(np.array(vals, object).reshape(rows, cols))


def _oracle_rows(a, v, rows):
    """Python-int a @ v (Montgomery in, Montgomery out) at batch `rows`."""
    ai, vi = limbs_to_ints(a), limbs_to_ints(v)
    k, n = vi.shape
    return [[sum(int(ai[b][j]) * RINV * int(vi[j][c]) * RINV
                 for j in range(k)) % P * R_MOD_P % P for c in range(n)]
            for b in rows]


def _port(fn, a, v):
    return to_reference_limbs(fn(from_reference_limbs(a, "cpu"),
                                 from_reference_limbs(v, "cpu")))


FUSED2_CASES = [(256, 5, 7), (256, 22, 64), (130, 31, 8)]


def _fused2_inputs(B, k, n):
    return _mat(B + k, B, k), _mat(n, k, n)


def _ref_fused2_route():
    """The reference's fp_matmul_mxu2 (interpret mode) at FUSED2_CASES."""
    out = {}
    for B, k, n in FUSED2_CASES:
        a, v = _fused2_inputs(B, k, n)
        out[f"{B}_{k}_{n}"] = np.asarray(
            ref_mxu.fp_matmul_mxu2(jnp.asarray(a), jnp.asarray(v)))
    return out


def _check_fused2_route(want, B, k, n):
    a, v = _fused2_inputs(B, k, n)
    got = _port(mxu.fp_matmul_mxu2, a, v)
    assert np.array_equal(got, want)
    rows = [0, 1, B // 2, B - 1]
    assert limbs_to_ints(got[:, rows]).tolist() == _oracle_rows(a, v, rows)


@pytest.mark.parametrize("B,k,n", FUSED2_CASES)
def test_fused2_route_vs_reference_and_ints(B, k, n):
    """Row 13 (fp_matmul_mxu2, 1 REDC round at k <= 27, 2 above), against
    the reference's (golden vectors, tests/_golden.py) and Python ints."""
    _check_fused2_route(golden("fp_matmul_fused2_route")[f"{B}_{k}_{n}"],
                        B, k, n)


@pytest.mark.slow
@pytest.mark.parametrize("B,k,n", FUSED2_CASES)
def test_fused2_route_vs_reference_and_ints_live_reference(B, k, n):
    _check_fused2_route(_ref_fused2_route()[f"{B}_{k}_{n}"], B, k, n)


def test_unfused_route_vs_reference_and_ints():
    """Row 15 (fp_matmul_mxu: int8 dot of planes against the scaled band,
    then the 17-round REDC epilogue)."""
    B, k, n = 256, 9, 12
    a, v = _mat(1, B, k), _mat(2, k, n)
    got = _port(mxu.fp_matmul_mxu, a, v)
    want = np.asarray(ref_mxu.fp_matmul_mxu(jnp.asarray(a), jnp.asarray(v)))
    assert np.array_equal(got, want)
    rows = [0, 77, B - 1]
    assert limbs_to_ints(got[:, rows]).tolist() == _oracle_rows(a, v, rows)


def test_cios_route_vs_reference_scan_and_ints():
    """Row 12's plain version (the scan of mont_mul + add_mod) against the
    reference's jnp scan fpmatmul._matmul_kernel."""
    B, k, n = 13, 5, 7
    a, v = _mat(3, B, k), _mat(4, k, n)
    got = _port(fk.fp_matmul_pallas, a, v)
    want = np.asarray(ref_fpm._matmul_kernel(jnp.asarray(a), jnp.asarray(v)))
    assert np.array_equal(got, want)
    assert limbs_to_ints(got).tolist() == _oracle_rows(a, v, range(B))


@pytest.mark.slow
def test_cios_route_vs_reference_pallas_kernel():
    """Row 12 against the reference's fp_matmul_pallas itself (its
    interpret-mode compile is slow-tier in the reference too)."""
    B, k, n = 13, 5, 7
    a, v = _mat(5, B, k), _mat(6, k, n)
    got = _port(fk.fp_matmul_pallas, a, v)
    want = np.asarray(ref_cios(jnp.asarray(a), jnp.asarray(v)))
    assert np.array_equal(got, want)


def _reference_route(numel, k, n):
    """The reference's choice on the TPU (fpmatmul.py fp_matmul, then
    mxu_matmul.py fp_matmul_mxu), its jnp scan for < 1024 outputs named
    after the CIOS kernel that takes that branch in the port."""
    if numel * n < 1024:
        return "cios"
    int8_ok = numel >= 1024 and k * 37 * 127 * 127 < 2 ** 31
    if int8_ok and n >= 4 and ref_mxu.fused2_fits(k, n):
        return "mxu2"
    if int8_ok:
        return "mxu_fused" if ref_mxu.fused_fits(k, n) else "mxu"
    return "cios"


@pytest.mark.parametrize("numel,k,n", [
    (49152, 22, 43),     # batch open R1: decode_validate_matmul
    (49152, 22, 64),     # batch open R2
    (2048, 64, 64),      # Gao's interpolation from all 64 shares
    (4096, 64, 64),      # the in-call Gao fallback's segment
    (64, 22, 43),        # robust_open_single at n=64
    (64, 64, 64),        # its Gao interpolation
    (2048, 22, 1),       # lagrange_evaluate_at
    (21, 3, 7),          # the n=7 tests' shapes
    (256, 9, 12), (1030, 3, 2), (1024, 9, 12), (4096, 200, 4), (5000, 600, 4),
    # the edges of the row-13 and row-14 windows at a batch of 1024
    (1024, 91, 4), (1024, 92, 4), (1024, 438, 4), (1024, 439, 4),
    (1024, 858, 4), (1024, 859, 4), (1024, 312, 8), (1024, 313, 8),
    (1024, 422, 8), (1024, 423, 8), (1024, 195, 16), (1024, 196, 16),
    (1024, 204, 16), (1024, 205, 16), (1024, 151, 22), (1024, 152, 22),
    (1024, 108, 32), (1024, 109, 32), (1024, 80, 43), (1024, 81, 43),
    (1024, 52, 64), (1024, 53, 64), (1024, 3598, 4), (1024, 3599, 4),
    (1023, 439, 4), (1031, 204, 16),
])
def test_routing_matches_the_reference(numel, k, n):
    assert _route(numel, k, n) == _reference_route(numel, k, n)
    assert mxu.fused2_fits(k, n) == ref_mxu.fused2_fits(k, n)
    assert mxu.fused_fits(k, n) == ref_mxu.fused_fits(k, n)


def test_fp_matmul_takes_the_routes_on_arrays():
    """fp_matmul on FpArrays with extra batch axes: each route gives the
    oracle's words (the mxu2 and mxu routes at a batch of 1024)."""
    for (b0, b1), k, n in (((32, 32), 22, 8), ((32, 32), 3, 2),
                           ((3, 5), 4, 6)):
        a, v = _mat(b0 * k, b0 * b1, k), _mat(k * n, k, n)
        fa = FpArray(from_reference_limbs(a.reshape(16, b0, b1, k), "cpu"))
        out = fp_matmul(fa, FpArray(from_reference_limbs(v, "cpu")))
        assert out.shape == (b0, b1, n)
        got = to_reference_limbs(out.limbs).reshape(16, b0 * b1, n)
        rows = [0, b0 * b1 - 1]
        assert limbs_to_ints(got[:, rows]).tolist() == \
            _oracle_rows(a, v, rows)
    assert _route(1024, 22, 8) == "mxu2" and _route(1024, 3, 2) == "mxu"
    assert _route(15, 4, 6) == "cios"


def test_streamed_kernels_have_a_plan_for_every_routed_contraction():
    """Rows 13 and 14 run on the wgmma core with their digit planes in
    shared memory, resident up to k = 38 and streamed through two chunk
    buffers of 16 operands above: every k that the reference's predicates
    send to them (all k with fused2_fits, and the fused_fits windows
    beyond it) has a launch plan inside a Hopper block's 227 KB, with one
    tile per consumer warpgroup where the planes stream."""
    for n in (4, 8, 16, 22, 32, 43, 64):
        ks2 = [k for k in range(1, 3600) if mxu.fused2_fits(k, n)]
        ks1 = [k for k in range(1, 3600)
               if mxu.fused_fits(k, n) and not mxu.fused2_fits(k, n)]
        assert ks2 == list(range(1, max(ks2) + 1))
        assert max(ks2) == {4: 438, 8: 312, 16: 195, 22: 151, 32: 108,
                            43: 80, 64: 52}[n]
        for h, ks in ((2, ks2), (4, ks1)):
            tiles = -(-n // (4 // h))
            for k in ks:
                tgroups, nbuf, smem = mxu._mxu_plan(k, n, h)
                assert smem <= mxu.SMEM_MAX
                if k <= 38:
                    assert (tgroups, nbuf) == (1, -(-k // mxu.MXU_KC))
                else:
                    assert (tgroups, nbuf) == (-(-tiles // mxu.CONS), 2)
        assert (min(ks1, default=None), max(ks1, default=None)) == {
            4: (439, 858), 8: (313, 422), 16: (196, 204)}.get(n, (None, None))


def _ref_fused_route():
    """The reference's fp_matmul_mxu (interpret mode) at its fast-tier
    shape B=256, k=9, n=12."""
    a, v = _mat(7, 256, 9), _mat(8, 9, 12)
    return {"out": np.asarray(ref_mxu.fp_matmul_mxu(jnp.asarray(a),
                                                    jnp.asarray(v)))}


def _check_fused_route(ref):
    a, v = _mat(7, 256, 9), _mat(8, 9, 12)
    got = _port(mxu.fp_matmul_mxu_fused, a, v)
    assert np.array_equal(got, ref["out"])
    B, k, n = 1024, 439, 4
    assert _route(B, k, n) == "mxu_fused"
    a, v = _mat(9, B, k), _mat(10, k, n)
    out = fp_matmul(FpArray(from_reference_limbs(a, "cpu")),
                    FpArray(from_reference_limbs(v, "cpu")))
    got = to_reference_limbs(out.limbs)
    rows = [0, 511, B - 1]
    assert limbs_to_ints(got[:, rows]).tolist() == _oracle_rows(a, v, rows)


def test_fused_route_plain_vs_reference_and_ints():
    """Row 14's plain version (the 73 diagonals and the 17-round REDC) at
    the reference's fast-tier shape against its fp_matmul_mxu (interpret
    mode; golden vectors, tests/_golden.py), and at a routed shape
    (B=1024, k=439, n=4) through fp_matmul against Python ints on sampled
    rows."""
    _check_fused_route(golden("fp_matmul_mxu_fused_route"))


@pytest.mark.slow
def test_fused_route_plain_vs_reference_and_ints_live_reference():
    _check_fused_route(_ref_fused_route())


GOLDEN = {"fp_matmul_mxu_fused_route": _ref_fused_route}


WRAP_CASES = ((55, False), (256, True))


def _wrap_inputs(k):
    B, n = 2, 4
    a, v = _mat(11 + k, B, k), _mat(12 + k, k, n)
    return a, v, from_reference_limbs(a, "cpu"), from_reference_limbs(v, "cpu")


def _ref_wrap():
    """The reference's _redc_diagonals on the port's 73 diagonals of
    WRAP_CASES' products, and those diagonals."""
    out = {}
    for k, _ in WRAP_CASES:
        _, _, ta, tv = _wrap_inputs(k)
        d = mxu._mxu_diagonals(ta, tv).numpy()
        ref = ref_mxu._redc_diagonals([jnp.asarray(d[i]) for i in range(73)],
                                      (d.shape[1],))
        out[f"d_{k}"] = d
        out[f"ref_{k}"] = np.stack([np.asarray(x) for x in ref]).reshape(
            16, 2, 4)
    return out


def _check_wrap(ref):
    for k, wraps in WRAP_CASES:
        a, v, ta, tv = _wrap_inputs(k)
        want = _oracle_rows(a, v, range(2))
        for fn in (mxu.fp_matmul_mxu, mxu.fp_matmul_mxu2):
            got = to_reference_limbs(fn(ta, tv))
            assert limbs_to_ints(got).tolist() == want
        d = mxu._mxu_diagonals(ta, tv).numpy()
        assert np.array_equal(d, ref[f"d_{k}"])
        assert (limbs_to_ints(ref[f"ref_{k}"]).tolist() != want) == wraps
        assert (int(d.max()) >= 2 ** 25) == wraps
        assert mxu._pair_safe(k) == (k <= 55)


def test_epilogues_stay_exact_where_the_reference_wraps():
    """The reference folds diagonal pairs d_2i + (d_2i+1 << 7) in uint32,
    which wraps once a diagonal reaches 2^25 (here at k=256): its
    _redc_diagonals and _fold_reduce then return wrong words (golden
    vectors, tests/_golden.py). The port keeps the sum exact, so rows 13
    and 15 (and row 14, which shares the epilogue) give Python ints; at
    k=55 and below the reference does not wrap and the words are equal
    (ROADMAP Queue C)."""
    _check_wrap(golden("fp_matmul_wrap"))


@pytest.mark.slow
def test_epilogues_stay_exact_where_the_reference_wraps_live_reference():
    _check_wrap(_ref_wrap())


GOLDEN.update({"fp_matmul_fused2_route": _ref_fused2_route,
               "fp_matmul_wrap": _ref_wrap})
