"""Port parity: the arithmetic and launch plans of rows 7 and 12 of PERF.md's
kernel table as the CUDA kernels run them, on the CPU.

Row 12 (csrc/fp_matmul_cios.cu) splits each output's contraction over
``field_kernels._cios_plan``'s lanes, sums each lane's products unreduced
in 30 column sums of 16 bits, folds them into words and reduces once per
run of ``CIOS_CHUNK`` terms, and adds the runs and the lanes mod p.
``field_kernels._cios_words_model`` is that arithmetic on int64 words; it is
held here against the reference's scan ``honeybadgermpc_tpu/ops/
fpmatmul.py::_matmul_kernel`` (golden vectors, tests/_golden.py; a slow
twin computes them live) and Python ints, at every split, with uniform
operands and with every operand at p - 1 (the largest wide sums). Row 7
(csrc/packed_arith.cu::mul_add_packed4_kernel) takes the party from the
grid's y index; its index map is modelled thread by thread against
``mul_add_packed4_flat``'s plain form. Inputs come from numpy seeds;
tolerance: exact equality of every limb and word."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fpmatmul as ref_fpm
from honeybadgermpc_tpu_torch.interop import from_reference_limbs
from honeybadgermpc_tpu_torch.ops import field_kernels as fk
from honeybadgermpc_tpu_torch.ops.fpmatmul import _route
from honeybadgermpc_tpu_torch.ops.fused_open import PL
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)
SPLITS = (1, 2, 4, 8, 16, 32)
# (B, k, n): one term; a contraction below and one above the largest split;
# robust_open_single's k = 22 and the degree-2t decode's 43; and k = 3599,
# the least contraction that fp_matmul routes to the CIOS kernel at every
# batch (every larger k goes there too; each lane's runs of 64 terms make
# the arithmetic repeat beyond it: 57 runs at split 1, 2 at split 32)
CIOS_CASES = [(3, 1, 5), (4, 5, 3), (5, 22, 7), (3, 43, 4), (1, 3599, 2)]
OPERANDS = ("uniform", "p-1")


def _mat(seed, rows, cols, operands):
    """np.uint32 Montgomery limbs [L, rows, cols]: uniform ints from a
    numpy seed, or p - 1 everywhere."""
    if operands == "p-1":
        vals = [P - 1] * (rows * cols)
    else:
        rng = np.random.default_rng(seed)
        vals = [int.from_bytes(rng.bytes(40), "little") % P
                for _ in range(rows * cols)]
    return ints_to_limbs(np.array(vals, object).reshape(rows, cols))


def _cios_inputs(B, k, n, operands):
    return _mat(B * 1000 + k, B, k, operands), _mat(n * 1000 + k, k, n,
                                                    operands)


def _ref_cios_split():
    """The reference's jnp scan at every case of CIOS_CASES."""
    out = {}
    for B, k, n in CIOS_CASES:
        for operands in OPERANDS:
            a, v = _cios_inputs(B, k, n, operands)
            out[f"{B}_{k}_{n}_{operands}"] = np.asarray(
                ref_fpm._matmul_kernel(jnp.asarray(a), jnp.asarray(v)))
    return out


GOLDEN = {"cios_split": _ref_cios_split}


def _check_cios_model(want, B, k, n, operands):
    a, v = _cios_inputs(B, k, n, operands)
    ai, vi = limbs_to_ints(a), limbs_to_ints(v)
    ints = [[sum(int(ai[b][j]) * int(vi[j][c]) for j in range(k)) * RINV % P
             for c in range(n)] for b in range(B)]
    assert limbs_to_ints(want).tolist() == ints
    ta, tv = from_reference_limbs(a, "cpu"), from_reference_limbs(v, "cpu")
    for split in SPLITS:
        got = fk._cios_words_model(ta, tv, split).numpy().view(np.uint32)
        assert np.array_equal(got, want), split


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("B,k,n", CIOS_CASES)
def test_cios_model_vs_reference_and_ints(B, k, n, operands):
    """Row 12's arithmetic at every split (each lane's unreduced wide sums,
    one reduction per run, the runs and the lanes added mod p) gives the
    reference's words and the Python-int product; the model asserts the
    bounds the kernel relies on (column sums below 2^57, the reduced sum
    below 32p, words 0-7 of the reduction zero, carry words below 2^32)."""
    _check_cios_model(golden("cios_split")[f"{B}_{k}_{n}_{operands}"],
                      B, k, n, operands)


@pytest.mark.slow
@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("B,k,n", CIOS_CASES)
def test_cios_model_vs_reference_and_ints_live_reference(B, k, n, operands):
    _check_cios_model(_ref_cios_split()[f"{B}_{k}_{n}_{operands}"],
                      B, k, n, operands)


def test_cios_run_length_keeps_five_subtracts():
    """A run of CIOS_CHUNK canonical terms keeps each 16-bit column below
    2^57 (at most 8 products below 2^48 per term) and sums below 2^516
    (16 words and the carry word at word 16), and its reduction
    V < T / 2^256 + p stays below 32p, so the subtracts of 16p, 8p, 4p,
    2p and p canonicalize it. Runs of up to 68 terms would keep that
    bound; 69 would need a sixth subtract."""
    t_max = fk.CIOS_CHUNK * (P - 1) ** 2
    assert fk.CIOS_CHUNK * 8 * (2 ** 16 - 1) * (2 ** 32 - 1) < 1 << 57
    assert t_max < 1 << 516
    assert t_max // 2 ** 256 + P < 32 * P
    assert 68 * (P - 1) ** 2 // 2 ** 256 + P < 32 * P
    assert 69 * (P - 1) ** 2 // 2 ** 256 + P >= 32 * P


def _cios_shapes():
    """(B, k, n) that fp_matmul routes to the CIOS kernel, over batches,
    contractions and widths on both sides of every routing and plan edge."""
    for B in (1, 2, 7, 63, 64, 100, 1000, 1023, 1024, 4096, 65536, 300000):
        for k in (0, 1, 2, 3, 5, 16, 21, 22, 23, 32, 43, 64, 65, 1000,
                  3598, 3599, 10000, 1 << 20):
            for n in (1, 2, 3, 4, 43, 64, 1000, 100000):
                if _route(B, k, n) == "cios" and B * n < 2 ** 31 - 128:
                    yield B, k, n


def test_cios_plan_covers_every_routed_shape():
    """Every shape routed to "cios" that fits a card has a split: a power
    of two from 1 to 32, at most k rounded up to a power of two, the least
    that reaches the fill target (CIOS_WARPS_PER_SM warps per SM), and a
    grid inside CUDA's limit."""
    target = fk.CIOS_WARPS_PER_SM * 32 * 132
    count = 0
    for B, k, n in _cios_shapes():
        count += 1
        split = fk._cios_plan(B, k, n, 132)
        assert split in SPLITS
        assert split == 1 or split < 2 * k
        if split > 1:
            assert B * n * split // 2 < target
        assert split == 32 or split >= k or B * n * split >= target
        assert -(-B * n * split // fk.CIOS_THREADS) < 2 ** 31
    assert count > 300
    assert fk._cios_plan(64, 22, 43, 132) == 8
    assert fk._cios_plan(1, 22, 43, 132) == 32
    assert (_route(1024, 3598, 4), _route(1024, 3599, 4)) == ("mxu", "cios")
    for B, k, n in ((0, 22, 43), (64, 22, 0), (2 ** 16, 3599, 2 ** 15)):
        with pytest.raises(ValueError):
            fk._cios_plan(B, k, n)


def _packed(rng, shape):
    """int32 packed words [PL, *shape] of uniform field elements."""
    vals = np.array([int.from_bytes(rng.bytes(40), "little") % P
                     for _ in range(int(np.prod(shape)))], object)
    limbs = ints_to_limbs(vals.reshape(shape))              # [L, *shape]
    words = limbs[0::2].astype(np.uint64) | (limbs[1::2].astype(np.uint64)
                                              << 16)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _mul_add4_index_map(n, rs, pad, threads=128):
    """csrc/packed_arith.cu::mul_add_packed4_kernel's index arithmetic for
    every thread of its grid (x: ceil(R*S / threads) blocks, y: n parties):
    -> (source offsets [PL, T] into the inputs' flat words, destination
    offsets [PL, T] into the flat output, live mask [T]), T threads in
    launch order (party, block, thread)."""
    m, stride = n * rs, rs + pad
    y, x, t = np.meshgrid(np.arange(n), np.arange(-(-rs // threads)),
                          np.arange(threads), indexing="ij")
    y, e = y.ravel(), (x * threads + t).ravel()
    live = e < rs                                # if (e >= RS) return;
    g = y * rs + e                               # blockIdx.y * RS + e
    row = y * stride + e                         # blockIdx.y * out_stride + e
    w = np.arange(PL)[:, None]
    return w * m + g, w * (n * stride) + row, live


@pytest.mark.parametrize("n,r,s,pad", [(3, 5, 77, 7), (3, 5, 77, 0),
                                       (1, 1, 1, 2), (2, 3, 129, 0),
                                       (5, 2, 65, 37)])
def test_mul_add_packed4_index_map(n, r, s, pad):
    """Row 7's grid (party from blockIdx.y, no division) writes every
    element of the flat [PL, n, R*S + pad] result once, leaves the pad
    columns to the wrapper's zeros, stores each warp's words at
    consecutive offsets, and gives mul_add_packed4_flat's plain words."""
    rng = np.random.default_rng(n * 100 + s + pad)
    a, b, c = (_packed(rng, (n, r, s)) for _ in range(3))
    src, dst, live = _mul_add4_index_map(n, r * s, pad)
    # a warp's live lanes store at consecutive offsets of every plane
    wd, wl = dst.reshape(PL, -1, 32), live.reshape(-1, 32)
    both = wl[:, 1:] & wl[:, :-1]
    assert np.all(np.diff(wd, axis=-1)[:, both] == 1)
    src, dst = src[:, live], dst[:, live]
    size = PL * n * (r * s + pad)
    assert len(np.unique(dst)) == dst.size and dst.max() < size
    flat = [x.reshape(-1).numpy() for x in (a, b, c)]
    gathered = [torch.from_numpy(f[src]) for f in flat]     # [PL, T] each
    res = fk._mul_add_packed_plain(*gathered).numpy()
    out = np.zeros(size, np.int32)
    out[dst] = res
    want = fk.mul_add_packed4_flat(a, b, c, pad=pad)
    assert np.array_equal(out.reshape(want.shape), want.numpy())
    assert not want[:, :, r * s:].any()
