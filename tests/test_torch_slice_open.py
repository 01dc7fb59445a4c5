"""Port parity for the ported path as a whole, on the CPU: deal -> pack -> open.

* A pool saved by the reference's ``PreProcessedElements.save`` is loaded
  by the port and opened; the opened secrets equal the reference's own
  opened secrets (its direct-open kernel in interpret mode), word for word.
* The port's own deal -> pack -> open round trip equals the Python-int
  Lagrange oracle.
* Import hygiene: the port imports neither jax nor the JAX package.

Tolerance everywhere: exact equality."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
from honeybadgermpc_tpu.ops.fused_open import pack_limbs as ref_pack_limbs
from honeybadgermpc_tpu.ops.fused_open_direct import \
    sim_open_direct_packed as ref_open
from honeybadgermpc_tpu.runtime.preprocessing import \
    PreProcessedElements as RefPre
from honeybadgermpc_tpu_torch.interop import (to_reference_limbs,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops.fused_open import (_lam_int, pack_limbs,
                                                     unpack_limbs)
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)
from honeybadgermpc_tpu_torch.parallel.reconstruct import \
    _sim_reconstruct_packed_jit
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements

N, T, B = 8, 2, 9
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _mont_ints(limbs_i32):
    rinv = pow(R_MOD_P, P - 2, P)
    ints = limbs_to_ints(limbs_i32.cpu().numpy().view(np.uint32))
    return np.vectorize(lambda v: int(v) * rinv % P, otypes=[object])(ints)


def _lagrange_at_zero(share_ints, parties):
    """Python-int oracle: interpolate at 0 from the given parties' shares
    (share_ints [n, B], party j sits at point j+1)."""
    lam = _lam_int([j + 1 for j in parties], 0)
    return [sum(l * int(share_ints[j, b]) for l, j in zip(lam, parties)) % P
            for b in range(share_ints.shape[1])]


def test_reference_pool_opened_by_port(tmp_path):
    rng = np.random.default_rng(2024)
    draw = lambda: int.from_bytes(rng.bytes(40), "little") % P  # noqa: E731
    coeffs = [[draw() for _ in range(T + 1)] for _ in range(B + 3)]
    shares = [[sum(c * pow(x, i, P) for i, c in enumerate(cs)) % P
               * R_MOD_P % P for cs in coeffs] for x in range(1, N + 1)]
    limbs = ints_to_limbs(np.array(shares, object))[..., None]  # [L,n,B+3,1]

    ref = RefPre(N, T, seed=0)
    ref._pool("rands").put(RefFpArray(jnp.asarray(limbs)))
    ref.get_rands(3)                       # consume: the saved pool is cut
    ref.save(str(tmp_path))

    port = PreProcessedElements(N, T, seed=5, device="cpu")
    port.load(str(tmp_path))
    assert port._pool("rands").remaining() == B
    got = port.get_rands(B)                                     # [n, B]
    assert np.array_equal(to_reference_limbs(got.limbs), limbs[:, :, 3:, 0])

    ref2 = RefPre(N, T, seed=0)
    ref2.load(str(tmp_path))
    ref_packed = ref_pack_limbs(ref2.get_rands(B).limbs)
    packed = pack_limbs(got.limbs)
    assert np.array_equal(to_reference_packed(packed), np.asarray(ref_packed))

    run = _sim_reconstruct_packed_jit(N, T, False, True, fallback=False,
                                      replicate=False)
    sec, nerr = run(packed)
    points = tuple(range(1, N + 1))
    sec_ref, nerr_ref = ref_open(ref_packed, N, T, points, replicate=False)
    assert np.array_equal(to_reference_packed(sec), np.asarray(sec_ref))
    assert nerr.tolist() == np.asarray(nerr_ref).tolist() == [0] * N
    assert _mont_ints(unpack_limbs(sec)).tolist() == \
        [cs[0] for cs in coeffs[3:]]


def test_port_pool_saved_and_loaded_by_reference(tmp_path):
    port = PreProcessedElements(N, T, seed=1, device="cpu")
    port.generate_rands(B)
    port.save(str(tmp_path))
    ref = RefPre(N, T, seed=0)
    ref.load(str(tmp_path))
    want = port.get_rands(B)
    got = np.asarray(ref.get_rands(B).limbs)
    assert got.dtype == np.uint32
    assert np.array_equal(got, to_reference_limbs(want.limbs))


@pytest.mark.parametrize("n,t,count", [(8, 2, 12), (7, 2, 9)])
def test_port_deal_pack_open_roundtrip(n, t, count):
    pre = PreProcessedElements(n, t, seed=0, device="cpu")
    pre.generate_rands(count)
    pre.generate_rands(count, key_data=(7, 9))
    shares = pre.get_rands(2 * count)          # spans both segments
    assert shares.shape == (n, 2 * count)
    ints = _mont_ints(shares.limbs)
    want = _lagrange_at_zero(ints, list(range(t + 1)))
    # independent of the opened parties: any other t+1 parties agree
    assert _lagrange_at_zero(ints, list(range(n - t - 1, n))) == want
    assert len(set(want)) == 2 * count

    packed = pack_limbs(shares.limbs)
    run = _sim_reconstruct_packed_jit(n, t, False, True, fallback=False,
                                      replicate=False)
    sec, nerr = run(packed)
    assert nerr.tolist() == [0] * n
    assert _mont_ints(unpack_limbs(sec)).tolist() == want
    # explicit key data reproduces the same deal
    again = PreProcessedElements(n, t, seed=3, device="cpu")
    again.generate_rands(count, key_data=(7, 9))
    assert torch.equal(again.get_rands(count).limbs,
                       shares.limbs[:, :, count:])


def test_port_dealer_is_seeded_and_pool_is_consumed():
    a = PreProcessedElements(N, T, seed=4, device="cpu")
    b = PreProcessedElements(N, T, seed=4, device="cpu")
    c = PreProcessedElements(N, T, seed=5, device="cpu")
    for pre in (a, b, c):
        pre.generate_rands(6)
    x, y, z = a.get_rands(4), b.get_rands(4), c.get_rands(4)
    assert torch.equal(x.limbs, y.limbs) and not torch.equal(x.limbs, z.limbs)
    assert a._pool("rands").remaining() == 2
    with pytest.raises(ValueError):
        a.get_rands(3)


def test_port_state_survives_save_and_load(tmp_path):
    pre = PreProcessedElements(N, T, seed=2, device="cpu")
    pre.generate_rands(12)
    pre.get_rands(3)
    pre.save(str(tmp_path))
    fresh = PreProcessedElements(N, T, seed=9, device="cpu")
    fresh.load(str(tmp_path))
    assert fresh._pool("rands").remaining() == 9
    assert torch.equal(fresh.get_rands(9).limbs, pre.get_rands(9).limbs)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, found by walking the package, imports in a
    fresh interpreter without jax, jaxlib or honeybadgermpc_tpu."""
    code = ("import sys, pkgutil, importlib\n"
            "before = set(sys.modules)\n"
            "import honeybadgermpc_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "want = {'ntl', 'ops.ntt', 'field', 'polynomial', "
            "'elliptic_curve', 'ops.welch_berlekamp', 'runtime.refinement',"
            " 'ops.mxu_matmul', 'parallel.reconstruct', 'runtime.offline'}\n"
            "missing = {pkg.__name__ + '.' + w for w in want} - set(names)\n"
            "assert not missing, missing\n"
            "bad = [m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or "
            "m.split('.')[0] == 'honeybadgermpc_tpu']\n"
            "assert not bad, bad\n"
            "assert 'torch' in sys.modules\n"
            "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 25


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {nm.split(".")[0] for nm in names}
    assert "torch" in roots and "honeybadgermpc_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "honeybadgermpc_tpu"}
