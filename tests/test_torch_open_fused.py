"""Port parity: the faithful three-kernel n-party open
(ops/fused_open.py::sim_open_fused_packed; on a card csrc/open_fused.cu).

The same numpy-seeded shares go through the reference's ``sim_open_fused``
(its three Pallas kernels in interpret mode on the CPU, as
tests/test_fused_open.py runs them, with the lax.cond Gao fallback when
robust) and the port's plain versions of K1-K3. Cases, at the reference
tests' own shapes so one compile serves both:

* (n=8, t=2) fault-free;
* (n=48, degree 35), the k > 32 case where the reference halves K3's
  destination group;
* (n=8, t=2) with party 3's shares replaced and robust=True: the
  mismatch sends the open to batch_reconstruct with its Gao fallback.

Tolerance: exact equality of every packed secret word and of the
per-destination error vector. Each stage's plain version is also held
against Python-int math on a few columns. The reference's results come
from committed golden vectors (tests/_golden.py); a slow twin computes
them live."""

import jax
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops.fused_open import sim_open_fused as ref_open
from honeybadgermpc_tpu_torch.interop import (from_reference_limbs,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops import fused_open as fo
from honeybadgermpc_tpu_torch.ops.fused_open import pack_limbs, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import (P, R_MOD_P, ints_to_limbs,
                                                limbs_to_ints)

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

RINV = pow(R_MOD_P, P - 2, P)
# (n, degree, faulty parties, robust): B = 2 (degree + 1), as the
# reference's tests/test_fused_open.py opens
CASES = {"faultfree_8_2": (8, 2, (), False),
         "wide_48_35": (48, 35, (), False),
         "robust_8_2": (8, 2, (3,), True)}


def _draw(rng):
    return int.from_bytes(rng.bytes(40), "little") % P


def _deal(seed, n, deg, B, bad=()):
    """B random secrets, degree-`deg` shares at points 1..n, the shares of
    the parties in `bad` replaced by other field elements -> (secrets,
    np.uint32 Montgomery limbs [L, n, B])."""
    rng = np.random.default_rng(seed)
    polys = [[_draw(rng) for _ in range(deg + 1)] for _ in range(B)]
    sh = [[_draw(rng) if j in bad else
           sum(c * pow(j + 1, i, P) for i, c in enumerate(f)) % P
           for f in polys] for j in range(n)]
    limbs = ints_to_limbs(np.array([[v * R_MOD_P % P for v in row]
                                    for row in sh], object))
    return [f[0] for f in polys], limbs


def _plain(packed_np):
    """np.uint32 packed [PL, ...] -> plain ints (out of Montgomery form)."""
    limbs = unpack_limbs(torch.from_numpy(
        np.ascontiguousarray(packed_np).view(np.int32)))
    return [int(v) * RINV % P
            for v in limbs_to_ints(limbs.numpy().view(np.uint32)).ravel()]


def _case(name):
    """(n, degree, robust, secrets, limbs) of case `name`."""
    seed = list(CASES).index(name)
    n, deg, bad, robust = CASES[name]
    secrets, limbs = _deal(700 + seed, n, deg, 2 * (deg + 1), bad)
    return n, deg, robust, secrets, limbs


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


def _ref_open(name):
    """The reference's three-kernel open of case `name`, jitted exactly as
    its own tests jit it."""
    n, deg, robust, _, limbs = _case(name)
    packed, nerr = jax.jit(
        lambda x: ref_open(x, n, deg, tuple(range(1, n + 1)),
                           robust=robust))(limbs)
    return {"sec": np.asarray(packed), "nerr": np.asarray(nerr)}


def _check_open(case, ref):
    n, deg, robust, secrets, limbs = case
    sec, nerr = fo.sim_open_fused(from_reference_limbs(limbs, "cpu"), n,
                                  deg, tuple(range(1, n + 1)), robust=robust)
    ref_sec, ref_nerr = ref["sec"], ref["nerr"]
    assert sec.dtype == torch.int32 and tuple(sec.shape) == ref_sec.shape
    assert np.array_equal(to_reference_packed(sec), ref_sec)
    assert nerr.dtype == torch.int32
    assert nerr.tolist() == ref_nerr.tolist()
    assert (sum(nerr.tolist()) > 0) == robust
    assert _plain(ref_sec[:, 0]) == secrets
    assert _plain(ref_sec[:, n - 1]) == secrets


@pytest.mark.parametrize("name", list(CASES))
def test_open_word_equal_to_the_reference(cases, name):
    _check_open(cases[name], golden(f"open_fused_{name}"))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CASES))
def test_open_vs_the_live_reference(cases, name):
    _check_open(cases[name], _ref_open(name))


GOLDEN = {f"open_fused_{name}": (lambda name=name: _ref_open(name))
          for name in CASES}


def test_open_calls_parts_compose_to_the_open(cases):
    """run.parts are K1-K3; chained they give the one-copy secrets and the
    destination-charged counts of sim_open_fused_packed."""
    n, deg, _, secrets, limbs = cases["faultfree_8_2"]
    k = deg + 1
    packed = pack_limbs(from_reference_limbs(limbs, "cpu"))
    C = packed.shape[-1] // k
    run = fo._open_calls(n, k, C, tuple(range(1, n + 1)))
    k1, k2, k3 = run.parts
    cols = k1(packed.reshape(8, n, k, C))
    vals, e1 = k2(cols)
    sec, e2 = k3(vals)
    assert tuple(cols.shape) == (8, n, n, C) and tuple(vals.shape) == (8, n, C)
    assert tuple(sec.shape) == (8, k, C) and e1.tolist() == [0] * n
    assert e2.tolist() == [0]
    one, nerr = run(packed)
    assert torch.equal(one, sec.reshape(8, k * C)) and nerr.tolist() == [0] * n
    assert _plain(to_reference_packed(one)) == secrets


def _ints(packed):
    """int32 packed [PL, ...] -> Montgomery-form ints, same shape."""
    return limbs_to_ints(unpack_limbs(packed).numpy().view(np.uint32))


def _lam(xs, x0):
    out = []
    for j, xj in enumerate(xs):
        num = den = 1
        for m, xm in enumerate(xs):
            if m != j:
                num, den = num * (x0 - xm) % P, den * (xj - xm) % P
        out.append(num * pow(den, P - 2, P) % P)
    return out


@pytest.mark.parametrize("n,k,C", [(8, 3, 5), (7, 3, 2), (16, 6, 3)])
def test_plain_stages_vs_python_ints(n, k, C):
    """K1 encodes, K2 interpolates at 0 and counts per destination, K3
    interpolates the coefficients and counts once — on random words and
    with one flipped column, checked in Python ints. Montgomery form is
    linear, so the plain-int constants apply to the words directly."""
    pts = tuple(range(1, n + 1))
    # party p's shares of k*C degree-(k-1) sharings, secret b = i*C + c at
    # view[:, p, i, c]: the encodings agree on every destination's column
    _, limbs = _deal(n * 100 + k, n, k - 1, k * C)
    coeffs = limbs_to_ints(limbs).reshape(n, k, C)
    view = pack_limbs(from_reference_limbs(limbs, "cpu")).reshape(8, n, k, C)
    cols = fo.open_k1(view, pts)
    ci = _ints(cols)                                     # [src, dst, C]
    for p, j, c in [(0, 0, 0), (n - 1, n - 1, C - 1), (n // 2, 1, C // 2)]:
        want = sum(int(coeffs[p, i, c]) * pow(pts[j], i, P)
                   for i in range(k)) % P
        assert ci[p, j, c] == want

    lam0 = _lam(pts[:k], 0)
    lamz = [_lam(pts[:k], x) for x in pts[k:]]
    bad = cols.clone()
    bad[5, n - 1, 2, C - 1] ^= 0x40            # dst 2's received column
    for x, flipped in ((cols, False), (bad, True)):
        vals, errs = fo.open_k2(x, pts, k)
        xi, vi = _ints(x), _ints(vals)                    # vi [n, C]
        want_errs = []
        for j in range(n):
            e = 0
            for c in range(C):
                ys = [int(xi[i, j, c]) for i in range(k)]
                assert vi[j, c] == sum(l * y for l, y in zip(lam0, ys)) % P
                e += sum((sum(l * y for l, y in zip(lz, ys)) % P)
                         != xi[k + z, j, c] for z, lz in enumerate(lamz))
            want_errs.append(e)
        assert errs.tolist() == want_errs
        assert (sum(want_errs) > 0) == flipped
        assert (want_errs[2] > 0) == flipped      # charged to the dst

    vals, _ = fo.open_k2(cols, pts, k)
    sec, errs = fo.open_k3(vals, pts, k)
    si, vi = _ints(sec), _ints(vals)                      # si [k, C]
    for c in range(C):
        for j in range(n):                   # the k coefficients re-encode
            assert sum(int(si[i, c]) * pow(pts[j], i, P)
                       for i in range(k)) % P == vi[j, c]
    assert errs.tolist() == [0]
    wrong = vals.clone()
    wrong[0, n - 1, 0] ^= 1
    _, errs = fo.open_k3(wrong, pts, k)
    assert errs.tolist() == [1]


def test_entry_checks_raise():
    pts = tuple(range(1, 9))
    good = torch.zeros((8, 8, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        fo.sim_open_fused_packed(good[:, :, :5], 8, 2, pts)     # 5 % 3
    with pytest.raises(ValueError):
        fo.sim_open_fused_packed(good.to(torch.int64), 8, 2, pts)
    with pytest.raises(ValueError):
        fo.sim_open_fused_packed(good[:, :7], 8, 2, pts)
    with pytest.raises(ValueError):
        fo._open_calls(8, 65, 1, pts)
    with pytest.raises(ValueError):
        fo.open_k1(good.reshape(8, 8, 3, 2)[:, :, :, :1], pts)  # strided
    sec, nerr = fo.sim_open_fused_packed(good, 8, 2, pts)
    assert sec.stride(1) == 0 and not bool(sec.any())   # one copy, broadcast
    assert nerr.tolist() == [0] * 8

