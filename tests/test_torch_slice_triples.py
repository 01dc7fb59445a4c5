"""Port parity for the offline slice as a whole, on the CPU: verified Beaver
triples through ``sim_offline_jit("generate_triples_packed", 8, 2, 128)``.

The reference side is ``runtime/offline.py::fused_generate_triples(packed=
True)`` of the JAX package, run stage by stage on the key data of its own
``jax.random.split(key, 3)``: RanSha for a and b, RanDouSha for r (Pallas
kernels in interpret mode), the degree-2t direct open (interpret mode), and
its two packed finish kernels through their plain versions in ops/
montgomery.py (the interpret-mode compile of those two takes ten minutes
or more each on a CPU; the reference's own tests keep them in the slow
tier). ``_ref_triples`` mirrors lines 259-301 of the reference's
``runtime/offline.py`` statement for statement: the key split (:259), the
three dealings (:266-269), the 2t opener (:271), ``z = a*b + r_2t`` (:288),
the flatten and zero pad to a multiple of 2t+1 (:289-294), the open (:295),
``ok`` (:298) and ``ab = open(z) - r_t`` (:299-300). One slow-tier test calls
that function itself, Pallas finish kernels included. The port gets the
same three key pairs. Tolerance: exact equality of every word of pa,
pb, pab and of ok; the opened triples satisfy ab == a*b mod p in Python
ints. In the fast tier the reference's results are committed golden
vectors (tests/_golden.py); a slow twin computes them live."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honeybadgermpc_tpu.ops import fused_randousha as ref_fr
from honeybadgermpc_tpu.ops import montgomery as ref_mont
from honeybadgermpc_tpu.ops.fused_open import pack_limbs as ref_pack
from honeybadgermpc_tpu.ops.fused_open import unpack_limbs as ref_unpack
from honeybadgermpc_tpu.parallel.reconstruct import \
    _sim_reconstruct_packed_jit as ref_reconstruct
from honeybadgermpc_tpu.runtime.offline import _key_data as ref_key_data
from honeybadgermpc_tpu_torch.interop import (from_reference_key,
                                              to_reference_packed)
from honeybadgermpc_tpu_torch.ops.field_kernels import split_key
from honeybadgermpc_tpu_torch.ops.fused_open import _lam_int, unpack_limbs
from honeybadgermpc_tpu_torch.ops.limbs import P, R_MOD_P, limbs_to_ints
from honeybadgermpc_tpu_torch.parallel.mesh import SimBackend
from honeybadgermpc_tpu_torch.parallel.reconstruct import \
    _sim_reconstruct_packed_jit
from honeybadgermpc_tpu_torch.runtime import offline

from _golden import golden
from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401

N, T, K = 8, 2, 128
N_OUT, N_OUTP = N - 2 * T, 8
CNTP = N_OUTP * K


def _live_subkeys():
    parts = jax.random.split(jax.random.PRNGKey(3), 3)
    return [np.asarray(ref_key_data(k)) for k in parts]


@pytest.fixture(scope="module")
def subkeys():
    """The key data of the reference's jax.random.split(PRNGKey(3), 3), as
    the golden vectors store them (the live twins hold them equal to a live
    split)."""
    return list(golden("triples")["subkeys"])


def _ref_triples(subkeys=None):
    """The reference's fused_generate_triples(packed=True), stage by stage
    on the key data of its own split of PRNGKey(3) (see the module
    docstring)."""
    if subkeys is None:
        subkeys = _live_subkeys()
    ka, kb, kr = (jnp.asarray(k) for k in subkeys)
    pa, oka = ref_fr.sim_ransha_fused(ka, N, T, K, padded=True)
    pb, okb = ref_fr.sim_ransha_fused(kb, N, T, K, padded=True)
    prt, pr2t, okr = ref_fr.sim_randousha_fused(kr, N, T, K, padded=True)
    z = ref_pack(ref_mont.add_mod(
        ref_mont.mont_mul(ref_unpack(pa), ref_unpack(pb)),
        ref_unpack(pr2t)))
    k2 = 2 * T + 1
    pad = (-CNTP) % k2
    zf = jnp.concatenate([z.reshape(8, N, CNTP),
                          jnp.zeros((8, N, pad), jnp.uint32)], axis=-1)
    run = ref_reconstruct(N, 2 * T, False, True, fallback=False,
                          replicate=False)
    opened, nerr = run(zf)
    ok = oka & okb & okr & (jnp.sum(nerr) == 0)
    minuend = ref_unpack(opened[:, :CNTP].reshape(8, N_OUTP, K))
    pab = ref_pack(ref_mont.sub_mod(minuend[:, None], ref_unpack(prt)))
    return {"pa": np.asarray(pa), "pb": np.asarray(pb),
            "pab": np.asarray(pab), "ok": np.asarray(bool(ok)),
            "subkeys": np.stack(subkeys)}


def _as_tuple(ref, subkeys):
    assert np.array_equal(ref["subkeys"], np.stack(subkeys))
    return ref["pa"], ref["pb"], ref["pab"], bool(ref["ok"])


@pytest.fixture(scope="module")
def reference(subkeys):
    return _as_tuple(golden("triples"), subkeys)


@pytest.fixture(scope="module")
def live_reference(subkeys):
    live = _live_subkeys()
    assert np.array_equal(np.stack(live), np.stack(subkeys))
    return _as_tuple(_ref_triples(live), live)


GOLDEN = {"triples": _ref_triples}


@pytest.fixture(scope="module")
def port(subkeys):
    fn = offline.sim_offline_jit("generate_triples_packed", N, T, K,
                                 device="cpu")
    return fn(subkeys=tuple(from_reference_key(k) for k in subkeys))


def _check_triples(reference, port, which):
    got = port[which]
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, N, N_OUTP, K)
    assert np.array_equal(to_reference_packed(got), reference[which])


@pytest.mark.parametrize("which", [0, 1, 2], ids=["pa", "pb", "pab"])
def test_triples_word_equal_to_the_reference(reference, port, which):
    _check_triples(reference, port, which)


@pytest.mark.slow
@pytest.mark.parametrize("which", [0, 1, 2], ids=["pa", "pb", "pab"])
def test_triples_vs_the_live_reference(live_reference, port, which):
    _check_triples(live_reference, port, which)


def test_triples_ok_flag(reference, port):
    ok = port[3]
    assert ok.dtype == torch.bool and ok.dim() == 0
    assert bool(ok) is reference[3] is True


@pytest.mark.slow
def test_triples_word_equal_to_the_reference_entry_point(reference, port):
    """SLOW tier: the reference's fused_generate_triples(packed=True)
    itself, its two Pallas finish kernels in interpret mode (ten minutes or
    more of compile each on a CPU, cached thereafter): word-equal to the
    stage-by-stage reference above and to the port."""
    from honeybadgermpc_tpu.parallel.mesh import SimBackend as RefSimBackend
    from honeybadgermpc_tpu.runtime.offline import \
        fused_generate_triples as ref_generate
    out = ref_generate(RefSimBackend(N), N, T, K, jax.random.PRNGKey(3),
                       packed=True)
    assert bool(out[3]) is reference[3] is bool(port[3]) is True
    for which in range(3):
        ref = np.asarray(out[which])
        assert np.array_equal(ref, reference[which])
        assert np.array_equal(to_reference_packed(port[which]), ref)


def _open_ints(p4):
    """Open a packed 4D tensor at degree t with the port's direct open ->
    plain residues [R, S] as Python ints, after checking nerr == 0 and the
    secrets against Python-int Lagrange from the LAST t+1 parties."""
    _, n, r, s = p4.shape
    flat = p4.reshape(8, n, r * s)
    pad = (-r * s) % (T + 1)
    flat = torch.cat([flat, flat.new_zeros((8, n, pad))], dim=-1)
    run = _sim_reconstruct_packed_jit(N, T, False, True, fallback=False,
                                      replicate=False)
    sec, nerr = run(flat)
    assert nerr.tolist() == [0] * N
    rinv = pow(R_MOD_P, P - 2, P)
    vals = limbs_to_ints(unpack_limbs(sec[:, :r * s]).numpy().view(np.uint32))
    shares = limbs_to_ints(
        unpack_limbs(flat[:, :, :r * s:97]).numpy().view(np.uint32))
    parties = list(range(N - T - 1, N))
    lam = _lam_int([j + 1 for j in parties], 0)
    for i, col in enumerate(range(0, r * s, 97)):
        want = sum(l * int(shares[j, i]) for l, j in zip(lam, parties)) % P
        assert int(vals[col]) == want
    return np.array([int(v) * rinv % P for v in vals],
                    object).reshape(r, s)


def test_opened_triples_multiply_python_ints(port):
    a, b, ab = (_open_ints(x) for x in port[:3])
    for r in range(N_OUT):                     # the real triples
        for s in range(K):
            assert ab[r, s] == a[r, s] * b[r, s] % P, (r, s)
    assert len(set(a[:N_OUT].reshape(-1).tolist())) == N_OUT * K
    # padding rows: the check sharings (row n_out), then zero sharings
    assert not a[N_OUT + 1:].any() and not ab[N_OUT + 1:].any()


def _check_key_split(port):
    fn = offline.sim_offline_jit("generate_triples_packed", N, T, K,
                                 device="cpu")
    key = (2024, 7)
    one = fn(key)
    three = fn(subkeys=tuple(split_key(key, 3)))
    assert bool(one[3]) and all(torch.equal(x, y)
                                for x, y in zip(one, three))
    assert not torch.equal(one[0], port[0])
    with pytest.raises(ValueError):
        fn()
    with pytest.raises(ValueError):
        fn(key, subkeys=tuple(split_key(key, 3)))


def test_port_key_split_runs_the_same_program(port):
    """With one key the port derives the sub-keys with its own split_key;
    the program is the same function of the three pairs (the port's run on
    the reference's sub-keys, from the golden vectors, differs from it)."""
    _check_key_split(port)


@pytest.mark.slow
def test_port_key_split_runs_the_same_program_live_reference(
        live_reference, port):
    """The same, with the reference's split computed live (the
    live_reference fixture holds it equal to the stored one)."""
    _check_key_split(port)


def test_sim_backend_gate_and_unported_programs():
    class OtherBackend:
        n = N

    with pytest.raises(AssertionError, match="sim-only"):
        offline.fused_generate_triples(OtherBackend(), N, T, K, (1, 2),
                                       packed=True, device="cpu")
    with pytest.raises(AssertionError, match="sim-only"):
        offline.fused_randousha(OtherBackend(), N, T, K, (1, 2),
                                device="cpu")
    # formerly unported: the flat finish and the three programs now run
    a, b, ab, ok = offline.fused_generate_triples(
        SimBackend(N), N, T, K, (1, 2), packed=False, device="cpu")
    assert bool(ok) and ab.shape == (N, N_OUT * K)
    for program in ("randousha", "generate_triples", "generate_bits"):
        assert callable(offline.sim_offline_jit(program, N, T, K,
                                                device="cpu"))
    with pytest.raises(KeyError):
        offline.sim_offline_jit("no_such_program", N, T, K, device="cpu")
    assert offline.sim_offline_jit("generate_triples_packed", N, T, K,
                                   device="cpu") is \
        offline.sim_offline_jit("generate_triples_packed", N, T, K,
                                device="cpu")


def test_fused_randousha_entry_point():
    """runtime/offline.py::fused_randousha: FpArray double sharings whose
    two degrees open to the same secrets."""
    rt, r2, ok = offline.fused_randousha(SimBackend(N), N, T, 128, (5, 6),
                                         device="cpu")
    assert bool(ok) and rt.shape == r2.shape == (N, N_OUT * 128)
    st = limbs_to_ints(rt.limbs[:, :, ::61].numpy().view(np.uint32))
    s2 = limbs_to_ints(r2.limbs[:, :, ::61].numpy().view(np.uint32))
    lam_t = _lam_int(list(range(1, T + 2)), 0)
    lam_2 = _lam_int(list(range(1, 2 * T + 2)), 0)
    for c in range(st.shape[1]):
        sec_t = sum(l * int(st[j, c]) for j, l in enumerate(lam_t)) % P
        sec_2 = sum(l * int(s2[j, c]) for j, l in enumerate(lam_2)) % P
        assert sec_t == sec_2
