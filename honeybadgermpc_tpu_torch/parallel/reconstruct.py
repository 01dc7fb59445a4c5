"""Batch reconstruction (the hot path) as a two-round program.

Counterpart of ``honeybadgermpc_tpu/parallel/reconstruct.py``:

  R1: chunk each party's B shares into C = B/(t+1) polynomial chunks,
      encode them at all n party points, all_to_all the columns; each
      party decodes its chunk polynomials psi_j and evaluates them at 0.
  R2: all_gather those values; decode S_c (degree t) -> the secrets.

Fault tolerance, as in the reference: the optimistic decode interpolates
from the first t+1 shares and validates against the rest; when any share
disagrees, the whole batch goes through the Gao error-locating decoder
(``ops/gao.py``). Two forms of that:

* ``batch_reconstruct`` (``fallback=True``): the Gao pass follows inside
  the call, segmented by ``BUDGET`` instances;
* ``sim_batch_reconstruct``: the reference's accelerator route, TWO-PHASE
  on every device here — the detect-only direct open
  (ops/fused_open_direct.py), then, only when it saw a mismatch,
  ``host_robust_redo``: the band encode and segments of Gao decodes over
  host-held shares.

Only the single-device ``SimBackend`` is supported; the sharded and hybrid
programs (``make_sharded_reconstruct``, ``make_hybrid_reconstruct``) wait
for the mesh backends.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.fparray import FpArray
from ..ops.fpmatmul import decode_validate_matmul
from ..ops.fused_open import (pack_limbs, sim_open_fused_packed,
                              unpack_limbs)
from ..ops.fused_open_direct import direct_fits, sim_open_direct_packed
from ..ops.gao import gao_robust_decode
from ..ops.limbs import L, P
from ..ops.rs import Encoding
from .mesh import SimBackend

BUDGET = 4096             # Gao instances per segment of the in-call fallback


def _decode_block(enc: Encoding, ys: FpArray, k: int, robust: bool,
                  want_coeffs: bool = True, fallback: bool = True):
    """Decode from all-n shares ys[..., n] with the optimistic-then-Gao
    strategy. Returns (out, n_errors[...]): out is the message coeffs
    [..., k] (want_coeffs) or the interpolant at 0 [...].

    The optimistic path is ONE matmul: interpolation from the first k
    shares fused with re-evaluation at the other n-k party points. The
    reference's lax.cond is a host ``if`` on one device value here, and
    its lax.map over segments a loop."""
    n = enc.n
    fused = decode_validate_matmul(enc.points, k, FpArray(ys.limbs[..., :k]),
                                   want_coeffs)
    if want_coeffs:
        fast, reenc_rest = FpArray(fused.limbs[..., :k]), fused.limbs[..., k:]
    else:
        fast, reenc_rest = FpArray(fused.limbs[..., 0]), fused.limbs[..., 1:]
    zeros = torch.zeros(ys.shape[:-1], dtype=torch.int32, device=ys.device)
    if not robust:
        return fast, zeros

    # validation: predicted shares of parties k..n-1 vs the received ones
    agree = FpArray(reenc_rest).eq(FpArray(ys.limbs[..., k:]))
    if not fallback:
        # detect-only: report disagreement counts, the caller decides
        return fast, (~agree).sum(-1).to(torch.int32)
    if bool(agree.all()):
        return fast, zeros

    # Gao fallback over all instances, BUDGET at a time; zero shares are a
    # valid codeword, so the padding decodes to zero with no error
    bshape = ys.shape[:-1]
    nb = int(np.prod(bshape)) if bshape else 1
    seg = min(BUDGET, nb)
    nseg = -(-nb // seg)
    flat = ys.limbs.reshape(L, nb, n)
    if nseg * seg != nb:
        flat = torch.cat([flat, flat.new_zeros((L, nseg * seg - nb, n))], 1)
    outs, errs = [], []
    for s in range(nseg):
        seg_limbs = flat[:, s * seg:(s + 1) * seg]
        coeffs, reenc, _ = gao_robust_decode(enc, tuple(range(n)),
                                             FpArray(seg_limbs), k)
        errs.append((~reenc.eq(FpArray(seg_limbs))).sum(-1).to(torch.int32))
        outs.append(coeffs.limbs if want_coeffs else coeffs.limbs[..., 0])
    out = torch.cat(outs, 1)[:, :nb]
    out = out.reshape((L,) + tuple(bshape) + ((k,) if want_coeffs else ()))
    return FpArray(out), torch.cat(errs)[:nb].reshape(bshape)


def batch_reconstruct(backend, shares: FpArray, n: int, t: int,
                      use_omega_powers: bool = False, robust: bool = True,
                      fallback: bool = True):
    """Open a batch of B secrets from degree-t shares [n, B] (leading party
    axis; B a multiple of t+1, callers pad with zero sharings). Returns
    (secrets [n, B] — every party gets all secrets — and the error count
    per party, charged to the DESTINATION party of each decode, R1 plus
    R2)."""
    if not isinstance(backend, SimBackend):
        raise NotImplementedError("only SimBackend is ported")
    k = t + 1
    B = shares.shape[-1]
    if B % k:
        raise ValueError(f"batch {B} must be a multiple of t+1={k}")
    C = B // k
    enc = Encoding(n, use_omega_powers=use_omega_powers)

    # R1: encode chunk coefficients at all party points
    coeffs = shares.reshape(shares.shape[:-1] + (C, k))
    recv = backend.all_to_all(enc.encode(coeffs))      # [..., C, n]
    vals, err1 = _decode_block(enc, recv, k, robust, want_coeffs=False,
                               fallback=fallback)      # psi_j(0) = S_c(x_j)

    # R2: everyone shares its S_c(x_j); decode S_c -> secrets
    gathered = backend.all_gather(vals)                # [..., C, n]
    sec_coeffs, err2 = _decode_block(enc, gathered, k, robust,
                                     fallback=fallback)
    secrets = sec_coeffs.reshape(sec_coeffs.shape[:-2] + (B,))
    return secrets, err1.sum(-1) + err2.sum(-1)


def robust_open_single(backend, share: FpArray, n: int, t: int,
                       use_omega_powers: bool = False, robust: bool = True):
    """Open scalar secrets (shares [n, ...] treated pointwise): broadcast
    each party's share, robust-interpolate at 0. For control values; far
    less efficient than batch_reconstruct."""
    gathered = backend.all_gather(share)               # [n, ..., n]
    enc = Encoding(n, use_omega_powers=use_omega_powers)
    return _decode_block(enc, gathered, t + 1, robust, want_coeffs=False)


@lru_cache(maxsize=None)
def _sim_reconstruct_packed_jit(n: int, t: int, use_omega_powers: bool,
                                robust: bool, fallback: bool = True,
                                replicate: bool = True):
    """Open over PACKED shares int32 [PL, n, B] (the dealer's at-rest
    format) -> (secrets PACKED [PL, n, B], nerr [n]). Same name and
    signature as the reference's factory; it returns a plain callable
    (PyTorch runs eagerly, nothing is traced), which runs on the device
    its argument lies on.

    fallback=False: validation error counts are returned and the caller
    host-checks nerr and reruns robustly. In this detect-only mode the
    single-kernel direct-composition open serves the call.
    replicate=False additionally returns ONE secrets copy [PL, B] instead
    of the n-replicated view.

    Every other case is the faithful three-kernel open
    (ops/fused_open.py::sim_open_fused_packed), with its robust fallback
    when robust and fallback are both set; it returns the n-replicated
    view whatever `replicate` says, as the reference's does."""
    enc = Encoding(n, use_omega_powers=use_omega_powers)
    points = tuple(int(x) % P for x in enc.points)

    if robust and not fallback and direct_fits(n, t + 1):
        def run_direct(packed):
            return sim_open_direct_packed(packed, n, t, points,
                                          replicate=replicate)

        return run_direct

    def run_packed(packed):
        return sim_open_fused_packed(packed, n, t, points,
                                     robust=robust and fallback)

    return run_packed


@lru_cache(maxsize=None)
def _sim_reconstruct_jit(n: int, t: int, use_omega_powers: bool,
                         robust: bool, fallback: bool = True):
    """The SimBackend open over LIMBS [L, n, B] -> (secrets, nerr), by the
    reference's accelerator routing: the direct open where it fits (pack
    -> kernel -> secrets PACKED [PL, n, B]; ``run.packed`` tells the
    caller to unpack), with the in-call Gao fallback when robust and
    fallback are both set; the generic two-round program otherwise. The
    reference's branch between the two (its three-kernel open for
    n % 8 == 0, t+1 <= 32 where the direct open does not fit) raises: the
    direct open fits whenever t < n/3, so no protocol shape reaches it."""
    enc = Encoding(n, use_omega_powers=use_omega_powers)
    points = tuple(int(x) % P for x in enc.points)
    if direct_fits(n, t + 1):
        def run_direct(limbs):
            return sim_open_direct_packed(pack_limbs(limbs), n, t, points,
                                          robust=robust and fallback)

        run_direct.packed = True
        return run_direct
    if n % 8 == 0 and t + 1 <= 32:
        # the reference's next branch (its three-kernel open over limbs);
        # unreachable for t < n/3, where the direct open always fits
        raise NotImplementedError(
            "the three-kernel open over limbs for n <= t+1 is not ported; "
            "ops/fused_open.py::sim_open_fused serves packed shares")

    def run(limbs):
        secrets, nerr = batch_reconstruct(
            SimBackend(n), FpArray(limbs), n, t, use_omega_powers, robust,
            fallback=fallback)
        return secrets.limbs, nerr

    return run


def sim_batch_reconstruct(shares: FpArray, n: int, t: int,
                          use_omega_powers: bool = False, robust: bool = True,
                          tally=None):
    """SimBackend batch open of shares [n, ..., B] -> (secrets [n, ..., B],
    nerr), on the device the shares lie on. Robust opens are TWO-PHASE, as
    the reference runs them on the accelerator: a detect-only open, then,
    only when it reports a mismatch, ``host_robust_redo`` (nerr then counts
    each decode's errors at its destination party, R1 plus R2).

    nerr is [n] for shares [n, B]. Extra batch axes between the party and
    B flatten into one open (each trailing row a multiple of t+1, so chunk
    boundaries stay aligned) and are restored after; nerr is then
    [n, ...], as the reference's generic program returns it: each row's
    count from the redo where it ran, else the detect-only counts, which
    are charged to the source party and do not split into rows, each in
    its party's first row.

    ``tally`` (an int32 [1] device tensor) marks an open inside a program
    (a fused replay, runtime/fused.py): a robust open is then detect-only,
    adds its mismatch count into ``tally`` and reads nothing on the host;
    the program's runner redoes the whole call robustly when the tally is
    nonzero. The reference keeps its in-graph Gao fallback there instead
    (its ``lax.cond``); the words of the redone call are the same."""
    shp = tuple(shares.shape)
    mid = shp[1:-1]
    flat = shares.limbs.reshape(L, n, -1) if mid else shares.limbs
    run = _sim_reconstruct_jit(n, t, use_omega_powers, robust,
                               fallback=not robust)
    limbs, nerr = run(flat)
    if getattr(run, "packed", False):
        limbs = unpack_limbs(limbs)
    if robust and tally is not None:
        tally.add_(nerr.sum().to(torch.int32))
    found = robust and tally is None and int(nerr.sum()) != 0
    if mid:
        rows = torch.zeros((n, flat.shape[-1] // shp[-1]), dtype=torch.int32,
                           device=shares.device)
        rows[:, 0] = nerr
        nerr = rows.reshape((n,) + mid)
    if found:
        sec_np, chunk_np = host_robust_redo(
            flat.cpu().numpy().view(np.uint32), n, t, use_omega_powers,
            device=shares.device, per_chunk=True)
        limbs = torch.from_numpy(sec_np.view(np.int32)).to(shares.device)
        nerr = torch.from_numpy(
            chunk_np.reshape((n,) + mid + (-1,)).sum(-1).astype(np.int32)
        ).to(shares.device)
    return FpArray(limbs.reshape((L,) + shp)), nerr


# ---------------------------------------------------------------------------
# The robust redo: segment-wise Gao over host-held shares
# ---------------------------------------------------------------------------

_REDO_SEG = 2048          # Gao instances per segment


@lru_cache(maxsize=None)
def _redo_encode_jit(n: int, use_omega_powers: bool, k: int):
    """limbs [L, n, B] -> recv [L, n, C, n]: the R1 encode and all_to_all."""
    enc = Encoding(n, use_omega_powers=use_omega_powers)
    backend = SimBackend(n)

    def run(limbs):
        C = limbs.shape[-1] // k
        coeffs = FpArray(limbs.reshape(limbs.shape[:-1] + (C, k)))
        return backend.all_to_all(enc.encode(coeffs)).limbs

    return run


@lru_cache(maxsize=None)
def _redo_gao_jit(n: int, use_omega_powers: bool, k: int):
    """seg [L, SEG, n] -> (coeffs [L, SEG, k], errs int32 [SEG])."""
    enc = Encoding(n, use_omega_powers=use_omega_powers)

    def run(seg_limbs):
        coeffs, reenc, _ = gao_robust_decode(enc, tuple(range(n)),
                                             FpArray(seg_limbs), k)
        errs = (~reenc.eq(FpArray(seg_limbs))).sum(-1).to(torch.int32)
        return coeffs.limbs, errs

    return run


def _redo_decode_round(flat_np, n, use_omega_powers, k, device):
    """flat_np uint32 [L, NB, n] on the host -> (coeffs [L, NB, k], errs
    [NB]) on the host, one Gao segment of _REDO_SEG instances on `device`
    at a time (the last one zero-padded: a valid codeword)."""
    L0, nb, _ = flat_np.shape
    seg = min(_REDO_SEG, nb)
    gao = _redo_gao_jit(n, use_omega_powers, k)
    out = np.empty((L0, nb, k), np.uint32)
    errs = np.empty((nb,), np.int32)
    for lo in range(0, nb, seg):
        hi = min(lo + seg, nb)
        chunk = flat_np[:, lo:hi]
        if hi - lo < seg:
            chunk = np.concatenate(
                [chunk, np.zeros((L0, seg - (hi - lo), n), np.uint32)], 1)
        c, e = gao(torch.from_numpy(
            np.ascontiguousarray(chunk).view(np.int32)).to(device))
        out[:, lo:hi] = c.cpu().numpy().view(np.uint32)[:, :hi - lo]
        errs[lo:hi] = e.cpu().numpy()[:hi - lo]
    return out, errs


def host_robust_redo(shares_np: np.ndarray, n: int, t: int,
                     use_omega_powers: bool = False,
                     device=torch.device("cuda"), per_chunk: bool = False):
    """Full robust re-open of shares_np uint32 [L, n, B] (host array) with
    error correction up to (n-t-1)//2 wrong shares per decode, on `device`.
    Returns (secrets uint32 [L, n, B], nerr int32 [n]) as numpy arrays;
    ``per_chunk=True`` returns nerr [n, B/(t+1)] instead, each chunk's
    count. Mirrors batch_reconstruct's two rounds; each decode is a Gao
    segment."""
    k = t + 1
    L0, n_, B = shares_np.shape
    if n_ != n or B % k:
        raise ValueError(f"shares {shares_np.shape} for n={n}, t+1={k}")
    C = B // k
    device = torch.device(device)

    recv = _redo_encode_jit(n, use_omega_powers, k)(torch.from_numpy(
        np.ascontiguousarray(shares_np).view(np.int32)).to(device))
    recv = recv.cpu().numpy().view(np.uint32)          # [L, n, C, n]
    # R1: per-destination robust decode of the psi_j shares
    co1, err1 = _redo_decode_round(recv.reshape(L0, n * C, n), n,
                                   use_omega_powers, k, device)
    vals = co1[..., 0].reshape(L0, n, C)               # psi_j(0) = S_c(x_j)

    # R2 all_gather: every destination decodes the same psi vector (per-
    # destination decodes kept for simulation fidelity)
    gathered = np.broadcast_to(np.moveaxis(vals, 1, 2)[:, None],
                               (L0, n, C, n))
    co2, err2 = _redo_decode_round(
        np.ascontiguousarray(gathered).reshape(L0, n * C, n), n,
        use_omega_powers, k, device)
    secrets = co2.reshape(L0, n, B)
    nerr = (err1.reshape(n, C) + err2.reshape(n, C)).astype(np.int32)
    return secrets, (nerr if per_chunk else nerr.sum(1).astype(np.int32))


def inject_share_faults(shares: FpArray, party_ids, fault_parties, key_data):
    """Fault injection for tests and benchmarks: the listed parties replace
    their shares with uniform field elements drawn with FpArray.rand from
    `key_data` (two uint32). party_ids: int tensor broadcastable to the
    shares' party axis."""
    r = FpArray.rand(key_data, shares.shape, device=shares.device)
    bad = torch.zeros_like(party_ids, dtype=torch.bool)
    for p in fault_parties:
        bad = bad | (party_ids == p)
    while bad.dim() < len(shares.shape):
        bad = bad[..., None]
    return FpArray.select(bad.expand(shares.shape), r, shares)
