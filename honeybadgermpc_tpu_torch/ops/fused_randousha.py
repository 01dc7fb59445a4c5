"""Fused single-device n-party RanSha / RanDouSha: deal, extract, check.

Counterpart of ``honeybadgermpc_tpu/ops/fused_randousha.py``, both
verification modes. The offline preprocessing hot path as a chain of
kernels with no reshaping pass between stages; the dealer's randomness is
generated inside the deal kernel, so coefficients never exist in device
memory:

  deal:     per (source party, slot): draw the polynomial's uniform
            coefficients in registers (row 0 = the shared secret, rows 1..t
            the degree-t high part, rows t+1..3t the degree-2t high part),
            evaluate at the n party points, scatter share j to destination
            party j's receive tensor. One launch per degree.
  extract:  per (destination party, slot): the n received values are
            polynomial coefficients; re-evaluate at the first n-2t points
            (the hyperinvertible matmul) — these are the extracted random
            sharings — plus, in aggregate mode, ONE run-random rho-weighted
            combination of the 2t discarded columns, the aggregated check
            sharing z; in per-column mode, the 2t discarded columns
            themselves, into a check tensor.
  check:    aggregate mode: open z with the detect-only direct open at its
            degree. Per-column mode: decode every check column from the
            first k = deg+1 parties and validate the other n-k, counting
            mismatches per (check column, slot). Any mismatch, or a
            difference between the two degrees' opened check values, counts
            as an error.

Fault semantics are detect-only (any error flips ok — the protocol's
response is an abort vote either way). Soundness of the aggregated check:
a nonzero deviation in any check column survives the rho-combination only
if sum_j rho_j*delta_j = 0, probability <= 1/p. rho is derived from the
run key, so the check is sound only where dealers cannot know the key: the
single-process simulation (see runtime/offline.py). The per-column check
opens every discarded column on its own: it is sound whatever the dealers
know, and it localizes a fault to its check column and slot.

Layouts. The receive tensor is int32 ``[PL, dst, src, sp]`` — the
extraction reads one destination's n sources as n rows of sp words. (The
reference's six-axis ``[nblk, njt, PL, n, JT, TBW]`` is a tiling of the same
values; ``interop.from_reference_receive`` permutes it.) Outputs keep the
reference's contract: packed share tensors ``[PL, n, n_outp, sp]`` with the
extracted sharings in rows ``[:n_out]`` and, in aggregate mode, the check
sharing in row n_out and zero sharings above (in per-column mode rows
n_out .. n_outp-1 hold the first check columns), or flat
``[PL, n, n_out*k]`` column-major stripes (share of output-column c at slot
s at index c*k + s). The per-column check tensor is int32
``[PL, n, ncheckp, sp]``, zero above column ncheck
(``interop.from_reference_check`` permutes the reference's
``[nblk, njt, PL, JT, ncheckp, TBW]``).

On CUDA tensors deal, extract (both modes) and check are the hand-written
kernels ``csrc/randousha_deal.cu``, ``csrc/randousha_extract.cu`` and
``csrc/open_fused.cu::randousha_check_kernel``, all on the wgmma core
``csrc/band_gemm.cuh`` (the deal draws its operands in the plane build,
the extractions and the check load them); ``_randousha_deal_plain``,
``_randousha_extract_plain`` and ``_randousha_check_plain`` are their plain
PyTorch versions, used on the CPU and as the yardstick the kernels are held
against bit for bit.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from . import montgomery as mont
from .field_kernels import _key_ints, _threefry2x32, _threefry_redc384
from .band_gemm import (_fold_array, _gemm_band, _gemm_band_index,
                        _gemm_plan, _redc384_words)
from .fused_open import (KMAX, NBAL, PL, _BAL_ROUNDS, _bal_bias,
                         _bal_fold_init, _band_dot_fold, _encode_band_np,
                         _folded_band_host, _gemm_args, _launch_stream,
                         _open_bands, _pack16, _pad_band, _planes_of,
                         _planes_of_packed, _r1_lanes_plain, _round8)
from .limbs import P, W, ints_to_limbs

JT = 8                  # party-count granule of the reference's layouts
TBW = 128               # slot granule: sp is a multiple of it (it enters the
                        # Threefry counters, so it is part of the function)

# Threefry counter domain tag of the dealer draws: disjoint from
# field_kernels.rand_limbs (c0 < 6) under an accidentally shared key.
_CTR_TAG = 0x10000
_RHO_TAG = 0x20000      # counter domain of the check-aggregation vector

# times each CUDA kernel was launched (counted there and nowhere else)
launches_deal = 0
launches_extract = 0        # aggregate mode
launches_extract_pc = 0     # per-column mode
launches_check = 0
# times a plain version of deal, extract or check ran on a CUDA tensor: the
# card's paths must keep this at 0 (only a comparison against the kernels
# may move it)
plain_calls_on_cuda = 0


def _count_plain(x):
    global plain_calls_on_cuda
    if x.is_cuda:
        plain_calls_on_cuda += 1


def fused_fits(n: int, t: int) -> bool:
    return (n % JT == 0 and n <= KMAX and n - 2 * t >= 1
            and 2 * t + 1 <= KMAX and 3 * t + 1 <= 64)


def _deal_rows(t: int, degree: int):
    """Global coefficient-row ids of a degree's polynomial: row 0 is the
    secret in both; rows 1..t complete degree t, rows t+1..3t degree 2t."""
    if degree == t:
        return tuple(range(t + 1))
    assert degree == 2 * t, (t, degree)
    return (0,) + tuple(range(t + 1, 3 * t + 1))


# ---------------------------------------------------------------------------
# rho and the folded extraction band (plain tensor code, tiny)
# ---------------------------------------------------------------------------

def _rho_plain(key_data, device=torch.device("cuda")):
    """The check-aggregation vector rho: 64 canonical field elements from
    Threefry counter domain 0x20000 (disjoint from the dealer draws at
    c0 >= _CTR_TAG and from the sampler's c0 < 6). int32 [L, 64]."""
    c1 = torch.arange(64, dtype=torch.int64, device=device)
    c0 = torch.full_like(c1, _RHO_TAG)
    return _threefry_redc384(key_data, c0, c1).to(torch.int32)


def _bal_digits_device(w):
    """Balanced base-256 digits of canonical values: int32 limbs [L, ...]
    (< p) -> int8 [NBAL, ...]. The tensor twin of fused_open._bal_digits
    (p's top byte is 0x73 < 0x80, so the final carry is always 0)."""
    w64 = w.to(torch.int64)
    carry = torch.zeros_like(w64[0])
    digs = []
    for r in range(NBAL):
        j, off = divmod(8 * r, W)
        u = ((w64[j] >> off) & 0xFF) + carry
        ge = (u >= 128).to(torch.int64)
        digs.append((u - (ge << 8)).to(torch.int8))
        carry = ge
    return torch.stack(digs, 0)


# ---------------------------------------------------------------------------
# Deal
# ---------------------------------------------------------------------------

def _deal_band_tiles(points: tuple, kk: int) -> np.ndarray:
    """The deal kernel's band: the encode band of kk coefficients at the n
    `points` in band_gemm tiles, int8 [ceil(n/2), kk, 2048]
    (band_gemm._gemm_band; the same tiles as K1's band)."""
    band, n1 = _encode_band_np(points, kk)
    return _gemm_band(band[0], n1, kk, len(points))


@functools.lru_cache(maxsize=None)
def _encode_band_device(points: tuple, kk: int, device: torch.device):
    """The encode band of kk coefficients at `points` on `device`: the
    reference layout int8 [NBAL*n1, kcols] for the plain version, and for
    CUDA also the deal kernel's tiles (_deal_band_tiles). -> (ref, kern,
    n1)."""
    band, n1 = _encode_band_np(points, kk)
    ref = torch.from_numpy(band[0]).to(device)
    kern = None
    if device.type == "cuda":
        kern = torch.from_numpy(_deal_band_tiles(points, kk)).to(device)
    return ref, kern, n1


def _deal_coeff_limbs(key_data, n: int, t: int, degree: int, sp: int,
                      slot0: int, nslot: int, device):
    """The dealt polynomials' coefficients: canonical limbs int64
    [L, kk, n*nslot], coefficient i of lane (src, slot) at [:, i,
    src*nslot + slot - slot0], drawn at counters c0 = _CTR_TAG + 8*row
    (row: the coefficient's global row, _deal_rows) and c1 = src*sp +
    slot."""
    rows = _deal_rows(t, degree)
    src = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    slot = torch.arange(slot0, slot0 + nslot, dtype=torch.int64,
                        device=device)[None, :]
    c1 = ((src * sp + slot) & 0xFFFFFFFF).reshape(1, n * nslot)
    c0 = (_CTR_TAG + 8 * torch.tensor(rows, dtype=torch.int64,
                                      device=device))[:, None]
    c0, c1 = torch.broadcast_tensors(c0, c1)         # [kk, n*nslot]
    return _threefry_redc384(key_data, c0, c1)


def _randousha_deal_plain(key_data, n: int, t: int, degree: int, sp: int,
                          points: tuple, device, slot0: int = 0,
                          nslot: int | None = None):
    """Plain PyTorch version of the deal: the receive tensor int32
    [PL, dst, src, nslot] for slots slot0 .. slot0+nslot-1 of all n sources
    (all sp slots by default). Counters do not depend on the slot window,
    so a window equals the same slice of the full tensor."""
    nslot = sp - slot0 if nslot is None else nslot
    kk = len(_deal_rows(t, degree))
    band, _, n1 = _encode_band_device(points, kk, torch.device(device))
    _count_plain(band)
    limbs = _deal_coeff_limbs(key_data, n, t, degree, sp, slot0, nslot,
                              device)                # int64 [L, kk, lanes]
    out = _pack16(_band_dot_fold(band, _planes_of(limbs), n1,
                                 _bal_fold_init(kk), _bal_bias(kk)))
    return out[:, :n].reshape(PL, n, n, nslot).contiguous()


def _draw_words(key_data, kk: int, row1: int, lanes):
    """Plain twin of band_gemm.cuh's DrawSrc: the packed words int32
    [PL, kk, len(lanes)] of items (lane g, coefficient i) for the flat lane
    indices `lanes` (int64): Threefry-2x32 at c0 = _CTR_TAG + 8*row + s,
    c1 = g, row 0 for i = 0 and row1 + i - 1 above, then the kernel's
    32-bit REDC (band_gemm._redc384_words)."""
    k0, k1 = _key_ints(key_data)
    rows = torch.tensor([0] + [row1 + i - 1 for i in range(1, kk)],
                        dtype=torch.int64, device=lanes.device)
    c0, c1 = torch.broadcast_tensors(_CTR_TAG + 8 * rows[:, None],
                                     lanes[None, :] & 0xFFFFFFFF)
    x = []
    for s in range(6):
        x.extend(_threefry2x32(k0, k1, c0 + s, c1))
    return _redc384_words(x)


def _deal_plan(k: int, nlanes: int, nsm: int = 132) -> int:
    """64-lane blocks per thread block of the deal, chosen by measurement
    on an H100 (tools/band_core_study.py; PERF.md §6): band_gemm's lane
    tile (_gemm_plan, the most lanes whose planes fit and still fill the
    card) was the fastest at both degrees, 256 lanes at k = 22 and 128 at
    k = 43. A 64-lane block needs only 110,720 B of shared memory at
    k = 22, but its 640 threads at 72 registers leave no room for a second
    block on an SM, so one block's draw cannot run under another's dot."""
    return _gemm_plan(k, nlanes, nsm)


@functools.lru_cache(maxsize=None)
def _deal_launcher(n: int, t: int, degree: int, sp: int, points: tuple,
                   device: torch.device):
    """Everything a deal launch needs but the key: kernel entry, band tiles
    on the device, fold constants, lane tile."""
    from .._build import lib
    fn = lib().hb_randousha_deal
    rows = _deal_rows(t, degree)
    kk = len(rows)
    row1 = rows[1] if kk > 1 else 1
    _, band, _ = _encode_band_device(points, kk, device)
    fold = _fold_array(_bal_fold_init(kk), _bal_bias(kk))
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    plan = _deal_plan(kk, n * sp, nsm)

    def launch(key_data, plan=plan, out=None):
        """plan: the lane tile (64-lane blocks per thread block); out: a
        receive tensor to write into instead of a new one."""
        k0, k1 = _key_ints(key_data)
        if out is None:
            out = torch.empty((PL, n, n, sp), dtype=torch.int32,
                              device=device)
        rc = fn(k0, k1, band.data_ptr(), out.data_ptr(), n, sp, kk, row1,
                plan, fold, _launch_stream(out))
        return rc, out

    launch.kk = kk
    return launch


def _randousha_deal_cuda(key_data, n, t, degree, sp, points, device):
    """Launch csrc/randousha_deal.cu -> receive tensor [PL, n, n, sp]."""
    global launches_deal
    rc, out = _deal_launcher(n, t, degree, sp, points, device)(key_data)
    launches_deal += 1
    if rc != 0:
        raise RuntimeError(
            f"randousha_deal kernel launch failed: CUDA error {rc}")
    return out


def randousha_deal(key_data, n: int, t: int, degree: int, sp: int,
                   points: tuple, device=torch.device("cuda")):
    """Draw and deal every party's sp random degree-`degree` sharings
    (degree = t or 2t; the secrets, row 0, are the same for both) ->
    receive tensor int32 [PL, dst, src, sp] on `device`."""
    device = torch.device(device)
    if degree not in (t, 2 * t):
        raise ValueError(f"degree must be t={t} or 2t={2 * t}, got {degree}")
    if sp % TBW != 0 or not 0 < n * sp < (1 << 32):
        raise ValueError(f"sp must be a positive multiple of {TBW} with "
                         f"n*sp < 2^32, got {sp}")
    if device.type == "cuda":
        return _randousha_deal_cuda(key_data, n, t, degree, sp, points,
                                    device)
    return _randousha_deal_plain(key_data, n, t, degree, sp, points, device)


# ---------------------------------------------------------------------------
# Extract
# ---------------------------------------------------------------------------

def _randousha_extract_plain(cols, band, n_out: int, n_outp: int,
                             ncheckp: int | None = None):
    """Plain PyTorch version of the extraction. cols int32
    [PL, dst, src, sp]; band int8 [NBAL*ncp, >= NBAL*n] (reference layout).

    ncheckp None (aggregate mode): the rho-folded band -> (keep
    [PL, n, n_outp, sp], z [PL, n, sp] = column n_out). ncheckp given
    (per-column mode): the full n-point band (ncp >= n) -> (keep, chk
    [PL, n, ncheckp, sp]): keep holds band columns [:n_outp], chk columns
    n_out..n-1 and zeros above. One destination party at a time, so the
    dot's intermediate stays small."""
    _count_plain(cols)
    n = cols.shape[2]
    ncp = band.shape[0] // NBAL
    init, bias = _bal_fold_init(n), _bal_bias(n)
    keep, rest = [], []
    for dst in range(cols.shape[1]):
        planes = _planes_of_packed(cols[:, dst])          # [NBAL*n, sp]
        out = _pack16(_band_dot_fold(band, planes, ncp, init, bias))
        keep.append(out[:, :n_outp])
        if ncheckp is None:
            rest.append(out[:, n_out])
        else:
            rest.append(torch.cat([out[:, n_out:n], out.new_zeros(
                (PL, ncheckp - (n - n_out), out.shape[-1]))], dim=1))
    return torch.stack(keep, 1).contiguous(), torch.stack(rest, 1).contiguous()


def _tiles_cache(relay):
    """tiles_of(band) -> band's bytes gathered through `relay` (a
    band_gemm tile layout), the last result kept while the same band comes
    back unmodified: the same tensor, or a view at the same place of the
    same base (the aggregated extraction gets `band[0]` of the run's band,
    a new view each call), at the same version."""
    cached = None              # (the base, weakly; the view's key; tiles)

    def tiles_of(band):
        nonlocal cached
        base = band if band._base is None else band._base
        key = (band._version, band.storage_offset(), tuple(band.shape),
               band.stride())
        if cached is None or cached[0]() is not base or cached[1] != key:
            cached = (weakref.ref(base), key, band.reshape(-1)[relay])
        return cached[2]

    return tiles_of


@functools.lru_cache(maxsize=None)
def _extract_launcher(n: int, n_out: int, n_outp: int, ncp: int, kcn: int,
                      ncheckp: int | None, device: torch.device):
    """Everything an extract launch needs but its operands: kernel entry,
    the gather that re-lays a reference-layout band into band_gemm tiles
    (n_out + 1 columns of the rho-folded band in aggregate mode, all n of
    the encode band in per-column mode) and the launch plan. The re-laid
    copy is kept while the same band, unmodified, comes back: the run's
    folded band serves both degrees, the per-column band every run."""
    from .._build import lib
    m = n if ncheckp is not None else n_out + 1
    tiles_of = _tiles_cache(torch.from_numpy(
        _gemm_band_index(ncp, n, m, kcn)).to(device))

    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    fold = _fold_array(_bal_fold_init(n), _bal_bias(n))

    def launch(cols, band, keep=None, out2=None, plan=None):
        """keep, out2: outputs to write into instead of new ones (out2 is z
        in aggregate mode, chk in per-column mode); plan: the lane tile,
        _gemm_plan's by default."""
        sp = cols.shape[-1]
        plan = plan or _gemm_plan(n, n * sp, nsm)
        tiles = tiles_of(band)
        if keep is None:
            keep = torch.empty((PL, n, n_outp, sp), dtype=torch.int32,
                               device=device)
        if ncheckp is None:
            if out2 is None:
                out2 = torch.empty((PL, n, sp), dtype=torch.int32,
                                   device=device)
            rc = lib().hb_randousha_extract(
                cols.data_ptr(), tiles.data_ptr(), keep.data_ptr(),
                out2.data_ptr(), n, sp, n_out, n_outp,
                plan, fold, _launch_stream(cols))
            return rc, keep, out2
        if out2 is None:
            out2 = torch.empty((PL, n, ncheckp, sp), dtype=torch.int32,
                               device=device)
        rc = lib().hb_randousha_extract_pc(
            cols.data_ptr(), tiles.data_ptr(), keep.data_ptr(),
            out2.data_ptr(), n, sp, n_out, n_outp, ncheckp,
            plan, fold, _launch_stream(cols))
        return rc, keep, out2

    return launch


def _randousha_extract_cuda(cols, band, n_out: int, n_outp: int,
                            ncheckp: int | None):
    """Launch csrc/randousha_extract.cu (randousha_extract_kernel, or
    randousha_extract_pc_kernel when ncheckp is given; both on
    csrc/band_gemm.cuh) on a receive tensor and a reference-layout band,
    both on the card."""
    global launches_extract, launches_extract_pc
    n = cols.shape[2]
    ncp = band.shape[0] // NBAL
    rc, keep, out2 = _extract_launcher(n, n_out, n_outp, ncp, band.shape[1],
                                       ncheckp, cols.device)(cols, band)
    if ncheckp is None:
        launches_extract += 1
    else:
        launches_extract_pc += 1
    if rc != 0:
        raise RuntimeError(
            f"randousha_extract kernel launch failed: CUDA error {rc}")
    return keep, out2


def randousha_extract(cols, band, n_out: int, n_outp: int,
                      ncheckp: int | None = None):
    """Extract from a receive tensor int32 [PL, n, n, sp].

    Aggregate mode (ncheckp None): band is the rho-folded band int8
    [NBAL*ncp, kcn] (ncp > n_out columns) -> (keep [PL, n, n_outp, sp],
    z [PL, n, sp]). Per-column mode: band is the full n-point encode band
    (ncp >= n columns) -> (keep [PL, n, n_outp, sp], chk int32
    [PL, n, ncheckp, sp]): keep rows n_out..n_outp-1 are the first check
    columns, check columns from ncheck = n - n_out on are zero."""
    if cols.dtype != torch.int32 or cols.dim() != 4 or cols.shape[0] != PL \
            or cols.shape[1] != cols.shape[2] or not cols.is_contiguous():
        raise ValueError(f"cols must be contiguous int32 [{PL}, n, n, sp], "
                         f"got {cols.dtype} {tuple(cols.shape)}")
    n = cols.shape[2]
    ncp_min = n_out + 1 if ncheckp is None else n
    if band.dtype != torch.int8 or band.dim() != 2 \
            or band.shape[0] % NBAL != 0 or band.shape[1] < NBAL * n \
            or band.shape[0] // NBAL < ncp_min or band.device != cols.device \
            or not band.is_contiguous():
        raise ValueError(f"band must be contiguous int8 [NBAL*ncp, >= "
                         f"{NBAL * n}] with ncp >= {ncp_min} on "
                         f"{cols.device}, got {band.dtype} "
                         f"{tuple(band.shape)}")
    if n > KMAX:
        raise ValueError(f"extraction needs n <= {KMAX}, got {n}")
    if not 0 < n_out <= n_outp <= n:
        raise ValueError(f"need 0 < n_out <= n_outp <= n, got {n_out}, "
                         f"{n_outp}, {n}")
    if ncheckp is not None and ncheckp < n - n_out:
        raise ValueError(f"ncheckp {ncheckp} < ncheck {n - n_out}")
    if cols.is_cuda:
        return _randousha_extract_cuda(cols, band, n_out, n_outp, ncheckp)
    return _randousha_extract_plain(cols, band, n_out, n_outp, ncheckp)


# ---------------------------------------------------------------------------
# Per-column check
# ---------------------------------------------------------------------------

def _randousha_check_plain(chk, k: int, points: tuple):
    """Plain PyTorch version of the per-column check: chk int32
    [PL, n, ncheckp, sp] -> (vals [PL, ncheckp, sp], errs int32
    [ncheckp, sp]). Lane (c, s) is K2's decode of the n parties' shares of
    check column c at slot s (ops/fused_open.py::_r1_lanes_plain)."""
    _count_plain(chk)
    _, n, ncheckp, sp = chk.shape
    vals, bad = _r1_lanes_plain(chk.reshape(PL, n, ncheckp * sp), points, k)
    return vals.reshape(PL, ncheckp, sp), bad.reshape(ncheckp, sp)


def _randousha_check_cuda(chk, k: int, points: tuple):
    """Launch csrc/open_fused.cu::randousha_check_kernel (on
    csrc/band_gemm.cuh, K2's tiles) on the card."""
    global launches_check
    from .._build import lib
    _, n, ncheckp, sp = chk.shape
    tiles = _open_bands(points, k, chk.device)[0][1][2]
    vals = torch.empty((PL, ncheckp, sp), dtype=torch.int32,
                       device=chk.device)
    errs = torch.zeros((ncheckp, sp), dtype=torch.int32, device=chk.device)
    rc = lib().hb_randousha_check(chk.data_ptr(), tiles.data_ptr(),
                                  vals.data_ptr(), errs.data_ptr(), n, k, sp,
                                  ncheckp,
                                  *_gemm_args(k, ncheckp * sp, chk.device),
                                  _launch_stream(chk))
    launches_check += 1
    if rc != 0:
        raise RuntimeError(
            f"randousha_check kernel launch failed: CUDA error {rc}")
    return vals, errs


def randousha_check(chk, k: int, points: tuple):
    """The per-column check of one degree: chk int32 [PL, n, ncheckp, sp],
    every party's shares of every check column -> (vals int32
    [PL, ncheckp, sp], each lane's value at 0 decoded from the first k
    parties; errs int32 [ncheckp, sp], how many of the other n-k parties'
    shares differ from the decoded polynomial in any word). k = deg+1."""
    if chk.dtype != torch.int32 or chk.dim() != 4 or chk.shape[0] != PL \
            or not chk.is_contiguous():
        raise ValueError(f"chk must be contiguous int32 [{PL}, n, ncheckp, "
                         f"sp], got {chk.dtype} {tuple(chk.shape)}")
    n = chk.shape[1]
    if len(points) != n or not 0 < k < n or k > KMAX:
        raise ValueError(f"need {n} points and 0 < k < n, k <= {KMAX}; got "
                         f"{len(points)} points, k={k}")
    points = tuple(int(x) % P for x in points)
    if chk.is_cuda:
        return _randousha_check_cuda(chk, k, points)
    return _randousha_check_plain(chk, k, points)


# ---------------------------------------------------------------------------
# Plumbing
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _randousha_calls(n: int, t: int, sp: int, points: tuple,
                     aggregate: bool = True, single: bool = False,
                     device=torch.device("cuda")):
    """sp: padded slot count (multiple of TBW). Returns run(key_data) ->
    (keep_t, keep_2t packed [PL, n, n_outp, sp], nerr): nerr a 0-d int32
    tensor on the device, the total of check failures. Nothing in run reads
    a device value on the host.

    aggregate=True: the verification opens run as ONE rho-weighted batched
    check per degree (soundness 1 - 1/p), and rho is FOLDED INTO THE
    EXTRACTION BAND: the extraction computes n_out keep columns plus one
    aggregated check column instead of all n, and the 2t-column check
    tensor never exists.

    aggregate=False: the per-column verification, the protocol-faithful
    check. The extraction re-encodes at all n points (keep rows n_out ..
    n_outp-1 are then the first check columns) and writes the 2t discarded
    columns to a check tensor [PL, n, ncheckp, sp]; every check column is
    decoded from the first deg+1 parties and validated against the other
    n-deg-1, at both degrees. nerr is the validation mismatches over the
    real check columns plus the (column, slot) pairs whose opened values
    differ between the degrees.

    single=True: RanSha — degree-t sharings only (no 2t dealing, no
    extraction at 2t, no cross-degree equality; the degree-t check still
    validates every dealer's degree). run(key_data) -> (keep_t, nerr).

    run(key_data, tamper=f) passes every receive tensor through
    f(cols, degree) between deal and extract: the simulation's stand-in for
    a Byzantine dealer or a fault on the wire, for tests of the check.

    run.parts = (kd_t, kd_2, ke) in aggregate mode: the stages
    (kd_*(key_data) -> receive tensor, ke(cols, band) -> (keep, z)); in
    per-column mode (kd_t, kd_2, ke, kc_t, kc_2) with ke(cols) -> (keep,
    chk) on the constant full band and kc_*(chk) -> (vals, errs), the check
    at each degree. run.meta = (n_out, n_outp, ncheck, ncheckp);
    run.folded_band(key_data) -> the run's extraction band (None in
    per-column mode)."""
    device = torch.device(device)
    assert fused_fits(n, t) and sp % TBW == 0
    n_out = n - 2 * t
    ncheck = 2 * t
    n_outp = _round8(n_out)
    ncheckp = _round8(ncheck)
    kcn = NBAL * n
    ncp2 = _round8(n_out + 1)

    def kd_t(key_data):
        return randousha_deal(key_data, n, t, t, sp, points, device)

    def kd_2(key_data):
        return randousha_deal(key_data, n, t, 2 * t, sp, points, device)

    if not aggregate:
        return _per_column_run(n, t, points, single, device, kd_t, kd_2,
                               (n_out, n_outp, ncheck, ncheckp))

    def ke(cols, band):
        return randousha_extract(cols, band[0], n_out, n_outp)

    # Constants of the rho-folded extraction band. Keep columns are protocol
    # constants (the first n_out points of the n-point re-encode); the
    # aggregated column u_kk = sum_c rho_c * points[n_out+c]^kk is
    # run-random and folded in on the device below.
    R256 = pow(2, 256, P)
    mat_keep = [[pow(int(points[j]), i, P) for j in range(n_out)]
                for i in range(n)]
    base_band = torch.from_numpy(_pad_band(
        _folded_band_host(mat_keep, _BAL_ROUNDS, ncp2), kcn)).to(device)
    def limbs_of(ints):
        """Nested lists of Python ints -> int32 limb tensor [L, *shape]."""
        return torch.from_numpy(
            ints_to_limbs(ints).view(np.int32)).to(device)

    echk_mont = limbs_of(
        [[pow(int(points[n_out + c]), i, P) * R256 % P for i in range(n)]
         for c in range(ncheck)])                       # [L, ncheck, n]
    cs2 = limbs_of([pow(2, 8 * s + 16 * _BAL_ROUNDS, P) * R256 % P
                    for s in range(NBAL)])              # [L, NBAL]

    def folded_band(key_data):
        """The run's extraction band int8 [1, NBAL*ncp2, kcn] on the
        device: the host keep band + balanced digits of u*2^(8s+32)
        scattered into the aggregated column (a 2t x n modular matvec)."""
        rho = _rho_plain(key_data, device)[:, :ncheck]        # [L, ncheck]
        u = mont.mont_mul(rho[:, :, None], echk_mont)         # [L, nc, n]
        m = ncheck
        while m > 1:                                          # pairwise tree
            half = m // 2
            s2 = mont.add_mod(u[:, :half], u[:, half:2 * half])
            if m % 2:
                s2 = torch.cat([s2, u[:, m - 1:m]], dim=1)
                m = half + 1
            else:
                m = half
            u = s2
        u = u[:, 0]                                           # [L, n] < p
        w = mont.mont_mul(u[:, None, :], cs2[:, :, None])     # [L, NBAL, n]
        d = _bal_digits_device(w)                             # [r, s, n]
        band = base_band.clone().reshape(NBAL, ncp2, kcn)
        band[:, n_out, :NBAL * n] = d.reshape(NBAL, NBAL * n)
        return band.reshape(1, NBAL * ncp2, kcn)

    def _open_z(z, deg):
        """Open the aggregated check column (a degree-`deg` sharing of sp
        values) with the detect-only direct open -> (values packed
        [PL, B'], nerr [n]); sp is padded to a multiple of deg+1 with zero
        sharings."""
        from ..parallel.reconstruct import _sim_reconstruct_packed_jit
        kk = deg + 1
        pad = (-sp) % kk
        zp = torch.cat([z, z.new_zeros((PL, n, pad))], dim=-1) if pad else z
        opener = _sim_reconstruct_packed_jit(n, deg, False, True,
                                             fallback=False, replicate=False)
        return opener(zp)

    def run(key_data, tamper=None):
        cols_t = kd_t(key_data)
        if tamper is not None:
            cols_t = tamper(cols_t, t)
        band = folded_band(key_data)
        keep_t, z_t = ke(cols_t, band)
        del cols_t                          # 32*n*n*sp bytes, free it early
        vt, et = _open_z(z_t, t)
        if single:
            return keep_t, et.sum()
        cols_2t = kd_2(key_data)
        if tamper is not None:
            cols_2t = tamper(cols_2t, 2 * t)
        keep_2t, z_2t = ke(cols_2t, band)
        del cols_2t
        v2, e2 = _open_z(z_2t, 2 * t)
        neq = (vt[:, :sp] != v2[:, :sp]).any(dim=0).sum()
        nerr = et.sum() + e2.sum() + neq
        return keep_t, keep_2t, nerr

    run.parts = (kd_t, kd_2, ke)
    run.meta = (n_out, n_outp, ncheck, ncheckp)
    run.folded_band = folded_band
    return run


def _per_column_run(n, t, points, single, device, kd_t, kd_2, meta):
    """run(key_data, tamper=None) of _randousha_calls(aggregate=False): the
    reference's per-column pipeline, deal -> full-band extract -> check at
    each degree. The receive and check tensors (537 MB and 403 MB per
    degree at n=64, sp=4096) are freed as soon as they are read."""
    n_out, n_outp, ncheck, ncheckp = meta
    band = _encode_band_device(points, n, device)[0]     # full n-point band

    def ke(cols):
        return randousha_extract(cols, band, n_out, n_outp, ncheckp)

    def kc_t(chk):
        return randousha_check(chk, t + 1, points)

    def kc_2(chk):
        return randousha_check(chk, 2 * t + 1, points)

    def run(key_data, tamper=None):
        cols_t = kd_t(key_data)
        if tamper is not None:
            cols_t = tamper(cols_t, t)
        keep_t, chk_t = ke(cols_t)
        del cols_t
        vt, et = kc_t(chk_t)
        del chk_t
        if single:
            return keep_t, et[:ncheck].sum()
        cols_2t = kd_2(key_data)
        if tamper is not None:
            cols_2t = tamper(cols_2t, 2 * t)
        keep_2t, chk_2t = ke(cols_2t)
        del cols_2t
        v2, e2 = kc_2(chk_2t)
        del chk_2t
        # cross-degree equality on the real check columns (packed words)
        neq = (vt[:, :ncheck] != v2[:, :ncheck]).any(dim=0).sum()
        nerr = et[:ncheck].sum() + e2[:ncheck].sum() + neq
        return keep_t, keep_2t, nerr

    run.parts = (kd_t, kd_2, ke, kc_t, kc_2)
    run.meta = meta
    run.folded_band = None
    return run


def _party_points(n: int) -> tuple:
    from .rs import Encoding
    return tuple(int(x) % P for x in Encoding(n).points)


def sim_ransha_fused(key_data, n: int, t: int, k: int, padded: bool = False,
                     device=torch.device("cuda"), tamper=None):
    """Single-degree RanSha: k slots -> k*(n-2t) verified random DEGREE-t
    sharings, packed [PL, n, k*(n-2t)], plus ok (0-d bool tensor). The
    deal/extract/check pipeline of RanDouSha minus everything 2t — used for
    the a/b slots of triple generation.

    padded=True (requires k % TBW == 0): skip the column-drop slice and
    return the raw 4D keep tensor [PL, n, n_outp, k]. Rows >= n_out hold
    the aggregated-check sharing (row n_out) and zero sharings — all VALID
    degree-t sharings, so downstream arithmetic and opens pass through them
    cleanly, and the 4D finish kernels (field_kernels.mul_add_packed4 /
    sub_bcast_packed4) consume it as stored."""
    sp = -(-k // TBW) * TBW
    run = _randousha_calls(n, t, sp, _party_points(n), single=True,
                           device=torch.device(device))
    keep_t, nerr = run(key_data, tamper=tamper)
    n_out = run.meta[0]
    if padded:
        assert sp == k, (sp, k, "padded layout requires k % TBW == 0")
        return keep_t, nerr == 0             # raw 4D [PL, n, n_outp, k]
    v = keep_t[:, :, :n_out, :k]
    return v.reshape(PL, n, n_out * k), nerr == 0


def sim_randousha_fused(key_data, n: int, t: int, k: int,
                        padded: bool = False, device=torch.device("cuda"),
                        tamper=None):
    """k slots per party -> packed double sharings, detect-only.

    Returns (r_t, r_2t packed [PL, n, k*(n-2t)], ok 0-d bool tensor).
    Output index c*k + s = output-column c (< n-2t) of slot s — every
    column is an independent uniform double sharing, so the stripe order is
    a labeling convention (documented for pool reproducibility).

    padded=True: as in sim_ransha_fused — raw 4D [PL, n, n_outp, k] with
    the real double sharings in rows [:n_out]."""
    sp = -(-k // TBW) * TBW
    run = _randousha_calls(n, t, sp, _party_points(n),
                           device=torch.device(device))
    keep_t, keep_2t, nerr = run(key_data, tamper=tamper)
    n_out = run.meta[0]
    if padded:
        assert sp == k, (sp, k, "padded layout requires k % TBW == 0")
        return keep_t, keep_2t, nerr == 0    # raw 4D [PL, n, n_outp, k]

    def finalize(keep):
        v = keep[:, :, :n_out, :k]           # drop col + slot padding
        return v.reshape(PL, n, n_out * k)

    return finalize(keep_t), finalize(keep_2t), nerr == 0
