"""GF(p) matrix products through 7-bit digit planes and an int8 dot.

Counterpart of ``honeybadgermpc_tpu/ops/mxu_matmul.py``. A Montgomery
product sum_k a*v over GF(p) becomes an integer convolution of base-2^7
digits (0..127, exact in int8), one int8 matmul, and a modular epilogue.
Three routes, chosen by shape exactly as the reference chooses
(``fused2_fits``, ``fused_fits``, called from ops/fpmatmul.py):

* ``fp_matmul_mxu2`` — the folded-constant scheme: the band operand
  w_dk = v_k * 2^(7d + 16 rounds) * R^-1 mod p is built on the device from
  v (``_folded_band_digits``: a mont_mul and ``_planes7``), so 37 output
  diagonals carry the already-reduced value and the epilogue is a 37-term
  fold, 1-2 REDC rounds and two conditional subtracts (``_fold_reduce``).
  On a CUDA tensor: the kernel ``csrc/mxu_fused2.cu``; ``_fused2_plain``
  is its plain version.
* ``fp_matmul_mxu_fused`` — the full product convolution in one kernel:
  a's planes against the band of v's planes (pre-scaled by 2^16 R,
  ``_scaled_planes``) give 73 diagonals, which the 17-round REDC epilogue
  reduces (``_redc_diagonals``) without leaving the chip. On a CUDA tensor:
  ``csrc/mxu_fused.cu``; ``_fused_plain`` is its plain version.
* ``fp_matmul_mxu`` — the same convolution with the dot outside the
  kernel: the library's int8 matmul (``torch._int_mm`` on the card), as
  the reference left it to XLA, then the epilogue kernel
  ``csrc/mxu_redc.cu`` on a CUDA tensor. Where ``fused_fits`` holds it
  takes the fused kernel on the card, as the reference does on the TPU.

Both fused kernels run on the wgmma core's MXU geometry
(csrc/band_gemm.cuh, ``mxu_gemm_body``): the digit planes of 128 lanes in
shared memory, in chunks of 16 operands (resident up to k = 38, else
streamed through two chunk buffers), against band tiles of 80 rows
(``_mxu_tiles``), so every k that the reference's predicates route to them
runs.

The plain versions mirror the reference's integer work in int64, with one
deliberate difference: the reference folds adjacent diagonals in pairs,
d_2i + (d_2i+1 << 7), in uint32, which wraps once a diagonal reaches 2^25
(uniform inputs do from about k = 230), and then returns wrong words. The
port keeps that sum exact (``_pairs``; the kernels pair only where it
cannot wrap, k <= 55), so every route gives the true product; at the
shapes where the reference does not wrap the words are equal.
"""

from __future__ import annotations

import numpy as np
import torch

from . import montgomery as mont
from .fused_open import _launch_stream
from .limbs import L, MASK, N0, P, P_LIMBS, R_MOD_P, W, int_to_limbs

PLANE_BITS = 7
NPLANES = 37                  # ceil(259 / 7) covers 256-bit values
NOUT = 2 * NPLANES - 1        # 73 product diagonals
REDC_ROUNDS = 17              # divide by 2^272
_P = [int(x) for x in P_LIMBS]

# 2^(16*17-256) * R mod p: mont_mul(x, this) = x * 2^16, which cancels the
# 2^-16 surplus of the 17-round REDC
_SCALE_PRE = int_to_limbs((1 << (16 * REDC_ROUNDS - 256)) * R_MOD_P % P)

K_ROUNDS1 = (1 << 17) // (NPLANES * 127)      # = 27

# times each CUDA kernel was launched (counted there and nowhere else)
launches_fused2 = 0
launches_fused = 0
launches_redc = 0
# times a plain version ran on CUDA tensors (only comparisons may do that)
plain_calls_on_cuda = 0


def _count_plain(x):
    global plain_calls_on_cuda
    if x.is_cuda:
        plain_calls_on_cuda += 1


def _planes7(limbs):
    """int32[L, ...] 16-bit limbs -> int8[..., NPLANES] base-2^7 digits.
    Digit d covers bits [7d, 7d+7), assembled from 1-2 limbs."""
    outs = []
    for d in range(NPLANES):
        j, r = divmod(PLANE_BITS * d, W)
        v = limbs[j] >> r
        if r + PLANE_BITS > W and j + 1 < L:
            v = v | (limbs[j + 1] << (W - r))
        outs.append((v & 0x7F).to(torch.int8))
    return torch.stack(outs, dim=-1)


def _scaled_planes(v_limbs):
    """v[L, k, n] Montgomery limbs -> int8[k, n, NPLANES] planes of
    v * 2^(16*REDC_ROUNDS-256) (the REDC pre-scale baked in)."""
    k, n = v_limbs.shape[1], v_limbs.shape[2]
    scale = mont.const_stack(_SCALE_PRE, (k, n), v_limbs.device)
    return _planes7(mont.mont_mul(v_limbs, scale))


def _build_vband(v_limbs):
    """v[L, k, n] -> V' int8[k*NPLANES, n*NOUT]: column (nn, l) holds plane
    l-i of v[:, nn] at row (kk, i)."""
    k, n = v_limbs.shape[1], v_limbs.shape[2]
    v8 = _scaled_planes(v_limbs)                   # [k, n, NPLANES]
    band = torch.zeros((k, NPLANES, n, NOUT), dtype=torch.int8,
                       device=v_limbs.device)
    for i in range(NPLANES):
        band[:, i, :, i:i + NPLANES] = v8
    return band.reshape(k * NPLANES, n * NOUT)


def _dot_s8(x, y):
    """Exact int8 x int8 -> int32 matmul [M, K] @ [K, N]. On the card the
    library's int8 GEMM (``torch._int_mm``: every side zero-padded to a
    multiple of 16, M to at least 32, the result sliced; y handed over
    column-major, since cuBLASLt refused some row-major shapes, e.g.
    [1040, 112] @ [112, 160], on an H100); on the CPU an int32 matmul.
    Callers keep every sum below 2^31."""
    if not x.is_cuda:
        return x.to(torch.int32) @ y.to(torch.int32)
    m, kd = x.shape
    n = y.shape[1]
    mp, kp, np_ = (max(-(-m // 16) * 16, 32), -(-kd // 16) * 16,
                   -(-n // 16) * 16)
    if (mp, kp) != (m, kd):
        x = torch.nn.functional.pad(x, (0, kp - kd, 0, mp - m))
    if (kp, np_) != (kd, n):
        y = torch.nn.functional.pad(y, (0, np_ - n, 0, kp - kd))
    return torch._int_mm(x.contiguous(), y.t().contiguous().t())[:m, :n]


def _add_at_bit(t, e, bit):
    """t (carry-save 16-bit limbs) += e * 2^bit as 16-bit chunks at limbs
    j, j+1, j+2 (the last one holds all of e's bits above 32 - r)."""
    j, r = divmod(bit, W)
    elo, ehi = e & MASK, e >> W
    t[j] = t[j] + ((elo << r) & MASK)
    if j + 1 < len(t):
        t[j + 1] = t[j + 1] + ((elo >> (W - r)) | ((ehi << r) & MASK))
    if j + 2 < len(t):
        t[j + 2] = t[j + 2] + (ehi >> (W - r))


def _pairs(d, count):
    """Diagonals (int64, values < 2^31) -> (bit, e) terms: adjacent pairs
    e = d_2i + (d_2i+1 << 7), the odd last one alone. Exact in int64 (the
    reference's uint32 wraps here at large k; see the module docstring)."""
    out = [(PLANE_BITS * i, d[i] + (d[i + 1] << PLANE_BITS))
           for i in range(0, count - 1, 2)]
    if count % 2:
        out.append((PLANE_BITS * (count - 1), d[count - 1]))
    return out


def _redc_step(t):
    """One 16-bit Montgomery REDC round on carry-save limbs t (list of
    int64 tensors, each far below 2^32): t <- (t + m*p) >> 16."""
    m = ((t[0] & MASK) * N0) & MASK
    for j in range(L):
        if _P[j]:
            pr = m * _P[j]
            t[j] = t[j] + (pr & MASK)
            t[j + 1] = t[j + 1] + (pr >> W)
    carry0 = t[0] >> W
    t = t[1:] + [torch.zeros_like(t[0])]
    t[0] = t[0] + carry0
    return t


def _cond_sub_wide(limbs, hi):
    """Value hi*2^256 + limbs (canonical 16-bit limbs) < 3p: subtract p
    once if it is >= p. Returns (limbs, hi)."""
    borrow = torch.zeros_like(hi)
    d = []
    for j in range(L):
        v = limbs[j] - _P[j] - borrow
        d.append(v & MASK)
        borrow = (v >> W) & 1
    take = (hi != 0) | (borrow == 0)
    hi2 = torch.where(take, hi - borrow, hi)
    return [torch.where(take, d[j], limbs[j]) for j in range(L)], hi2


def _redc_diagonals(ds):
    """Plain version of the row-15 kernel (csrc/mxu_redc.cu): int32
    [NOUT, ...] diagonals (each < 2^31) -> int32 [L, ...] canonical
    Montgomery limbs. 36 carry-save limbs, 17 REDC rounds, one
    conditional subtract."""
    _count_plain(ds)
    d = ds.to(torch.int64)
    t = [torch.zeros_like(d[0]) for _ in range(36)]
    for bit, e in _pairs(d, NOUT):
        _add_at_bit(t, e, bit)
    for _ in range(REDC_ROUNDS):
        t = _redc_step(t)
    out, hi = mont._carry_chain(t)
    out, _ = _cond_sub_wide(out, hi)
    return torch.stack(out, 0).to(torch.int32)


def _rounds_for(k: int) -> int:
    return 1 if k <= K_ROUNDS1 else 2


def _fold_reduce(ds, rounds: int):
    """Plain version of the row-13 kernel's epilogue: int32 [NPLANES, ...]
    diagonals (7-bit spacing, total value V < 3p * 2^(16 rounds)) -> int32
    [L, ...] canonical limbs of V / 2^(16 rounds) mod p."""
    d = ds.to(torch.int64)
    t = [torch.zeros_like(d[0]) for _ in range(19)]
    for bit, e in _pairs(d, NPLANES):
        _add_at_bit(t, e, bit)
    for _ in range(rounds):
        t = _redc_step(t)
    out, c = mont._carry_chain(t)
    hi = c + t[L]
    out, hi = _cond_sub_wide(out, hi)
    out, hi = _cond_sub_wide(out, hi)
    return torch.stack(out, 0).to(torch.int32)


def _folded_band_digits(v_limbs, rounds: int):
    """v[L, k, n] Montgomery limbs -> int8[k, n, NPLANES(d), NPLANES(s)]:
    digit s of w_dk = v_kn * 2^(7d + 16*rounds) * R^{-1} mod p."""
    cs = torch.stack([
        mont.const_stack(int_to_limbs(pow(2, PLANE_BITS * d + 16 * rounds, P)),
                         (), v_limbs.device)
        for d in range(NPLANES)], dim=-1)                   # [L, NPLANES]
    w = mont.mont_mul(v_limbs[..., None], cs.reshape(L, 1, 1, NPLANES))
    return _planes7(w)                                       # [k, n, d, s]


def fused_fits(k: int, n: int) -> bool:
    """The reference's VMEM test for its fused v1 kernel (kept as a pure
    function of (k, n): it decides which route a shape takes)."""
    if n < 4:
        return False
    TN = min(n, 128)
    kcols = -(-(k * NPLANES) // 32) * 32
    band = NOUT * TN * kcols
    d32 = NOUT * TN * 128 * 4
    return band + d32 < 9 * 2 ** 20


def fused2_fits(k: int, n: int) -> bool:
    """The reference's VMEM test for its folded-constant kernel (a pure
    function of (k, n), as above)."""
    if n < 4 or NPLANES * k * 127 * 127 >= 2 ** 31:
        return False
    TN = min(n, 128)
    kcols = -(-(k * NPLANES) // 32) * 32
    band = NPLANES * TN * kcols
    d32 = NPLANES * TN * 128 * 4
    ablk = (L + 1) * k * 128 * 4
    return band + d32 + ablk < 6 * 2 ** 20


# -- rows 13 and 14 on the wgmma core (csrc/band_gemm.cuh, mxu_gemm_body) ---

MXU_KC = 16                       # operands per plane chunk
CHUNK_STEPS = -(-(MXU_KC * NPLANES) // 32)    # 19 k-steps of 32 digit rows
TN = 80                           # band rows per tile: wgmma N
HALF = TN // 4                    # diagonals per thread and lane
STEP_BYTES = TN * 32              # one k-step of one tile
_KS = 4                           # k-steps per ring slot
_SLOTS = 2                        # slots of each consumer's ring
CONS = 2                          # consumer warpgroups
_NBAR = 16                        # chunk mbarriers of each kind
TM = 128                          # lanes per block
SMEM_MAX = 232448                 # shared memory a Hopper block may use


def _chunk_steps(k: int, c: int) -> int:
    """k-steps of chunk c (operands 16c .. 16c + 15, 37 digit rows each)."""
    return -(-(NPLANES * min(MXU_KC, k - MXU_KC * c)) // 32)


def _mxu_ksteps(k: int) -> int:
    """k-steps of the whole contraction (band_gemm.cuh's mxu_ksteps)."""
    return sum(_chunk_steps(k, c) for c in range(-(-k // MXU_KC)))


def _mxu_smem_bytes(k: int, nbuf: int) -> int:
    """Dynamic shared memory of a 128-lane block with nbuf chunk buffers
    (band_gemm.cuh's mxu_smem_bytes)."""
    nch = -(-k // MXU_KC)
    steps = _mxu_ksteps(k) if nbuf >= nch else nbuf * CHUNK_STEPS
    return (steps * 32 * TM + CONS * _SLOTS * _KS * STEP_BYTES
            + 16 * (CONS * _SLOTS + _NBAR))


def _mxu_plan(k: int, n: int, h: int):
    """(tile groups, chunk buffers, shared bytes) of a launch over k
    operands and n columns, h threads per column (2 for row 13, 4 for row
    14). Resident where the planes of all k operands fit beside the rings
    (k <= 38): one block per 128 lanes walks every tile. Else two chunk
    buffers, one tile per consumer, ceil(tiles / 2) blocks per 128
    lanes."""
    nch = -(-k // MXU_KC)
    smem = _mxu_smem_bytes(k, nch)
    if smem <= SMEM_MAX and nch <= _NBAR:
        return 1, nch, smem
    ntiles = -(-n // (4 // h))
    return -(-ntiles // CONS), 2, _mxu_smem_bytes(k, 2)


def _pair_safe(k: int) -> bool:
    """d_2i + (d_2i+1 << 7) stays below 2^32 for diagonals < 37 k 127^2."""
    return 129 * NPLANES * k * 127 * 127 < 2 ** 32


def _mxu_tile_rows(h: int):
    """(column within the tile, diagonal) of each of a band tile's 80 rows
    for h threads per column: row r is held by thread tg = (r % 8) // 2 of
    a quad, as its diagonal slot 2 (r // 8) + r % 2 of part tg % h."""
    r = torch.arange(TN)
    tg = (r % 8) // 2
    return tg // h, HALF * (tg % h) + 2 * (r // 8) + r % 2


def _mxu_digit_rows(k: int):
    """int64 [k * 37]: the digit row of (operand kk, digit d), kk-major, in
    the chunked contraction order (chunks of 16 operands, each padded to
    whole k-steps)."""
    kk = torch.arange(k)[:, None]
    d = torch.arange(NPLANES)[None, :]
    return ((kk // MXU_KC) * CHUNK_STEPS * 32 + (kk % MXU_KC) * NPLANES
            + d).reshape(-1)


def _mxu_tiles(m, h: int):
    """Band digits int8 [n, nd, k, 37] (column, diagonal, operand, digit)
    -> the kernels' band tiles int8 [ceil(n / (4 / h)), ksteps, 2560]: per
    (tile, k-step) one wgmma B operand of 80 rows x 32 digit rows in the
    K-major canonical layout [16-byte half][row // 8][row % 8][16]
    (rows by _mxu_tile_rows, digit rows by _mxu_digit_rows; the rest
    zero)."""
    n, nd, k, _ = m.shape
    cpt = 4 // h
    ntiles = -(-n // cpt)
    ks = _mxu_ksteps(k)
    bq = torch.zeros((ntiles * cpt, h * HALF, ks * 32), dtype=torch.int8,
                     device=m.device)
    rows = _mxu_digit_rows(k).to(m.device)
    bq[:n, :nd, rows] = m.reshape(n, nd, k * NPLANES)
    # column c, part, slot (i, e) -> row 8i + 2 (c h + part) + e
    t = bq.reshape(ntiles, cpt * h, HALF // 2, 2, ks, 2, 16)
    t = t.permute(0, 4, 5, 2, 1, 3, 6)        # tile, ks, half, i, tg, e, byte
    return t.contiguous().reshape(ntiles, ks, STEP_BYTES)


def _fused2_tiles(wd):
    """Folded digits wd int8 [k, n, d, s] -> row 13's band tiles: column
    col, diagonal s, digit row (kk, d) holds digit s of w_dk."""
    return _mxu_tiles(wd.permute(1, 3, 0, 2), 2)


def _fused_tiles(v8):
    """Scaled planes v8 int8 [k, n, 37] -> row 14's band tiles: diagonal l
    at digit row (kk, d) holds digit l - d of v[kk] (0 outside 0..36)."""
    k, n = v8.shape[0], v8.shape[1]
    band = torch.zeros((n, NOUT, k, NPLANES), dtype=torch.int8,
                       device=v8.device)
    vt = v8.permute(1, 2, 0)                                     # [n, s, k]
    for d in range(NPLANES):
        band[:, d:d + NPLANES, :, d] = vt
    return _mxu_tiles(band, 4)


def _mxu_chunk_image(a, c: int) -> np.ndarray:
    """Plain twin of band_gemm.cuh's mxu_build_block: a int32 [L, B, k]
    (CPU) -> uint8 [blocks, 19 * 32 * 128], the shared-memory image of
    plane chunk c of every 128-lane block, word for word (item = lane and 4
    operands, 148 digit bytes as 37 words, none past the chunk's k-steps;
    bytes no item writes stay 0)."""
    _, B, k = a.shape
    nblk = -(-B // TM)
    x = a.to(torch.int64).numpy().astype(np.uint64)           # [L, B, k]
    x = np.pad(x, ((0, 0), (0, nblk * TM - B), (0, 0)))
    oct_n = TM // 8
    lane = np.arange(nblk * TM)
    blk, oct_, l8 = lane // TM, (lane % TM) // 8, lane % 8
    img = np.zeros((nblk, CHUNK_STEPS * 32 * TM), np.uint8)
    for jq in range(4):
        kk0 = MXU_KC * c + 4 * jq
        if kk0 >= k:
            continue
        w = np.zeros((4, nblk * TM, 9), np.uint64)          # 32-bit words
        for e in range(4):
            if kk0 + e < k:
                li = x[:, :, kk0 + e]
                w[e, :, :8] = (li[0::2] | (li[1::2] << np.uint64(16))).T
        for wd in range(NPLANES):
            word = np.zeros(nblk * TM, np.uint64)
            for e4 in range(4):
                t = 4 * wd + e4
                e, d = divmod(t, NPLANES)
                j, r = divmod(7 * d, 32)
                v = (w[e, :, j] | (w[e, :, j + 1] << np.uint64(32))) >> \
                    np.uint64(r)
                word |= (v & np.uint64(0x7F)) << np.uint64(8 * e4)
            q = 148 * jq + 4 * wd
            if q >= 32 * _chunk_steps(k, c):      # past the chunk's k-steps
                continue
            at = ((q >> 4) * oct_n + oct_) * 128 + l8 * 16 + (q & 15)
            for bb in range(4):
                img[blk, at + bb] = (word >> np.uint64(8 * bb)) & \
                    np.uint64(0xFF)
    return img


def _mxu_epilogue(diag, h: int, epi):
    """Plain twin of mxu_gemm_body's epilogue: the exact diagonals int64
    [B, n, nd] of every (lane, column) -> int32 [L, B, n]. Every consumer
    thread's accumulators are laid out as wgmma leaves them for the band
    rows of _mxu_tile_rows; each thread gathers, as the kernel's xor
    shuffles do, the diagonals of the lane slots it owns from the h threads
    of its column, and `epi` ([nd, M] -> [L, M]: _fold_reduce or
    _redc_diagonals) reduces them."""
    B, n, nd = diag.shape
    cpt = 4 // h
    nblk, ntiles = -(-B // TM), -(-n // cpt)
    dp = torch.zeros((nblk * TM, ntiles * cpt, h * HALF), dtype=torch.int64)
    dp[:B, :n, :nd] = diag
    col, dg = _mxu_tile_rows(h)
    # d[blk, lane, tile, r]: the accumulator of band row r of the tile
    d = dp.reshape(nblk, TM, ntiles, cpt, h * HALF)[:, :, :, col, dg]
    j = torch.arange(HALF)
    blk, tile = torch.arange(nblk), torch.arange(ntiles)
    ds_all, lanes, cols = [], [], []
    for wl in range(4):
        for g in range(8):
            for tg in range(4):
                part = tg % h
                for u in range(4 // h):              # the slots it owns
                    own = u * h + part               # slot 2 mb + hh
                    lane = 64 * (own // 2) + 16 * wl + g + 8 * (own % 2)
                    # round x: the diagonals 20 (part ^ x) + j that thread
                    # tg ^ x holds of slot `own` (x = 0: its own)
                    got = [d[:, lane, :, 8 * (j // 2) + 2 * (tg ^ x) + j % 2]
                           for x in range(h)]
                    ds = torch.cat([got[x ^ part] for x in range(h)], -1)
                    ds_all.append(ds[..., :nd].reshape(-1, nd))
                    lanes.append((blk * TM + lane)[:, None].expand(
                        nblk, ntiles).reshape(-1))
                    cols.append((tile * cpt + tg // h)[None, :].expand(
                        nblk, ntiles).reshape(-1))
    red = epi(torch.cat(ds_all).t().contiguous())           # [L, M]
    out = torch.zeros((L, nblk * TM, ntiles * cpt), dtype=torch.int32)
    out[:, torch.cat(lanes), torch.cat(cols)] = red
    return out[:, :B, :n]


def _mxu_out_plan(k: int, n: int, h: int) -> bool:
    """Whether the results go out by way of a scratch tensor
    (mxu_gemm_body's last phase): with one tile group, the consumers leave
    a block's 16-bit limbs there, [block][L][column][lane], and once every
    tile is done write them to out by whole lane rows through the planes
    and rings, some limbs at a time: at least one limb of 128 lanes x
    (columns | 1) words must fit there. Else (tile groups, or no room) the
    consumers store to out."""
    tgroups, _, smem = _mxu_plan(k, n, h)
    free = smem - 16 * (CONS * _SLOTS + _NBAR)          # all but mbarriers
    ncolsp = -(-n // (4 // h)) * (4 // h)
    return tgroups == 1 and TM * (ncolsp | 1) * 4 <= free


def _run_mxu(entry, a, tiles, n, h, *args):
    """Launch a kernel on mxu_gemm_body: a int32 [L, B, k] (contiguous),
    its band tiles -> int32 [L, B, n], the results by way of a scratch
    tensor [block][L][column][lane] of 16-bit limbs where _mxu_out_plan
    says so."""
    _, B, k = a.shape
    tgroups, nbuf, _ = _mxu_plan(k, n, h)
    out = torch.empty((L, B, n), dtype=torch.int32, device=a.device)
    tmp = None
    if _mxu_out_plan(k, n, h):
        ncolsp = -(-n // (4 // h)) * (4 // h)
        tmp = torch.empty((-(-B // TM), L, ncolsp, TM), dtype=torch.int16,
                          device=a.device)
    rc = entry(a.data_ptr(), tiles.data_ptr(), out.data_ptr(),
               0 if tmp is None else tmp.data_ptr(), B, k, n,
               *args, tgroups, nbuf, int(_pair_safe(k)), _launch_stream(a))
    if rc != 0:
        raise RuntimeError(f"MXU kernel launch failed: CUDA error {rc}")
    return out


def _fused2_cuda(a, wd, rounds: int):
    """Launch csrc/mxu_fused2.cu: a int32 [L, B, k] (contiguous), wd the
    band digits [k, n, 37, 37] -> int32 [L, B, n]."""
    global launches_fused2
    from .._build import lib
    out = _run_mxu(lib().hb_mxu_fused2, a, _fused2_tiles(wd), wd.shape[1], 2,
                   rounds)
    launches_fused2 += 1
    return out


def _fused2_plain(a, wd, rounds: int):
    """Plain PyTorch version of the row-13 kernel: same digits, an exact
    integer dot (_dot_s8) and the same fold -> int32 [L, B, n]."""
    _count_plain(a)
    _, B, k = a.shape
    n = wd.shape[1]
    ap = _planes7(a).reshape(B, k * NPLANES)                   # q = kk*37+d
    w = wd.permute(0, 2, 1, 3).reshape(k * NPLANES, n * NPLANES)
    diag = _dot_s8(ap, w).reshape(B, n, NPLANES)
    return _fold_reduce(diag.permute(2, 0, 1), rounds)


def fp_matmul_mxu2(a_limbs, v_limbs):
    """a[L, B, k] @ v[L, k, n] (both Montgomery) -> [L, B, n] via the
    folded-constant scheme: the kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    k = a_limbs.shape[2]
    rounds = _rounds_for(k)
    wd = _folded_band_digits(v_limbs, rounds)                  # [k, n, d, s]
    a = a_limbs.contiguous()
    if a.is_cuda:
        return _fused2_cuda(a, wd, rounds)
    return _fused2_plain(a, wd, rounds)


# -- row 14: the unfolded product convolution in one kernel ------------------

def _fused_cuda(a, v_limbs):
    """Launch csrc/mxu_fused.cu: a int32 [L, B, k] (contiguous), v [L, k,
    n] Montgomery limbs -> int32 [L, B, n]."""
    global launches_fused
    from .._build import lib
    tiles = _fused_tiles(_scaled_planes(v_limbs))
    out = _run_mxu(lib().hb_mxu_fused, a, tiles, v_limbs.shape[2], 4)
    launches_fused += 1
    return out


def _fused_plain(a, v_limbs):
    """Plain PyTorch version of the row-14 kernel: the same 73 diagonals
    from an exact integer dot, the same REDC epilogue -> int32 [L, B, n]."""
    _, B, _ = a.shape
    return _redc_diagonals(_mxu_diagonals(a, v_limbs)).reshape(
        L, B, v_limbs.shape[2])


def fp_matmul_mxu_fused(a_limbs, v_limbs):
    """a[L, B, k] @ v[L, k, n] (both Montgomery) -> [L, B, n] through the
    73-diagonal product convolution and the 17-round REDC: the kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    a = a_limbs.contiguous()
    if a.is_cuda:
        return _fused_cuda(a, v_limbs)
    return _fused_plain(a, v_limbs)


# -- row 15: library dot + the REDC epilogue kernel --------------------------

def _redc_cuda(diag, k: int):
    """Launch csrc/mxu_redc.cu: int32 [NOUT, M] (contiguous) diagonals of a
    contraction over k -> int32 [L, M]."""
    global launches_redc
    from .._build import lib
    M = diag.shape[1]
    out = torch.empty((L, M), dtype=torch.int32, device=diag.device)
    rc = lib().hb_mxu_redc(diag.data_ptr(), out.data_ptr(), M,
                           int(_pair_safe(k)), _launch_stream(diag))
    launches_redc += 1
    if rc != 0:
        raise RuntimeError(f"mxu_redc kernel launch failed: CUDA error {rc}")
    return out


def _mxu_diagonals(a_limbs, v_limbs):
    """a[L, B, k], v[L, k, n] -> int32 [NOUT, B*n]: the 73 product
    diagonals of every output element, from one int8 dot."""
    _, B, k = a_limbs.shape
    n = v_limbs.shape[2]
    ap = _planes7(a_limbs).reshape(B, k * NPLANES)
    diag = _dot_s8(ap, _build_vband(v_limbs))             # [B, n*NOUT]
    return diag.reshape(B * n, NOUT).t().contiguous()


def fp_matmul_mxu(a_limbs, v_limbs):
    """a[L, B, k] @ v[L, k, n] (both Montgomery) -> [L, B, n] Montgomery:
    an int8 dot of a's planes against v's scaled band, then the REDC
    epilogue (the kernel on a CUDA tensor, its plain version on a CPU
    tensor). On the card a shape where ``fused_fits`` holds takes the fused
    kernel instead, as the reference does on the TPU."""
    _, B, k = a_limbs.shape
    n = v_limbs.shape[2]
    if a_limbs.is_cuda and fused_fits(k, n):
        return fp_matmul_mxu_fused(a_limbs, v_limbs)
    diag = _mxu_diagonals(a_limbs, v_limbs)
    if diag.is_cuda:
        out = _redc_cuda(diag, k)
    else:
        out = _redc_diagonals(diag)
    return out.reshape(L, B, n)
