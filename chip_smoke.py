"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size; needs one CUDA card

Drives the port's main paths through the entry points a user calls, at
n=64, t=21:

  * the open path — deal -> pack -> open (detect-only) -> check — in
    segments of 22*768 = 16896 sharings, 64 segments resident (about 2.2 GB
    of packed shares);
  * the offline path — verified Beaver triples from the fused RanSha /
    RanDouSha pipeline with the packed finish,
    ``sim_offline_jit("generate_triples_packed", 64, 21, 4096)``: 90,112
    triples per call;
  * the robust open — one 16896-sharing segment with the shares of 21
    parties replaced: the two-phase ``sim_batch_reconstruct`` (detect-only
    open, then the Gao redo over 2 x 49,152 decodes), ``batch_reconstruct``
    with its Gao fallback, ``sim_open_direct_packed(robust=True)``,
    ``robust_open_single`` and the three-kernel open with its fallback;
  * the offline programs — ``sim_offline_jit(program, 64, 21, 4096,
    in_graph_fallback)`` for randousha, generate_triples and generate_bits
    in both modes (90,112 double sharings, triples or bits per call): the
    fused pipelines, the eager per-column programs with detect-only opens,
    and with the faithful three-kernel open and its in-program fallback;
  * the coding layer and the NTL-compatible API — the reference bench's
    grids of Vandermonde interpolation, NTT interpolation and evaluation
    and random refinement, the omega-domain encode and FNT decode of
    16,896 polynomials from 43 of 128 parties, and every ``ntl`` function,
    among them ``vandermonde_batch_evaluate`` of 1,024 polynomials with 512
    coefficients at 4 points (the fused 73-diagonal MXU kernel).

The first run builds the kernels from ``honeybadgermpc_tpu_torch/csrc``
into ``honeybadgermpc_tpu_torch/build``.

Phases, each printing one JSON line; any failure exits non-zero:
  1 device    a CUDA card must be present; prints its name and power limit
  2 build     compile and load the sixteen kernels
  3 kernels   each kernel against its plain PyTorch version on the card,
              bit for bit, at small, unaligned and main-path shapes, with
              times and the computed bound
  4 main      deal, pack and open every segment; nerr == 0; opened secrets
              against a Python-int Lagrange oracle; launch counters moved
  5 faults    a flipped word is detected and charged to the right party
  6 state     save the pool, load it into a fresh dealer, same secrets
  7 timing    opened and dealt sharings per second
  8 triples   one triple call; ok; launch counters moved; a, b, ab opened
              at degree t with nerr == 0 and ab == a*b mod p for every real
              triple on the card, and for a sample in Python ints
  9 triple faults   a flipped word in a receive tensor flips ok
 10 triple timing   triples per second and device time per stage
 11 robust kernels    rows 9, 12, 13 and 15 of PERF.md (mont_mul,
              fp_matmul_cios, mxu_fused2, mxu_redc) against their plain
              versions on the card, bit for bit, at the robust open's
              shapes, a Python-int sample each, times and bounds
 12 robust open       honest: nerr == 0 and no Gao launch; 21 faulty
              parties: phase one sees them, the redo returns the honest
              secrets with nerr == 768*21 at every party, the other three
              entry points agree, no plain multiply or matmul ran on the
              card; the redo's time and the device time of one Gao segment;
              the three-kernel open charges every destination and its
              fallback returns the honest secrets
 13 program kernels  rows 10 and 16-18 (mul_add_packed, open_fused K1-K3)
              against their plain versions on the card, bit for bit, at the
              programs' shapes (k = 22 and 43), an unaligned chunk count and
              a small shape, honest and faulted, a Python-int sample each
 14 programs  each program in both modes once with the launch counts set
              to 0 just before and read just after: ok; r_t and r_2t open
              to equal secrets; ab == a*b for every triple; every bit is 0
              or 1 and both occur; K1-K3 launched by the fallback runs,
              mul_add_packed by the fused triples, no plain version on the
              card; then ms per call, outputs per second, device-busy ms
 15 program fault     generate_triples with the fallback at k=16 and one
              party sending wrong shares of a*b + r: the outputs equal the
              honest run's, ok turns false
 16 coding kernels    rows 14 and 13 (mxu_fused, mxu_fused2) against their
              plain versions on the card, bit for bit, at every window
              fp_matmul routes to them (row 14: k 439-858 at n=4, 313-422
              at n=8, 196-204 at n=16; row 13 k-streamed up to k=438), a
              Python-int sample each, times and bounds; fp_matmul on CUDA
              tensors at both sides of every window edge: no raise, the
              routed kernel launched, no plain version on the card
 17 ntl       with the launch counts set to 0 just before: the bench grids
              (vandermonde_batch_interpolate n=16/128/1024 x 8, NTT
              interpolate/evaluate n=2^4..2^14 x 2^16/n, refine_randoms
              n=4/16/64 x 512), Encoding(128, omega) encode and decode from
              43 parties, every ntl function once (row 14 through
              vandermonde_batch_evaluate), each against Python ints on a
              sample; rates in the bench's units beside device-busy ms

The last line of the output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Bounds. ``bound_ms`` is the least time the card could take: the larger of
bytes moved (each input read once, each output written once) over 3.35
TB/s and operations over the peak for their type — 1,979 TOP/s for the
int8 dots (H100 SXM, dense). The sampler does 32-bit integer work on the
CUDA cores, for which the data sheet names no rate; its bound uses the
card's instruction-rate limit, 33.5 T instructions/s (4 warp instructions
per SM and clock, the same 128 lanes that give 67 TFLOP/s of float32 at 2
flop each), over the least number of instructions the function needs on
32-bit words (not the number the kernel's 16-bit limbs spend). The deal
kernel does both kinds of work (the sampler on the CUDA cores, the encode
dot on the tensor cores); its operation time is the larger of the two. The
packed finish functions are counted like the sampler; both come out bound
by their bytes. So are the robust open's elementwise multiply and CIOS
matmul (on 8 words of 32 bits) and the MXU epilogues (on the reference's
16-bit carry-save limbs); the folded MXU kernel's int8 dot is counted as
the scheme runs it (37 x 37 digit products per operand and output). The
three-kernel open's dots are counted like the direct open's (32 diagonals
x 32k digits per lane and column), K3 decoding once; the flat finish like
the 4D one.
"""

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from honeybadgermpc_tpu_torch import _build  # noqa: E402
from honeybadgermpc_tpu_torch.ops import band_matmul as bm  # noqa: E402
from honeybadgermpc_tpu_torch.ops import field_kernels as fk  # noqa: E402
from honeybadgermpc_tpu_torch.ops import fused_open as fo  # noqa: E402
from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod  # noqa: E402
from honeybadgermpc_tpu_torch.ops import fused_randousha as fr  # noqa: E402
from honeybadgermpc_tpu_torch.ops import montgomery as mont  # noqa: E402
from honeybadgermpc_tpu_torch.ops import mxu_matmul as mxu  # noqa: E402
from honeybadgermpc_tpu_torch.ops.fparray import (  # noqa: E402
    FpArray, dev_const)
from honeybadgermpc_tpu_torch.ops.fpmatmul import (  # noqa: E402
    _decode_validate_np, _lagrange_matrix_np, _matmul_kernel,
    _vandermonde_int_rows)
from honeybadgermpc_tpu_torch.ops.fused_open import (  # noqa: E402
    PL, _lam_int, pack_limbs, unpack_limbs)
from honeybadgermpc_tpu_torch.ops.limbs import L, P, R_MOD_P  # noqa: E402
from honeybadgermpc_tpu_torch.parallel import \
    reconstruct as rec  # noqa: E402
from honeybadgermpc_tpu_torch.parallel.mesh import SimBackend  # noqa: E402
from honeybadgermpc_tpu_torch.parallel.reconstruct import \
    _sim_reconstruct_packed_jit  # noqa: E402
from honeybadgermpc_tpu_torch.runtime.offline import \
    sim_offline_jit  # noqa: E402
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements  # noqa: E402

N, T = 64, 21
K = T + 1
C = 768
SEG = K * C                       # 16896 sharings per segment
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 67e12 / 2     # 128 lanes x 1 instruction
# Least 32-bit integer instructions per sampled element, for the function
# and not for the limb width csrc/rand_limbs.cu chose: on 32-bit words with
# multiply-add-with-carry, counting what the hardware can fuse (three-input
# adds and logic) as one. 6 Threefry calls x (20 rounds x (add, rotate,
# xor) + 2 + 5 x 2 key adds) give the 12 words; REDC by 2^-144 is four
# 32-bit rounds and one 16-bit round x (m + 8 x (low, high half
# multiply-add) + 2 for the carry out); 8 funnel shifts realign the odd 16
# bits; conditional subtract 8 + 8; 16 for the 16-bit limbs of the output.
RAND_OPS_PER_ELEMENT = 6 * (20 * 3 + 2 + 10) + 5 * (1 + 8 * 2 + 2) + 8 \
    + 16 + 16
KT = 4096                         # slots of one triple call
N_OUT = N - 2 * T                 # 22 extracted sharings per slot
N_OUTP = -(-N_OUT // 8) * 8       # 24 rows of the padded keep tensor
# Least 32-bit integer instructions per element of the packed finish
# functions, same counting: the operands arrive as 8 words of 32 bits, so
# nothing is unpacked. mul_add: a 256-bit Montgomery product is 8 x 8 x
# (low, high half multiply-add) for the product and as many for the
# reduction, plus 8 for m and 8 x 2 carries out; its conditional subtract
# 8 + 8; the add 8 and its conditional subtract 8 + 8. sub_bcast: borrow
# chain 8, add-back chain 8, select 8. (csrc/packed_arith.cu works on
# 16-bit limbs and spends about eight times as many; that is the kernel's
# choice, not the function's need.)
MUL_ADD_OPS_PER_ELEMENT = 2 * (8 * 8 * 2) + 8 + 16 + 16 + 8 + 16
SUB_BCAST_OPS_PER_ELEMENT = 8 + 8 + 8
OPEN_PATH_KERNELS = ("open_direct", "band_matmul", "rand_limbs")
# kernel name -> (module, name of its launch counter there)
KERNEL_COUNTERS = {
    "open_direct": (fod, "launches"),
    "band_matmul": (bm, "launches"),
    "rand_limbs": (fk, "launches"),
    "randousha_deal": (fr, "launches_deal"),
    "randousha_extract": (fr, "launches_extract"),
    "mul_add_packed4": (fk, "launches_mul_add4"),
    "sub_bcast_packed4": (fk, "launches_sub_bcast4"),
    "mont_mul": (fk, "launches_mont_mul"),
    "fp_matmul_cios": (fk, "launches_matmul"),
    "mxu_fused2": (mxu, "launches_fused2"),
    "mxu_fused": (mxu, "launches_fused"),
    "mxu_redc": (mxu, "launches_redc"),
    "open_fused_k1": (fo, "launches_k1"),
    "open_fused_k2": (fo, "launches_k2"),
    "open_fused_k3": (fo, "launches_k3"),
    "mul_add_packed": (fk, "launches_mul_add"),
}
# plain versions run on CUDA tensors (module, counter): the card's paths
# must leave them at 0; only the comparisons with the kernels move them
PLAIN_COUNTERS = {
    "mont_mul_plain": (mont, "plain_calls_on_cuda"),
    "mxu_matmul_plain": (mxu, "plain_calls_on_cuda"),
    "open_fused_plain": (fo, "plain_calls_on_cuda"),
    "open_direct_plain": (fod, "plain_calls_on_cuda"),
}
# Least 32-bit integer instructions per Montgomery product on 8 words of 32
# bits, counted as for MUL_ADD_OPS_PER_ELEMENT without its add: 8 x 8 x
# (low, high half multiply-add) for the product and as many for the
# reduction, 8 for m, 8 x 2 carries out, conditional subtract 8 + 8. A
# modular add is 8 + 8 + 8.
MONT_MUL_OPS = 2 * (8 * 8 * 2) + 8 + 16 + 16
ADD_MOD_OPS = 24
# Least integer instructions per output element of the MXU epilogues on
# 16-bit carry-save limbs (the reference's own fold): each diagonal pair
# costs an add and a shift, its three chunks 6 operations and 3 adds; a
# REDC round is m (2) + 16 multiply-adds split into low and high halves
# (48) + the shift (2); the carry chain 3 x 16; a conditional subtract
# 3 x 16 + 16 selects.
FOLD37_OPS_BASE = 19 * 11 + 48 + 2 * 64       # + 52 per REDC round
REDC73_OPS = 37 * 11 + 17 * 52 + 48 + 64
BAD_PARTIES = tuple(range(0, 3 * T, 3))     # 21 parties, both sides of k
PROGRAMS = ("randousha", "generate_triples", "generate_bits")
# chunk counts of the eager randousha's check opens at k = 4096 slots:
# 4096 * 2t = 172,032 columns per party, padded to a multiple of t+1 = 22
# (7820 chunks) and of 2t+1 = 43 (4001 chunks)
C_T = -(-KT * 2 * T // K)
C_2T = -(-KT * 2 * T // (2 * T + 1))
FAULT_KT = 16                     # slots of the in-program fault case


def say(phase, **rec):
    print(json.dumps({"phase": phase, **rec}), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps):
    """Mean device time of fn() over `reps` calls (CUDA events, warm)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, kernel_name):
    """Mean device time of one launch of the CUDA kernel `kernel_name`
    over `reps` calls of fn() (one launch each), from the profiler's device
    trace (so host time between launches does not count): the mean over
    the launches the trace holds. The profiler may drop events, and the
    result must not depend on it: where the trace holds fewer than half of
    the launches, CUDA events around the `reps` calls instead (which count
    host time between launches only where the kernel is shorter than it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    if total_us <= 0.0 or 2 * count < reps:
        return time_ms(fn, reps), f"cuda_events (trace held {count} " \
            f"of {reps} launches)"
    return total_us / count / 1e3, f"profiler ({count} of {reps} launches)"


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def timed_once(fn):
    """Device time in ms of one call of fn() (CUDA events). The caller has
    run fn() before, so the allocator is warm."""
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    sync()
    return start.elapsed_time(end)


def reset_launches():
    for mod, attr in list(KERNEL_COUNTERS.values()) + \
            list(PLAIN_COUNTERS.values()):
        setattr(mod, attr, 0)


def read_launches():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def read_plain():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in PLAIN_COUNTERS.items()}


# -- bounds ------------------------------------------------------------------

def bound(nbytes, ops, ops_per_s):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def open_bound(n, k, b):
    nv = n - k
    nbytes = 4 * PL * n * b + (nv + 1) * 8 * k * 128 + 4 * PL * b + 4 * nv
    ops = 2 * (nv + 1) * 32 * 32 * k * b
    return bound(nbytes, ops, INT8_OPS_PER_S)


def band_bound(b, k, m):
    nbytes = 4 * PL * b * k + m * 8 * k * 128 + 4 * PL * b * m
    ops = 2 * m * 32 * 32 * k * b
    return bound(nbytes, ops, INT8_OPS_PER_S)


def rand_bound(numel):
    return bound(4 * L * numel, RAND_OPS_PER_ELEMENT * numel, INT32_OPS_PER_S)


def deal_bound(n, k, sp):
    """Writes the receive tensor, reads the band; the encode dot on the
    tensor cores and the sampler on the CUDA cores, whichever is longer."""
    b = n * sp
    nbytes = 4 * PL * n * b + n * 8 * k * 128
    dot_ms = 2 * n * 32 * 32 * k * b / INT8_OPS_PER_S * 1e3
    draw_ms = RAND_OPS_PER_ELEMENT * k * b / INT32_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(dot_ms, draw_ms)
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def extract_bound(n, n_out, n_outp, sp):
    b = n * sp
    nbytes = 4 * PL * b * (n + n_outp + 1) + (n_out + 1) * 8 * n * 128
    ops = 2 * (n_out + 1) * 32 * 32 * n * b
    return bound(nbytes, ops, INT8_OPS_PER_S)


def mul_add_bound(numel):
    return bound(4 * 4 * PL * numel, MUL_ADD_OPS_PER_ELEMENT * numel,
                 INT32_OPS_PER_S)


def sub_bcast_bound(numel, n):
    return bound(4 * PL * (2 * numel + numel // n),
                 SUB_BCAST_OPS_PER_ELEMENT * numel, INT32_OPS_PER_S)


# -- phase 3: kernels against their plain versions ---------------------------

def deal_packed(dev, n, deg, b, key):
    """Packed shares [PL, n, b] of b random degree-`deg` sharings, dealt
    with the band matmul kernel (b a multiple of deg+1)."""
    k = deg + 1
    coeffs = pack_limbs(fk.rand_limbs(key, b * k, dev).reshape(L, b, k))
    mat = _vandermonde_int_rows(tuple(range(1, n + 1)), k)
    return bm.band_matmul_packed(coeffs, mat).permute(0, 2, 1).contiguous()


def compare_rand(dev, numel):
    got = fk.rand_limbs((11, 12), numel, dev)
    want = fk._rand_limbs_plain((11, 12), numel, dev)
    sync()
    check(torch.equal(got, want), f"rand_limbs != plain at numel={numel}")
    return max_abs_err(got, want)


def compare_band(dev, b, k, m):
    a = pack_limbs(fk.rand_limbs((21, k), b * k, dev).reshape(L, b, k))
    mat = _vandermonde_int_rows(tuple(range(1, m + 1)), k)
    got = bm.band_matmul_packed(a, mat)
    want = bm._band_matmul_plain(a, mat)
    sync()
    check(torch.equal(got, want), f"band_matmul != plain at {(b, k, m)}")
    return max_abs_err(got, want), a, mat


def compare_open(dev, n, t, b):
    """Honest and faulted shares through kernel and plain version."""
    k = t + 1
    pts = tuple(range(1, n + 1))
    shares = deal_packed(dev, n, t, b, (31, n))
    worst = 0
    for faulted in (False, True):
        x = shares
        if faulted:
            x = shares.clone()
            x[3, n - 1, b // 2] ^= 0x2482          # a validating party
            x[0, 0, b - 1] ^= 1                    # an interpolating party
        sec, errs = fod._open_direct_cuda(x, n, k, pts)
        sec_p, errs_p = fod._open_direct_plain(x, n, k, pts)
        sync()
        check(torch.equal(sec, sec_p) and torch.equal(errs, errs_p),
              f"open_direct != plain at n={n} t={t} B={b} faulted={faulted}")
        check((int(errs.sum()) > 0) == faulted,
              f"open_direct verdict wrong at n={n} t={t} faulted={faulted}")
        worst = max(worst, max_abs_err(sec, sec_p), max_abs_err(errs, errs_p))
    return worst, shares, pts


def phase_kernels(dev):
    t0 = time.perf_counter()
    err = {"open_direct": 0, "band_matmul": 0, "rand_limbs": 0}
    shapes = []
    for numel in (5000, 77, SEG, SEG * T):
        err["rand_limbs"] = max(err["rand_limbs"], compare_rand(dev, numel))
        shapes.append(f"rand_limbs numel={numel}")
    for b, k, m in ((50, 3, 8), (33, 3, 7), (SEG, K, N)):
        e, a_main, mat_main = compare_band(dev, b, k, m)
        err["band_matmul"] = max(err["band_matmul"], e)
        shapes.append(f"band_matmul B={b} k={k} m={m}")
    # small, unaligned, main-path, and the degree-2t open (k = 43)
    for n, t, b in ((8, 2, 48), (7, 2, 33), (N, 2 * T, 43 * 392),
                    (N, T, SEG)):
        e, shares_main, pts = compare_open(dev, n, t, b)
        err["open_direct"] = max(err["open_direct"], e)
        shapes.append(f"open_direct n={n} k={t + 1} B={b}")

    # times at the main-path shapes (the band dots are far from the memory
    # bound, so a warm L2 does not flatter them; the open is also timed over
    # 64 distinct segments in phase 7)
    times = {
        "open_direct": (
            kernel_ms(lambda: fod._open_direct_cuda(shares_main, N, K, pts),
                      20, "open_direct_kernel"),
            time_ms(lambda: fod._open_direct_plain(shares_main, N, K, pts), 3),
            open_bound(N, K, SEG)),
        "band_matmul": (
            kernel_ms(lambda: bm.band_matmul_packed(a_main, mat_main), 20,
                      "band_matmul_kernel"),
            time_ms(lambda: bm._band_matmul_plain(a_main, mat_main), 3),
            band_bound(SEG, K, N)),
        "rand_limbs": (
            kernel_ms(lambda: fk.rand_limbs((1, 2), SEG * T, dev), 50,
                      "rand_limbs_kernel"),
            time_ms(lambda: fk._rand_limbs_plain((1, 2), SEG * T, dev), 3),
            rand_bound(SEG * T)),
    }
    say("kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


# -- phases 4-7: the main path -----------------------------------------------

def deal_segments(pre, nseg):
    segs = []
    for _ in range(nseg):
        pre.generate_rands(SEG)
        segs.append(pack_limbs(pre.get_rands(SEG).limbs))
    return segs


def mont_ints(packed_cols):
    """Packed words [PL, ...] on the card -> Python ints (still in
    Montgomery form; Lagrange interpolation is linear, so the oracle works
    on Montgomery-form values directly)."""
    limbs = unpack_limbs(packed_cols).cpu().numpy().astype("int64")
    flat = limbs.reshape(L, -1)
    vals = [sum(int(flat[j, i]) << (16 * j) for j in range(L))
            for i in range(flat.shape[1])]
    return vals, limbs.shape[1:]


def oracle_check(seg, sec, cols):
    """Opened secrets at `cols` against Python-int Lagrange interpolation
    at 0, once from the first K parties and once from the last K parties
    (which the kernel never interpolates from)."""
    idx = torch.tensor(cols, device=seg.device)
    shares, _ = mont_ints(seg[:, :, idx])                 # [n, len(cols)]
    opened, _ = mont_ints(sec[:, idx])
    for parties in (range(K), range(N - K, N)):
        lam = _lam_int([j + 1 for j in parties], 0)
        for ci in range(len(cols)):
            want = sum(l * shares[j * len(cols) + ci]
                       for l, j in zip(lam, parties)) % P
            check(opened[ci] == want, f"opened secret != oracle at column "
                                      f"{cols[ci]} from parties {parties}")


def phase_main(dev, nseg, reps):
    run = _sim_reconstruct_packed_jit(N, T, False, True, fallback=False,
                                      replicate=False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pre = PreProcessedElements(N, T, seed=0)
    segs = deal_segments(pre, nseg)
    sync()
    deal_s = time.perf_counter() - t0
    outs = [run(s) for s in segs]
    sync()
    launches = read_launches()
    total_s = time.perf_counter() - t0

    nerr = sum(int(o[1].sum()) for o in outs)
    check(nerr == 0, f"main path: nerr = {nerr} on honest shares")
    for name in OPEN_PATH_KERNELS:
        check(launches[name] > 0,
              f"main path never launched the {name} kernel")
    check(launches["open_direct"] == nseg, "one open launch per segment")
    for sec, ne in outs:
        check(tuple(sec.shape) == (PL, SEG) and sec.dtype == torch.int32
              and tuple(ne.shape) == (N,), "opened shapes")
    cols = [0, 1, C - 1, C, SEG // 2 + 5, SEG - 1]
    for si in sorted({0, nseg // 2, nseg - 1}):
        oracle_check(segs[si], outs[si][0], cols)
    check(not torch.equal(outs[0][0], outs[-1][0]) or nseg == 1,
          "segments must hold different secrets")
    say("main_path", ok=True, n=N, t=T, segments=nseg, sharings=nseg * SEG,
        packed_share_bytes=sum(s.numel() * 4 for s in segs),
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, nerr=nerr,
        oracle_columns_checked=len(cols) * len({0, nseg // 2, nseg - 1}),
        seconds=round(total_s, 3))

    # phase 5: fault detection
    seg = segs[nseg // 2]
    bad = seg.clone()
    z = K + 7
    bad[5, z, 1234] ^= 0x10
    _, ne = run(bad)
    check(int(ne[z]) > 0 and int(ne.sum()) == int(ne[z]),
          f"fault at party {z} not charged to it: {ne.tolist()}")
    bad = seg.clone()
    bad[2, 3, 99] ^= 0x4000
    _, ne2 = run(bad)
    check(int(ne2.sum()) > 0 and int(ne2[:K].sum()) == 0,
          "fault at an interpolating party not detected")
    say("fault_detection", ok=True, party=z, nerr_at_party=int(ne[z]),
        nerr_sum_interpolating_fault=int(ne2.sum()))

    # phase 6: state across save/load
    pre.generate_rands(SEG)
    tmp = tempfile.mkdtemp(prefix="hbmpc_smoke_")
    try:
        pre.save(tmp)
        fresh = PreProcessedElements(N, T, seed=123)
        fresh.load(tmp)
        saved_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                          for f in os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a = pack_limbs(pre.get_rands(SEG).limbs)
    b = pack_limbs(fresh.get_rands(SEG).limbs)
    (sa, ea), (sb, eb) = run(a), run(b)
    check(torch.equal(a, b) and torch.equal(sa, sb) and int(ea.sum()) == 0
          and int(eb.sum()) == 0, "state across save/load differs")
    say("state_across", ok=True, saved_bytes=saved_bytes)

    # phase 7: timing over the resident segments (cold L2: 2.2 GB of input)
    for s in segs:
        run(s)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        for s in segs:
            run(s)
    sync()
    open_s = (time.perf_counter() - t0) / reps
    # the dealer again, warm: the first pass above also grew the allocator
    nwarm = min(nseg, 8)
    deal_segments(pre, nwarm)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        deal_segments(pre, nwarm)
    sync()
    warm_s = (time.perf_counter() - t0) / reps
    return launches, {"opened_sharings_per_s": nseg * SEG / open_s,
                      "open_ms_per_segment": open_s / nseg * 1e3,
                      "dealt_sharings_per_s": nwarm * SEG / warm_s,
                      "dealt_party_shares_per_s": nwarm * SEG * N / warm_s,
                      "deal_ms_per_segment": warm_s / nwarm * 1e3,
                      "first_pass_deal_ms_per_segment": deal_s / nseg * 1e3,
                      "timed_repeats": reps}


# -- offline path: the four kernels against their plain versions -------------

def deal_plain_full(key, n, t, degree, sp, pts, dev, window=512):
    """The deal's plain version over all sp slots, `window` slots at a time
    (its int64 dot intermediates at 64 x 4096 lanes would take gigabytes)."""
    parts = [fr._randousha_deal_plain(key, n, t, degree, sp, pts, dev,
                                      slot0=s0,
                                      nslot=min(window, sp - s0))
             for s0 in range(0, sp, window)]
    return torch.cat(parts, dim=-1)


def compare_deal(dev, n, t, degree, sp, key):
    pts = fr._party_points(n)
    got = fr.randousha_deal(key, n, t, degree, sp, pts, dev)
    want = deal_plain_full(key, n, t, degree, sp, pts, dev)
    sync()
    check(torch.equal(got, want),
          f"randousha_deal != plain at n={n} t={t} degree={degree} sp={sp}")
    return max_abs_err(got, want), got, pts


def compare_extract(dev, n, t, sp, key, cols):
    run = fr._randousha_calls(n, t, sp, fr._party_points(n), device=dev)
    n_out, n_outp = run.meta[:2]
    band = run.folded_band(key)[0]
    keep, z = fr.randousha_extract(cols, band, n_out, n_outp)
    keep_p, z_p = fr._randousha_extract_plain(cols, band, n_out, n_outp)
    sync()
    check(torch.equal(keep, keep_p) and torch.equal(z, z_p),
          f"randousha_extract != plain at n={n} t={t} sp={sp}")
    check(torch.equal(keep[:, :, n_out], z)
          and not bool(keep[:, :, n_out + 1:].any()),
          "extract: row n_out must be the check sharing, rows above zero")
    return max(max_abs_err(keep, keep_p), max_abs_err(z, z_p)), keep, z, band


def compare_finish(dev, a, b, c, pad):
    """mul_add_packed4 (4D and padded flat form) and sub_bcast_packed4 (its
    minuend a prefix view of a longer tensor) against their plain versions."""
    _, n, r, s_ = a.shape
    got = fk.mul_add_packed4(a, b, c)
    want = fk._mul_add_packed4_plain(a, b, c)
    flat = fk.mul_add_packed4_flat(a, b, c, pad=pad)
    sync()
    check(torch.equal(got, want), f"mul_add_packed4 != plain at {a.shape}")
    check(torch.equal(flat[:, :, :r * s_], want.reshape(PL, n, r * s_))
          and not bool(flat[:, :, r * s_:].any()),
          f"mul_add_packed4 padded form wrong at {a.shape} pad={pad}")
    err_ma = max_abs_err(got, want)
    long = torch.cat([got[:, 0].reshape(PL, r * s_),
                      got[:, 0].reshape(PL, r * s_)[:, :pad + 3]], dim=-1)
    minuend = long[:, :r * s_].reshape(PL, r, s_)     # planes lie apart
    got2 = fk.sub_bcast_packed4(minuend, b)
    want2 = fk._sub_bcast_packed4_plain(minuend, b)
    sync()
    check(torch.equal(got2, want2), f"sub_bcast_packed4 != plain at {b.shape}")
    return err_ma, max_abs_err(got2, want2), minuend


def phase_kernels_offline(dev):
    t0 = time.perf_counter()
    err = {"randousha_deal": 0, "randousha_extract": 0,
           "mul_add_packed4": 0, "sub_bcast_packed4": 0}
    shapes = []
    # small: n=8, t=2, one slot tile; values < p in every limb pattern come
    # from the deal itself
    for degree in (2, 4):
        e, cols_s, _ = compare_deal(dev, 8, 2, degree, 128, (5, 6))
        err["randousha_deal"] = max(err["randousha_deal"], e)
        shapes.append(f"randousha_deal n=8 t=2 degree={degree} sp=128")
        e, keep_s, _, _ = compare_extract(dev, 8, 2, 128, (5, 6), cols_s)
        err["randousha_extract"] = max(err["randousha_extract"], e)
        shapes.append(f"randousha_extract n=8 t=2 sp=128 (degree {degree})")
    sm = keep_s[:, :3, :5, :77].contiguous()           # unaligned [8,3,5,77]
    e1, e2, _ = compare_finish(dev, sm, sm.flip(3), sm.flip(2), 7)
    err["mul_add_packed4"], err["sub_bcast_packed4"] = e1, e2
    shapes.append("mul_add_packed4, sub_bcast_packed4 [8,3,5,77]")

    # main-path width: n=64, t=21, all 4096 slots, both degrees
    key = (41, 42)
    e, cols_t, pts = compare_deal(dev, N, T, T, KT, key)
    err["randousha_deal"] = max(err["randousha_deal"], e)
    e, keep_t, _, band = compare_extract(dev, N, T, KT, key, cols_t)
    err["randousha_extract"] = max(err["randousha_extract"], e)
    e, cols_2t, _ = compare_deal(dev, N, T, 2 * T, KT, key)
    err["randousha_deal"] = max(err["randousha_deal"], e)
    check(not torch.equal(cols_t, cols_2t), "the two degrees must differ")
    e, keep_2t, _, _ = compare_extract(dev, N, T, KT, key, cols_2t)
    err["randousha_extract"] = max(err["randousha_extract"], e)
    shapes += [f"randousha_deal n={N} t={T} degree={d} sp={KT} (all slots)"
               for d in (T, 2 * T)]
    shapes.append(f"randousha_extract n={N} t={T} sp={KT} (both degrees)")
    del cols_2t
    keep_b = keep_t.roll(1, dims=3)                    # a second operand
    pad = (-N_OUTP * KT) % (2 * T + 1)
    e1, e2, minuend = compare_finish(dev, keep_t, keep_b, keep_2t, pad)
    err["mul_add_packed4"] = max(err["mul_add_packed4"], e1)
    err["sub_bcast_packed4"] = max(err["sub_bcast_packed4"], e2)
    shapes.append(f"mul_add_packed4, sub_bcast_packed4 [8,{N},{N_OUTP},{KT}]"
                  f" pad={pad}")

    n_out, n_outp = N_OUT, N_OUTP
    numel = N * N_OUTP * KT
    times = {}
    for name, degree in (("randousha_deal", T),
                         ("randousha_deal_2t", 2 * T)):
        times[name] = (
            kernel_ms(lambda d=degree: fr.randousha_deal(key, N, T, d, KT,
                                                         pts, dev),
                      10, "randousha_deal_kernel"),
            timed_once(lambda d=degree: deal_plain_full(key, N, T, d, KT,
                                                        pts, dev)),
            deal_bound(N, degree + 1, KT))
    times["randousha_extract"] = (
        kernel_ms(lambda: fr.randousha_extract(cols_t, band, n_out, n_outp),
                  10, "randousha_extract_kernel"),
        timed_once(lambda: fr._randousha_extract_plain(cols_t, band, n_out,
                                                       n_outp)),
        extract_bound(N, n_out, n_outp, KT))
    times["mul_add_packed4"] = (
        kernel_ms(lambda: fk.mul_add_packed4_flat(keep_t, keep_b, keep_2t,
                                                  pad=pad),
                  10, "mul_add_packed4_kernel"),
        timed_once(lambda: fk._mul_add_packed4_plain(keep_t, keep_b,
                                                     keep_2t)),
        mul_add_bound(numel))
    times["sub_bcast_packed4"] = (
        kernel_ms(lambda: fk.sub_bcast_packed4(minuend, keep_t), 10,
                  "sub_bcast_packed4_kernel"),
        timed_once(lambda: fk._sub_bcast_packed4_plain(minuend, keep_t)),
        sub_bcast_bound(numel, N))
    say("offline_kernels_vs_plain", ok=True,
        tolerance="exact (torch.equal)", shapes=shapes,
        timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


# -- phases 8-10: verified Beaver triples ------------------------------------

def open_rows(run, p4):
    """Open a packed 4D share tensor [PL, n, R, S] at degree t -> (opened
    [PL, R, S], nerr [n]); the column count is padded to a multiple of
    t+1 with zero sharings."""
    _, n, r, s_ = p4.shape
    flat = p4.reshape(PL, n, r * s_)
    pad = (-r * s_) % K
    if pad:
        flat = torch.cat([flat, flat.new_zeros((PL, n, pad))], dim=-1)
    sec, nerr = run(flat)
    return sec[:, :r * s_].reshape(PL, r, s_), nerr


def plain_int(packed_word_col):
    """One packed element [PL] on the card -> its plain residue (out of
    Montgomery form) as a Python int."""
    limbs = unpack_limbs(packed_word_col.reshape(PL, 1)).cpu().tolist()
    v = sum(int(limbs[j][0]) << (16 * j) for j in range(L))
    return v * pow(R_MOD_P, P - 2, P) % P


def flip_word(degree_hit):
    def tamper(cols, degree):
        if degree == degree_hit:
            cols[3, 5, 7, KT // 4 + 1] ^= 0x10   # dealer 7's share for party 5
        return cols
    return tamper


def stage_times(fn, reps):
    """Device time per call of every stage of fn(i), from the profiler's
    device trace: the port's kernels by name, everything else (PyTorch's
    own elementwise and copy kernels) as 'other'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = ("randousha_deal_kernel", "randousha_extract_kernel",
             "open_direct_kernel", "mul_add_packed4_kernel",
             "sub_bcast_packed4_kernel", "mont_mul_kernel")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        sync()
    out = {nm: 0.0 for nm in names}
    out["other"] = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0))
        hit = [nm for nm in names if nm in ev.key]
        out[hit[0] if hit else "other"] += us
    return {k.replace("_kernel", "") + "_ms": v / reps / 1e3
            for k, v in out.items()}


def phase_triples(dev, reps):
    fn = sim_offline_jit("generate_triples_packed", N, T, KT)
    run = _sim_reconstruct_packed_jit(N, T, False, True, fallback=False,
                                      replicate=False)
    fn((2026, 0))                     # builds the bands and launchers
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pa, pb, pab, ok = fn((2026, 1))
    sync()
    launches = read_launches()
    call_s = time.perf_counter() - t0

    check(bool(ok), "triple call: ok is false on an honest run")
    want = {"randousha_deal": 4, "randousha_extract": 4,
            "mul_add_packed4": 1, "sub_bcast_packed4": 1, "open_direct": 5,
            "mont_mul": 6}                 # two per folded_band
    for name, count in want.items():
        check(launches[name] == count,
              f"triple call launched {name} {launches[name]} times, "
              f"expected {count}")
    for x in (pa, pb, pab):
        check(tuple(x.shape) == (PL, N, N_OUTP, KT)
              and x.dtype == torch.int32 and x.is_cuda, "triple shapes")
    nerr = 0
    opened = []
    for x in (pa, pb, pab):
        sec, ne = open_rows(run, x)
        nerr += int(ne.sum())
        opened.append(sec[:, :N_OUT].contiguous())     # real triples only
    check(nerr == 0, f"opening a, b, ab at degree t: nerr = {nerr}")
    a, b, ab = opened                                  # [PL, 22, 4096]
    # Montgomery form: mont_mul(aR, bR) = abR, so the product check needs
    # no conversion
    prod = pack_limbs(mont.mont_mul(unpack_limbs(a), unpack_limbs(b)))
    nbad = int((prod != ab).any(dim=0).sum())
    ntrip = N_OUT * KT
    check(nbad == 0, f"ab != a*b for {nbad} of {ntrip} triples")
    check(a.reshape(PL, -1).unique(dim=1).shape[1] == ntrip,
          "the a secrets must be distinct")
    sample = [(0, 0), (0, 1), (N_OUT // 3, KT // 2 - 1),
              (N_OUT - 1, KT - 1), (N_OUT // 2, KT // 32)]
    for r, c in sample:
        ai, bi, abi = (plain_int(x[:, r, c]) for x in (a, b, ab))
        check(abi == ai * bi % P, f"Python ints: ab != a*b at {(r, c)}")
    say("triples", ok=True, n=N, t=T, k=KT, triples=ntrip,
        padding_rows_excluded=N_OUTP - N_OUT, launches=launches, nerr=nerr,
        product_mismatches=nbad, python_int_samples=len(sample),
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        first_call_seconds=round(call_s, 4))
    del pa, pb, pab, opened, prod

    # phase 9: a flipped word between deal and extract flips ok
    verdicts = {}
    for name, hit in (("honest", None), ("degree_t", T),
                      ("degree_2t", 2 * T)):
        *_, okf = fr.sim_randousha_fused((7, 7), N, T, KT, padded=True,
                                         tamper=flip_word(hit))
        verdicts[name] = bool(okf)
    check(verdicts == {"honest": True, "degree_t": False,
                       "degree_2t": False},
          f"fault verdicts wrong: {verdicts}")
    _, okf = fr.sim_ransha_fused((7, 8), N, T, KT, padded=True,
                                 tamper=flip_word(T))
    check(not bool(okf), "RanSha did not detect the flipped word")
    say("triple_fault_detection", ok=True, ok_flags=verdicts,
        ransha_ok_flag=bool(okf))

    # phase 10: timing (a new key every call)
    for i in range(2):
        fn((2027, i))
    sync()
    t0 = time.perf_counter()
    for i in range(reps):
        out = fn((2028, i))
    sync()
    dt = (time.perf_counter() - t0) / reps
    check(bool(out[3]), "timed triple call: ok is false")
    stages = stage_times(lambda i: fn((2029, i)), min(reps, 5))
    # the per-run extraction band alone (plain tensor code, three per call):
    # host clock around calls that end in a synchronize
    fold = fr._randousha_calls(N, T, KT, fr._party_points(N),
                               device=dev).folded_band
    fold((2030, 0))
    sync()
    t0 = time.perf_counter()
    for i in range(5):
        fold((2031, i))
    sync()
    band_ms = (time.perf_counter() - t0) / 5 * 1e3
    return launches, {"triples_per_s": ntrip / dt, "ms_per_call": dt * 1e3,
                      "triples_per_call": ntrip, "timed_calls": reps,
                      "device_ms_per_call_by_stage": stages,
                      "device_busy_ms_per_call": sum(stages.values()),
                      "folded_band_ms_each": band_ms,
                      "folded_bands_per_call": 3}


# -- the robust open: four kernels against their plain versions -------------

def mont_limbs_ints(limbs):
    """int32 limbs [L, ...] on the card -> flat list of Python ints (the
    Montgomery representatives)."""
    x = limbs.reshape(L, -1).cpu().numpy().astype("int64")
    return [sum(int(x[j, i]) << (16 * j) for j in range(L))
            for i in range(x.shape[1])]


def matmul_oracle(a, v, rows, cols):
    """Python-int a @ v in Montgomery form at the given (row, column) pairs
    of a[L, B, k] @ v[L, k, n]."""
    k, n = v.shape[1], v.shape[2]
    rinv = pow(R_MOD_P, P - 2, P)
    vv = mont_limbs_ints(v)
    out = []
    for b, c in zip(rows, cols):
        aa = mont_limbs_ints(a[:, b])
        acc = sum(aa[j] * vv[j * n + c] for j in range(k))
        out.append(acc * rinv % P)
    return out


def check_oracle(got, a, v, what):
    """A sample of got [L, B, n] against matmul_oracle."""
    B, n = got.shape[1], got.shape[2]
    rows = [0, 1, B // 2, B - 1, B // 3]
    cols = [0, n - 1, n // 2, 1, n // 3]
    want = matmul_oracle(a, v, rows, cols)
    have = [mont_limbs_ints(got[:, b, c])[0] for b, c in zip(rows, cols)]
    check(have == want, f"{what}: kernel != Python-int oracle")


def rand_field(dev, key, shape):
    n = 1
    for d in shape:
        n *= d
    return fk.rand_limbs(key, n, dev).reshape((L,) + tuple(shape))


def mont_mul_bound(numel):
    return bound(3 * 64 * numel, MONT_MUL_OPS * numel, INT32_OPS_PER_S)


def cios_bound(b, k, n):
    return bound(64 * (b * k + k * n + b * n),
                 b * k * n * (MONT_MUL_OPS + ADD_MOD_OPS), INT32_OPS_PER_S)


def fused2_bound(b, k, n, rounds):
    """Reads a's limbs and the band, writes the limbs; the int8 dot of the
    folded scheme (37 diagonals x 37 digits x k per output) on the tensor
    cores and the fold on the CUDA cores, whichever is longer."""
    npl = mxu.NPLANES
    nbytes = 64 * b * k + n * npl * k * npl + 64 * b * n
    dot_ms = 2 * b * n * npl * npl * k / INT8_OPS_PER_S * 1e3
    fold_ms = (FOLD37_OPS_BASE + 52 * rounds) * b * n / INT32_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(dot_ms, fold_ms)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def redc_bound(m):
    return bound((73 * 4 + 64) * m, REDC73_OPS * m, INT32_OPS_PER_S)


def phase_kernels_robust(dev):
    """Rows 9, 12, 13 and 15 at the robust open's shapes, bit for bit
    against their plain versions on the card, a Python-int sample each,
    times and bounds."""
    t0 = time.perf_counter()
    pts = tuple(range(1, N + 1))
    err, shapes, times = {}, [], {}

    # row 9: the Gao EEA's [L, 2048, 65] and folded_band's [L, 42, 64]
    for shape in ((2048, N + 1), (2 * T, N)):
        a = rand_field(dev, (51, shape[0]), shape)
        b = rand_field(dev, (52, shape[1]), shape)
        got = fk.mont_mul_pallas(a, b)
        want = mont._mont_mul_plain(a, b)
        sync()
        check(torch.equal(got, want), f"mont_mul != plain at {shape}")
        for i in (0, 7, shape[1] * 3 + 1):
            ai = mont_limbs_ints(a.reshape(L, -1)[:, i])[0]
            bi = mont_limbs_ints(b.reshape(L, -1)[:, i])[0]
            gi = mont_limbs_ints(got.reshape(L, -1)[:, i])[0]
            check(gi == ai * bi * pow(R_MOD_P, P - 2, P) % P,
                  f"mont_mul != Python ints at {shape}")
        err["mont_mul"] = max(err.get("mont_mul", 0), max_abs_err(got, want))
        shapes.append(f"mont_mul [L,{shape[0]},{shape[1]}]")
    times["mont_mul_folded_band"] = (       # the last shape: [L, 42, 64]
        kernel_ms(lambda: fk.mont_mul_pallas(a, b), 50, "mont_mul_kernel"),
        timed_once(lambda: mont._mont_mul_plain(a, b)),
        mont_mul_bound(a[0].numel()))
    # three operand pairs (77 MB) in turn, so each launch finds its
    # operands outside the 50 MB L2
    pair_list = [(rand_field(dev, (53, i), (2048, N + 1)),
                  rand_field(dev, (54, i), (2048, N + 1))) for i in range(3)]
    a, b = pair_list[0]
    pairs = itertools.cycle(pair_list)
    times["mont_mul"] = (
        kernel_ms(lambda: fk.mont_mul_pallas(*next(pairs)), 50,
                  "mont_mul_kernel"),
        timed_once(lambda: mont._mont_mul_plain(a, b)),
        mont_mul_bound(a[0].numel()))

    # row 15: Gao's interpolation from all 64 shares, one 2048 segment
    a = rand_field(dev, (55, 1), (2048, N))
    lag = dev_const(_lagrange_matrix_np, (pts,), dev)          # [L, 64, 64]
    diag = mxu._mxu_diagonals(a, lag)
    got = mxu._redc_cuda(diag, N)
    want = mxu._redc_diagonals(diag)
    sync()
    check(torch.equal(got, want), "mxu_redc != plain at B=2048 k=64 n=64")
    check_oracle(got.reshape(L, 2048, N), a, lag, "mxu_redc")
    err["mxu_redc"] = max_abs_err(got, want)
    shapes.append(f"mxu_redc B=2048 k={N} n={N} (M={2048 * N})")
    ap = mxu._planes7(a).reshape(2048, N * mxu.NPLANES)
    vband = mxu._build_vband(lag)
    diags = itertools.cycle([diag, diag.roll(1, dims=1).contiguous()])
    times["mxu_redc"] = (          # two diagonal sets (92 MB) in turn
        kernel_ms(lambda: mxu._redc_cuda(next(diags), N), 50,
                  "mxu_redc_kernel"),
        timed_once(lambda: mxu._redc_diagonals(diag)),
        redc_bound(2048 * N))
    int_mm_ms = time_ms(lambda: mxu._dot_s8(ap, vband), 20)

    # row 13: decode_validate_matmul of the open's two rounds
    big = N * C                       # the decodes of one round
    for ncol, want_coeffs in ((N - K + 1, False), (N, True)):
        w = dev_const(_decode_validate_np, (pts, K, want_coeffs), dev)
        a = rand_field(dev, (56, ncol), (big, K))
        r = mxu._rounds_for(K)
        wd = mxu._folded_band_digits(w, r)
        got = mxu._fused2_cuda(a, wd, r)
        want = mxu._fused2_plain(a, wd, r)
        sync()
        check(torch.equal(got, want),
              f"mxu_fused2 != plain at B={big} k={K} n={ncol}")
        check_oracle(got, a, w, "mxu_fused2")
        err["mxu_fused2"] = max(err.get("mxu_fused2", 0),
                                max_abs_err(got, want))
        shapes.append(f"mxu_fused2 B={big} k={K} n={ncol}")
        key = "mxu_fused2" if ncol < N else f"mxu_fused2_n{N}"
        times[key] = (
            kernel_ms(lambda: mxu._fused2_cuda(a, wd, r), 20,
                      "Fold37"),
            timed_once(lambda: mxu._fused2_plain(a, wd, r)),
            fused2_bound(big, K, ncol, r))

    # row 12: robust_open_single's decode at n=64
    w = dev_const(_decode_validate_np, (pts, K, False), dev)      # [L,22,43]
    a = rand_field(dev, (57, 1), (N, K))
    got = fk.fp_matmul_pallas(a, w)
    want = _matmul_kernel(a, w, mul=mont._mont_mul_plain)
    sync()
    check(torch.equal(got, want), f"fp_matmul_cios != plain at B={N} k={K}")
    check_oracle(got, a, w, "fp_matmul_cios")
    err["fp_matmul_cios"] = max_abs_err(got, want)
    shapes.append(f"fp_matmul_cios B={N} k={K} n={N - K + 1}")
    times["fp_matmul_cios"] = (
        kernel_ms(lambda: fk.fp_matmul_pallas(a, w), 50,
                  "fp_matmul_cios_kernel"),
        timed_once(lambda: _matmul_kernel(a, w, mul=mont._mont_mul_plain)),
        cios_bound(N, K, N - K + 1))
    # small and unaligned shapes: odd batches, 2 REDC rounds (k > 27), the
    # folded kernel's 32-lane plan (k = 64), unpadded dot sides
    for shape in ((5,), (1500,)):
        a, b = rand_field(dev, (58, 1), shape), rand_field(dev, (59, 1), shape)
        check(torch.equal(fk.mont_mul_pallas(a, b),
                          mont._mont_mul_plain(a, b)),
              f"mont_mul != plain at {shape}")
        shapes.append(f"mont_mul {shape}")
    for bb, k, n in ((13, 5, 7), (1, 3, 1), (N, N, N)):
        a, v = rand_field(dev, (60, bb), (bb, k)), rand_field(dev, (61, n),
                                                               (k, n))
        check(torch.equal(fk.fp_matmul_pallas(a, v),
                          _matmul_kernel(a, v, mul=mont._mont_mul_plain)),
              f"fp_matmul_cios != plain at {(bb, k, n)}")
        shapes.append(f"fp_matmul_cios B={bb} k={k} n={n}")
    for bb, k, n in ((130, 31, 8), (300, N, 8), (256, K, N)):
        a, v = rand_field(dev, (62, bb), (bb, k)), rand_field(dev, (63, n),
                                                               (k, n))
        r = mxu._rounds_for(k)
        wd = mxu._folded_band_digits(v, r)
        got = mxu._fused2_cuda(a, wd, r)
        check(torch.equal(got, mxu._fused2_plain(a, wd, r)),
              f"mxu_fused2 != plain at {(bb, k, n)}")
        check_oracle(got, a, v, "mxu_fused2")
        shapes.append(f"mxu_fused2 B={bb} k={k} n={n}")
    for bb, k, n in ((256, 9, 12), (1030, 3, 2)):
        a, v = rand_field(dev, (64, bb), (bb, k)), rand_field(dev, (65, n),
                                                               (k, n))
        diag = mxu._mxu_diagonals(a, v)
        got = mxu._redc_cuda(diag, k)
        check(torch.equal(got, mxu._redc_diagonals(diag)),
              f"mxu_redc != plain at {(bb, k, n)}")
        check_oracle(got.reshape(L, bb, n), a, v, "mxu_redc")
        shapes.append(f"mxu_redc B={bb} k={k} n={n}")
    say("robust_kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, timed_by={k: v[0][1] for k, v in times.items()},
        int_mm_dot_ms=int_mm_ms, seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}, \
        int_mm_ms


def device_busy_ms(fn, top=0):
    """Device time of one call of fn(), summed over every CUDA kernel the
    profiler saw, and the number of kernel launches; with top > 0 also the
    `top` kernels by device time {name: ms}. A lower bound where the
    profiler drops events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    us, count, by_name = 0.0, 0, {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0.0))
        us += t
        count += ev.count
        by_name[ev.key[:60]] = by_name.get(ev.key[:60], 0.0) + t / 1e3
    if not top:
        return us / 1e3, count
    best = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return us / 1e3, count, dict(best)


def phase_robust_open(dev):
    """One 16896-sharing segment dealt by the port's dealer, opened honestly
    and then with 21 parties' shares replaced (parties on both sides of k):
    the two-phase sim_batch_reconstruct, batch_reconstruct with its Gao
    fallback, sim_open_direct_packed(robust=True), robust_open_single."""
    pre = PreProcessedElements(N, T, seed=77, device=dev)
    pre.generate_rands(SEG)
    shares = pre.get_rands(SEG)                           # [n, SEG]
    sync()
    reset_launches()

    # (a) honest: phase one only
    sec_a, nerr_a = rec.sim_batch_reconstruct(shares, N, T)
    sync()
    la = read_launches()
    check(int(nerr_a.sum()) == 0, "honest robust open: nerr != 0")
    check(la["mxu_redc"] == 0 and la["mont_mul"] == 0
          and la["mxu_fused2"] == 0 and la["fp_matmul_cios"] == 0,
          f"an honest open must launch no Gao: {la}")
    check(la["open_direct"] == 1, "honest open: one direct-open launch")
    check(tuple(sec_a.shape) == (N, SEG), "opened shapes")
    check(bool((sec_a.limbs == sec_a.limbs[:, :1]).all()),
          "every party must open the same secrets")
    oracle_check(pack_limbs(shares.limbs), pack_limbs(sec_a.limbs[:, 0]),
                 [0, 1, C, SEG // 2, SEG - 1])

    # (b) 21 faulty parties: phase one sees them, the redo corrects them
    faulty = rec.inject_share_faults(shares, SimBackend(N).my_ids(dev),
                                     BAD_PARTIES, (2026, 3))
    check(not torch.equal(faulty.limbs[:, 0], shares.limbs[:, 0])
          and torch.equal(faulty.limbs[:, 1], shares.limbs[:, 1]),
          "fault injection hit the wrong parties")
    _, nerr_p1 = rec._sim_reconstruct_jit(N, T, False, True, fallback=False)(
        faulty.limbs)
    check(int(nerr_p1.sum()) > 0, "phase one did not see the faults")
    sync()
    reset_launches()
    t0 = time.perf_counter()
    sec_b, nerr_b = rec.sim_batch_reconstruct(faulty, N, T)
    sync()
    redo_s = time.perf_counter() - t0
    lb = read_launches()
    want_nerr = C * len(BAD_PARTIES)
    check(torch.equal(sec_b.limbs, sec_a.limbs),
          "robust open: secrets differ from the honest open")
    check(nerr_b.tolist() == [want_nerr] * N,
          f"robust open: nerr {nerr_b.tolist()[:4]}..., want {want_nerr}")
    check(lb["mxu_redc"] > 0 and lb["mont_mul"] > 0,
          f"the redo did not go through Gao on the kernels: {lb}")

    # (c) the generic program and the direct open's robust branch
    t0 = time.perf_counter()
    sec_c, nerr_c = rec.batch_reconstruct(SimBackend(N), faulty, N, T)
    sync()
    br_s = time.perf_counter() - t0
    check(torch.equal(sec_c.limbs, sec_a.limbs)
          and nerr_c.tolist() == [want_nerr] * N,
          "batch_reconstruct disagrees with the robust open")
    pts = tuple(range(1, N + 1))
    sec_d, nerr_d = fod.sim_open_direct_packed(pack_limbs(faulty.limbs), N,
                                               T, pts, robust=True)
    sync()
    check(torch.equal(sec_d, pack_limbs(sec_a.limbs))
          and nerr_d.tolist() == [want_nerr] * N,
          "sim_open_direct_packed(robust=True) disagrees")

    # (d) one secret's 64 scalar shares, 21 of them wrong
    vals, errs = rec.robust_open_single(SimBackend(N), faulty[:, 0], N, T)
    sync()
    check(torch.equal(vals.limbs, sec_a.limbs[:, :, 0])
          and errs.tolist() == [len(BAD_PARTIES)] * N,
          f"robust_open_single: errs {errs.tolist()[:4]}...")
    launches = read_launches()
    plain = read_plain()
    check(all(v == 0 for v in plain.values()),
          f"plain versions ran on the card: {plain}")
    for name in ("mont_mul", "fp_matmul_cios", "mxu_fused2", "mxu_redc"):
        check(launches[name] > 0, f"the robust open never launched {name}")

    # (e) the three-kernel open: K1-K3 see the faults at every destination
    # (the direct open charges only the sources), and its fallback returns
    # the honest secrets with the per-destination counts
    packed_bad = pack_limbs(faulty.limbs)
    reset_launches()
    _, nerr_k = fo.sim_open_fused_packed(packed_bad, N, T, pts, robust=False)
    _, nerr_dir = fod.sim_open_direct_packed(packed_bad, N, T, pts)
    sync()
    check(all(v > 0 for v in nerr_k.tolist())
          and sum(nerr_dir.tolist()[:K]) == 0,
          f"three-kernel counts {nerr_k.tolist()[:4]}... must charge every "
          "destination")
    t0 = time.perf_counter()
    sec_e, nerr_e = _sim_reconstruct_packed_jit(
        N, T, False, True, fallback=True)(packed_bad)
    sync()
    fused_fallback_s = time.perf_counter() - t0
    le = read_launches()
    check(torch.equal(sec_e, pack_limbs(sec_a.limbs))
          and nerr_e.tolist() == [want_nerr] * N,
          "three-kernel open with fallback disagrees with the robust open")
    check(all(le[f"open_fused_k{s}"] == 2 for s in (1, 2, 3)),
          f"three-kernel open: K1-K3 launches {le}")
    del packed_bad

    # the redo's time: one Gao segment and the encode, on the device
    recv = rec._redo_encode_jit(N, False, K)(faulty.limbs.contiguous())
    seg = recv.reshape(L, N * C, N)[:, :rec._REDO_SEG].contiguous()
    gao = rec._redo_gao_jit(N, False, K)
    gao(seg)
    sync()
    t0 = time.perf_counter()
    gao(seg)
    sync()
    gao_seg_ms = (time.perf_counter() - t0) * 1e3
    seg_busy_ms, seg_kernels = device_busy_ms(lambda: gao(seg))
    enc_busy_ms, _ = device_busy_ms(
        lambda: rec._redo_encode_jit(N, False, K)(faulty.limbs.contiguous()))
    nseg = 2 * (-(-N * C // rec._REDO_SEG))
    say("robust_open", ok=True, n=N, t=T, sharings=SEG,
        bad_parties=len(BAD_PARTIES), nerr_per_party=want_nerr,
        launches_honest=la, launches_redo=lb,
        launches_all=launches, plain_calls_on_card=plain,
        batch_reconstruct_ms=br_s * 1e3,
        three_kernel_nerr_min=min(nerr_k.tolist()),
        three_kernel_fallback_ms=fused_fallback_s * 1e3)
    return launches, {
        "redo_ms_per_segment": redo_s * 1e3,
        "redo_sharings_per_s": SEG / redo_s,
        "gao_segments_per_redo": nseg, "gao_segment_instances":
        rec._REDO_SEG, "gao_segment_ms": gao_seg_ms,
        "gao_segment_device_busy_ms": seg_busy_ms,
        "gao_segment_kernel_launches": seg_kernels,
        "encode_device_busy_ms": enc_busy_ms,
        "device_busy_ms_per_redo": enc_busy_ms + nseg * seg_busy_ms,
        "device_busy_per_redo_from": "encode + segments x one segment",
        "launches_per_redo": lb,
        "batch_reconstruct_ms": br_s * 1e3}


# -- the offline programs: the three-kernel open and the flat finish --------

def open_fused_bound(stage, n, k, c):
    """Bytes: each input read once, each output written once; operations:
    the int8 dot as the kernel runs it (32 diagonals x 32k digits per lane
    and column), K3 decoding once."""
    nv = n - k
    if stage == 1:
        lanes, ncol = n * c, n
        nbytes = 32 * n * k * c + 32 * n * n * c
    elif stage == 2:
        lanes, ncol = n * c, nv + 1
        nbytes = 32 * n * n * c + 32 * n * c + 4 * n
    else:
        lanes, ncol = c, n
        nbytes = 32 * n * c + 32 * k * c + 4
    nbytes += ncol * 8 * k * 128                      # the band
    return bound(nbytes, 2 * lanes * ncol * 32 * 32 * k, INT8_OPS_PER_S)


def packed_ints(packed, idx):
    """Montgomery-form ints of packed [PL, ...] at flat element indices."""
    return [v for v in mont_ints(packed.reshape(PL, -1)[:, idx])[0]]


def compare_open_fused(dev, n, k, c, key):
    """K1, K2, K3 against their plain versions on consistent shares, then
    on faulted ones, with a Python-int sample of each stage. Returns the
    worst error and the path-shape inputs of the three stages."""
    pts = tuple(range(1, n + 1))
    view = deal_packed(dev, n, k - 1, k * c, key).reshape(PL, n, k, c)
    cols = fo.open_k1(view, pts)
    want = fo._k1_plain(view, pts)
    sync()
    check(torch.equal(cols, want), f"open_fused K1 != plain at {(n, k, c)}")
    worst = max_abs_err(cols, want)
    # Python ints: party p's predicted column for destination j
    p, j, cc = n - 1, n // 2, c - 1
    co = packed_ints(view[:, p, :, cc], list(range(k)))
    got = packed_ints(cols[:, p, j, cc], [0])[0]
    check(got == sum(x * pow(j + 1, i, P) for i, x in enumerate(co)) % P,
          f"open_fused K1 != Python ints at {(n, k, c)}")
    stage_in = [view, cols, None]
    for faulted in (False, True):
        x = cols
        if faulted:
            x = cols.clone()
            x[3, n - 1, 2, c - 1] ^= 0x10          # dst 2, validating source
            x[0, 0, n - 1, 0] ^= 1                 # dst n-1, interpolating
        vals, errs = fo.open_k2(x, pts, k)
        vals_p, errs_p = fo._k2_plain(x, pts, k)
        sync()
        check(torch.equal(vals, vals_p) and torch.equal(errs, errs_p),
              f"open_fused K2 != plain at {(n, k, c)} faulted={faulted}")
        bad = errs.tolist()
        check((bad[2] > 0 and bad[n - 1] > 0 and sum(bad) == bad[2]
               + bad[n - 1]) if faulted else sum(bad) == 0,
              f"open_fused K2 counts {bad} (faulted={faulted})")
        worst = max(worst, max_abs_err(vals, vals_p), max_abs_err(errs, errs_p))
        if not faulted:
            lam0 = _lam_int(list(range(1, k + 1)), 0)
            ys = packed_ints(cols[:, :k, j, cc], list(range(k)))
            check(packed_ints(vals[:, j, cc], [0])[0]
                  == sum(l * y for l, y in zip(lam0, ys)) % P,
                  f"open_fused K2 != Python ints at {(n, k, c)}")
            stage_in[2] = vals
    vals = stage_in[2]
    for faulted in (False, True):
        x = vals
        if faulted:
            x = vals.clone()
            x[5, n - 1, c // 2] ^= 0x100
        sec, errs = fo.open_k3(x, pts, k)
        sec_p, errs_p = fo._k3_plain(x, pts, k)
        sync()
        check(torch.equal(sec, sec_p) and torch.equal(errs, errs_p),
              f"open_fused K3 != plain at {(n, k, c)} faulted={faulted}")
        check(errs.tolist() == [int(faulted)],
              f"open_fused K3 counts {errs.tolist()} (faulted={faulted})")
        worst = max(worst, max_abs_err(sec, sec_p), max_abs_err(errs, errs_p))
    # Python ints: the k secret coefficients re-encode to party j's psi
    sec, _ = fo.open_k3(vals, pts, k)
    co = packed_ints(sec[:, :, cc], list(range(k)))
    check(packed_ints(vals[:, j, cc], [0])[0]
          == sum(x * pow(j + 1, i, P) for i, x in enumerate(co)) % P,
          f"open_fused K3 != Python ints at {(n, k, c)}")
    return worst, stage_in


def compare_mul_add(dev, b):
    x = [pack_limbs(rand_field(dev, (71 + i, b), (b,))) for i in range(3)]
    got = fk.mul_add_packed(*x)
    want = fk._mul_add_packed_plain(*x)
    sync()
    check(torch.equal(got, want), f"mul_add_packed != plain at B={b}")
    rinv = pow(R_MOD_P, P - 2, P)
    for i in sorted({0, b // 2, b - 1}):
        a_, b_, c_, o = (packed_ints(t, [i])[0] for t in (*x, got))
        check(o == (a_ * b_ * rinv + c_) % P,
              f"mul_add_packed != Python ints at B={b} element {i}")
    return max_abs_err(got, want), x


def phase_kernels_programs(dev):
    """Rows 10 and 16-18 of PERF.md (mul_add_packed, K1-K3) against their
    plain versions on the card, bit for bit, with Python-int samples, at
    the programs' shapes (k = 22 and 43), an unaligned chunk count and a
    small shape; times and bounds."""
    t0 = time.perf_counter()
    err = {f"open_fused_k{s}": 0 for s in (1, 2, 3)}
    shapes, times = [], {}
    for n, k, c in ((8, 3, 5), (N, K, 33), (N, K, C_T),
                    (N, 2 * T + 1, C_2T)):
        worst, stage_in = compare_open_fused(dev, n, k, c, (73, c))
        for s in (1, 2, 3):
            err[f"open_fused_k{s}"] = max(err[f"open_fused_k{s}"], worst)
        shapes.append(f"open_fused K1-K3 n={n} k={k} C={c} (+ faults)")
        if n == N and c in (C_T, C_2T):
            pts = tuple(range(1, N + 1))
            view, cols, vals = stage_in
            tag = "" if k == K else f"_k{k}"
            runs = ((1, lambda: fo.open_k1(view, pts),
                     lambda: fo._k1_plain(view, pts)),
                    (2, lambda: fo.open_k2(cols, pts, k),
                     lambda: fo._k2_plain(cols, pts, k)),
                    (3, lambda: fo.open_k3(vals, pts, k),
                     lambda: fo._k3_plain(vals, pts, k)))
            for s, kern, plain in runs:
                times[f"open_fused_k{s}{tag}"] = (
                    kernel_ms(kern, 10, f"open_fused_k{s}_kernel"),
                    timed_once(plain), open_fused_bound(s, N, k, c))
            del view, cols, vals, stage_in
    worst = 0
    for b in (1, 777, N * N_OUT * KT):
        e, operands = compare_mul_add(dev, b)
        worst = max(worst, e)
        shapes.append(f"mul_add_packed B={b}")
    err["mul_add_packed"] = worst
    times["mul_add_packed"] = (
        kernel_ms(lambda: fk.mul_add_packed(*operands), 20,
                  "mul_add_packed_kernel"),
        timed_once(lambda: fk._mul_add_packed_plain(*operands)),
        mul_add_bound(N * N_OUT * KT))
    say("program_kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


def open_fp(x, deg):
    """Open FpArray shares [n, m] on the card at degree `deg` with the
    detect-only direct open -> (one copy [PL, m], nerr [n]); the column
    count is padded with zero sharings to a multiple of deg+1."""
    packed = pack_limbs(x.limbs)
    m = packed.shape[-1]
    pad = (-m) % (deg + 1)
    if pad:
        packed = torch.cat([packed, packed.new_zeros((PL, N, pad))], dim=-1)
    run = _sim_reconstruct_packed_jit(N, deg, False, True, fallback=False,
                                      replicate=False)
    sec, nerr = run(packed)
    return sec[:, :m], nerr


def check_program(prog, fb, out):
    """The program's outputs are right: ok; double sharings open to equal
    secrets at both degrees; ab = a*b for every triple (and in Python ints
    for a sample); every bit is 0 or 1 and both occur."""
    what = f"{prog} in_graph_fallback={fb}"
    check(bool(out[-1]), f"{what}: ok is false on an honest run")
    m = N_OUT * KT
    for x in out[:-1]:
        check(x.shape == (N, m) and x.limbs.is_cuda, f"{what}: shapes")
    if prog == "randousha":
        st, e1 = open_fp(out[0], T)
        s2, e2 = open_fp(out[1], 2 * T)
        check(int(e1.sum()) == 0 and int(e2.sum()) == 0
              and torch.equal(st, s2), f"{what}: r_t, r_2t disagree")
        check(st.unique(dim=1).shape[1] == m, f"{what}: secrets repeat")
        return {"opened_equal": True}
    if prog == "generate_triples":
        (a, ea), (b, eb), (ab, eab) = (open_fp(x, T) for x in out[:3])
        check(int(ea.sum() + eb.sum() + eab.sum()) == 0,
              f"{what}: a, b, ab do not open cleanly")
        prod = pack_limbs(mont.mont_mul(unpack_limbs(a), unpack_limbs(b)))
        nbad = int((prod != ab).any(dim=0).sum())
        check(nbad == 0, f"{what}: ab != a*b for {nbad} of {m} triples")
        for i in (0, m // 3, m - 1):
            ai, bi, abi = (plain_int(x[:, i]) for x in (a, b, ab))
            check(abi == ai * bi % P, f"{what}: Python ints ab != a*b")
        return {"product_mismatches": nbad}
    bits, e = open_fp(out[0], T)
    check(int(e.sum()) == 0, f"{what}: bits do not open cleanly")
    one = pack_limbs(FpArray.from_int(1, device=bits.device).limbs)[:, None]
    is0, is1 = (bits == 0).all(dim=0), (bits == one).all(dim=0)
    check(bool((is0 | is1).all()), f"{what}: a bit is neither 0 nor 1")
    check(bool(is0.any()) and bool(is1.any()), f"{what}: one bit value only")
    return {"zeros": int(is0.sum()), "ones": int(is1.sum())}


def phase_programs(dev, reps):
    """sim_offline_jit(program, 64, 21, 4096, in_graph_fallback) for the
    three eager-path programs in both modes. Each call runs with the launch
    counts set to 0 just before it and read just after; the path's counts
    are their sum. Then the outputs are checked, and each program timed."""
    fns = {(p, fb): sim_offline_jit(p, N, T, KT, fb)
           for p in PROGRAMS for fb in (False, True)}
    for i, fn in enumerate(fns.values()):        # bands and launchers
        fn((3030, i))
    sync()
    torch.cuda.empty_cache()
    path = {name: 0 for name in KERNEL_COUNTERS}
    per_call, rows = {}, {}
    for i, ((prog, fb), fn) in enumerate(fns.items()):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        out = fn((3031, i))
        sync()
        first_s = time.perf_counter() - t0
        counts, plain = read_launches(), read_plain()
        for name, v in counts.items():
            path[name] += v
        check(all(v == 0 for v in plain.values()),
              f"{prog} fb={fb}: plain versions ran on the card: {plain}")
        ran = {name: v for name, v in counts.items() if v}
        tag = f"{prog}{'_fallback' if fb else ''}"
        rows[tag] = {"launches": ran,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "first_call_ms": first_s * 1e3,
                     **check_program(prog, fb, out)}
        if fb:
            for s in (1, 2, 3):
                check(counts[f"open_fused_k{s}"] > 0,
                      f"{tag} never launched K{s}")
            check(counts["open_direct"] == 0,
                  f"{tag}: the robust program ran a detect-only open")
        if prog == "generate_triples" and not fb:
            check(counts["mul_add_packed"] == 1,
                  f"{tag}: mul_add_packed launched {counts['mul_add_packed']}"
                  " times, expected 1")
        del out
        torch.cuda.empty_cache()
    for s in (1, 2, 3):
        check(path[f"open_fused_k{s}"] > 0, f"the programs never ran K{s}")
    check(path["mul_add_packed"] > 0, "the programs never ran mul_add_packed")
    say("programs", ok=True, n=N, t=T, k=KT, outputs_per_call=N_OUT * KT,
        calls=rows, launches=path)

    # timing: a new key every call; device time of one more, profiled
    nrep = min(reps, 5)
    for i, ((prog, fb), fn) in enumerate(fns.items()):
        tag = f"{prog}{'_fallback' if fb else ''}"
        sync()
        t0 = time.perf_counter()
        for r in range(nrep):
            out = fn((3032 + i, r))
        sync()
        dt = (time.perf_counter() - t0) / nrep
        check(bool(out[-1]), f"timed {tag}: ok is false")
        del out
        busy_ms, nkern, top = device_busy_ms(lambda: fn((3040 + i, 0)), 8)
        per_call[tag] = {"ms_per_call": dt * 1e3,
                         "outputs_per_s": N_OUT * KT / dt,
                         "device_busy_ms_per_call": busy_ms,
                         "device_kernels_per_call": nkern,
                         "device_ms_top_kernels": top,
                         "timed_calls": nrep,
                         "launches_per_call": rows[tag]["launches"],
                         "peak_device_bytes":
                         rows[tag]["peak_device_bytes"]}
        torch.cuda.empty_cache()
    return path, per_call


def phase_program_fault(dev):
    """generate_triples with in_graph_fallback=True at a small k, party 5
    sending wrong shares of a*b + r: the three-kernel open sees it, the
    Gao fallback inside the call corrects it — a, b, ab equal the honest
    run's — and ok still turns False, as in the reference."""
    fn = sim_offline_jit("generate_triples", N, T, FAULT_KT, True)
    bump = FpArray.from_int(1, device=dev)

    def tamper(name, cols):
        if name != "ab_plus_r":
            return cols
        limbs = cols.limbs.clone()
        limbs[:, 5] = (FpArray(limbs[:, 5]) + bump).limbs
        return FpArray(limbs)

    reset_launches()
    honest = fn((3050, 0))
    sync()
    counts_h = read_launches()
    reset_launches()
    t0 = time.perf_counter()
    faulty = fn((3050, 0), tamper=tamper)
    sync()
    secs = time.perf_counter() - t0
    counts = read_launches()
    check(bool(honest[3]) and not bool(faulty[3]),
          "in-program fallback: ok must be true honest, false faulty")
    for x, y in zip(honest[:3], faulty[:3]):
        check(torch.equal(x.limbs, y.limbs),
              "in-program fallback: outputs differ from the honest run")
    # the Gao decoder is thousands of elementwise multiplies
    check(counts["open_fused_k1"] > 0
          and counts["mont_mul"] > counts_h["mont_mul"] + 1000,
          f"in-program fallback: no three-kernel open or no Gao: {counts}")
    say("program_fault", ok=True, program="generate_triples", k=FAULT_KT,
        faulty_party=5, ok_flags=[bool(honest[3]), bool(faulty[3])],
        outputs_equal_honest=True,
        launches={k: v for k, v in counts.items() if v},
        ms=secs * 1e3)


# -- the coding layer: rows 13 and 14 against their plain versions ----------

# row 14's windows (n -> contractions) and row 13's streamed shapes, PERF.md
ROW14_SHAPES = ((4, 439), (4, 512), (4, 858), (8, 313), (8, 422),
                (16, 196), (16, 204))
ROW13_SHAPES = ((4, 92), (4, 256), (4, 438), (8, 312), (16, 195),
                (22, 151), (32, 108))
CODING_B = 16896                  # the reference bench's segment, 22 * 768
# fp_matmul at a batch of 1024 on both sides of every window edge
WINDOW_EDGES = ((4, 91), (4, 92), (4, 438), (4, 439), (4, 858), (4, 859),
                (4, 3598), (4, 3599), (8, 312), (8, 313), (8, 422),
                (8, 423), (16, 195), (16, 196), (16, 204), (16, 205),
                (22, 151), (22, 152), (32, 108), (32, 109), (43, 80),
                (43, 81), (64, 52), (64, 53))
ROUTE_COUNTER = {"mxu2": "mxu_fused2", "mxu_fused": "mxu_fused",
                 "mxu": "mxu_redc", "cios": "fp_matmul_cios"}


def fused_bound(b, k, n):
    """Reads a's and v's limbs, writes the limbs; the least int8 work of
    the product convolution (37 x 37 digit products per operand and
    output) on the tensor cores and the 73-diagonal REDC on the CUDA
    cores, whichever is longer."""
    npl = mxu.NPLANES
    nbytes = 64 * (b * k + k * n + b * n)
    dot_ms = 2 * b * n * npl * npl * k / INT8_OPS_PER_S * 1e3
    fold_ms = REDC73_OPS * b * n / INT32_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(dot_ms, fold_ms)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_kernels_coding(dev):
    """Rows 14 and 13 bit for bit against their plain versions on the card
    at the windows fp_matmul routes to them, a Python-int sample each, times
    and bounds; then fp_matmul on CUDA tensors at every window edge: no
    raise, the routed kernel launched, no plain version on the card."""
    from honeybadgermpc_tpu_torch.ops.fpmatmul import _route, fp_matmul
    t0 = time.perf_counter()
    err, shapes, times = {"mxu_fused": 0}, [], {}
    for i, (n, k) in enumerate(ROW14_SHAPES):
        for bb in ((1024, 1031)[i % 2], CODING_B):
            if bb == CODING_B and (n, k) not in ((4, 512), (8, 313),
                                                 (16, 204), (4, 858)):
                continue
            a = rand_field(dev, (80, bb + k), (bb, k))
            v = rand_field(dev, (81, n + k), (k, n))
            got = mxu._fused_cuda(a, v)
            want = mxu._fused_plain(a, v)
            sync()
            check(torch.equal(got, want),
                  f"mxu_fused != plain at B={bb} k={k} n={n}")
            check_oracle(got, a, v, f"mxu_fused B={bb} k={k} n={n}")
            err["mxu_fused"] = max(err["mxu_fused"], max_abs_err(got, want))
            shapes.append(f"mxu_fused B={bb} k={k} n={n}")
            if (bb, n, k) == (CODING_B, 4, 512):
                times["mxu_fused"] = (
                    kernel_ms(lambda: mxu._fused_cuda(a, v), 10, "Redc73"),
                    timed_once(lambda: mxu._fused_plain(a, v)),
                    fused_bound(bb, k, n))
    for i, (n, k) in enumerate(ROW13_SHAPES + ((4, 438),)):
        bb = CODING_B if i == len(ROW13_SHAPES) else (1024, 1031)[i % 2]
        a = rand_field(dev, (82, bb + k), (bb, k))
        v = rand_field(dev, (83, n + k), (k, n))
        r = mxu._rounds_for(k)
        wd = mxu._folded_band_digits(v, r)
        got = mxu._fused2_cuda(a, wd, r)
        want = mxu._fused2_plain(a, wd, r)
        sync()
        check(torch.equal(got, want),
              f"mxu_fused2 != plain at B={bb} k={k} n={n}")
        check_oracle(got, a, v, f"mxu_fused2 B={bb} k={k} n={n}")
        err["mxu_fused2"] = max(err.get("mxu_fused2", 0),
                                max_abs_err(got, want))
        shapes.append(f"mxu_fused2 B={bb} k={k} n={n}")
    times["mxu_fused2_streamed"] = (
        kernel_ms(lambda: mxu._fused2_cuda(a, wd, r), 10, "Fold37"),
        timed_once(lambda: mxu._fused2_plain(a, wd, r)),
        fused2_bound(CODING_B, 438, 4, mxu._rounds_for(438)))

    edges = []
    for n, k in WINDOW_EDGES:
        a = rand_field(dev, (84, k), (1024, k))
        v = rand_field(dev, (85, n), (k, n))
        route = _route(1024, k, n)
        reset_launches()
        out = fp_matmul(FpArray(a), FpArray(v))
        sync()
        moved = {name: c for name, c in read_launches().items() if c}
        check(moved.get(ROUTE_COUNTER[route], 0) >= 1,
              f"fp_matmul k={k} n={n}: route {route} launched nothing")
        check(not any(moved.get(ROUTE_COUNTER[r], 0) for r in ROUTE_COUNTER
                      if r != route),
              f"fp_matmul k={k} n={n}: another matmul kernel ran: {moved}")
        check(not any(read_plain().values()),
              f"fp_matmul k={k} n={n}: a plain version ran on the card")
        check_oracle(out.limbs, a, v, f"fp_matmul k={k} n={n}")
        edges.append(f"n={n} k={k}: {route}")
    say("coding_kernels_vs_plain", ok=True, tolerance="exact (torch.equal)",
        shapes=shapes, fp_matmul_window_edges=edges,
        timed_by={k: v[0][1] for k, v in times.items()},
        seconds=round(time.perf_counter() - t0, 3))
    return err, {k: (v[0][0], v[1], v[2]) for k, v in times.items()}


# -- NTL and coding on the card ----------------------------------------------

def _rate(fn, units, count, reps=5):
    """Host-clock ms per call (mean of `reps` after a warm-up, each ending
    in a synchronize), the rate in `units`, device-busy ms and launches of
    one call from the profiler; where its trace holds no kernel, CUDA
    events around one call instead (host gaps between launches
    included). The launch counters are left as they were: timing
    repeats are not the path's launches."""
    saved = read_launches()
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
        sync()
    ms = (time.perf_counter() - t) / reps * 1e3
    busy, launches = device_busy_ms(fn)
    out = {"ms_per_call": ms, units: count / ms * 1e3,
           "device_busy_ms": busy, "kernel_launches": launches}
    if launches == 0:
        out["device_busy_ms"] = None
        out["device_ms_cuda_events"] = timed_once(fn)
    for name, (mod, attr) in KERNEL_COUNTERS.items():
        setattr(mod, attr, saved[name])
    return out


def _int_rows(arr, rows):
    return [[int(v) for v in arr[r].to_ints()] for r in rows]


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def phase_ntl(dev):
    """The reference bench's grids through the port's coding layer and
    every ntl function once on CUDA tensors, each against Python ints on a
    sample; vandermonde_batch_evaluate of 1024 polynomials with 512
    coefficients at 4 points reaches row 14 through the entry point."""
    from honeybadgermpc_tpu_torch import ntl
    from honeybadgermpc_tpu_torch.ops import ntt
    from honeybadgermpc_tpu_torch.ops.fpmatmul import \
        vandermonde_batch_interpolate
    from honeybadgermpc_tpu_torch.ops.rs import Encoding
    from honeybadgermpc_tpu_torch.polynomial import get_omega_int
    from honeybadgermpc_tpu_torch.runtime.refinement import (
        refine_randoms, refine_randoms_host)
    from honeybadgermpc_tpu_torch.field import GF
    t0 = time.perf_counter()
    reset_launches()
    rates = {}
    for n in (16, 128, 1024):
        xs = list(range(1, n + 1))
        ys = FpArray(rand_field(dev, (90, n), (8, n)))
        c = vandermonde_batch_interpolate(xs, ys)
        want = _int_rows(ys, [0, 7])
        got = _int_rows(c, [0, 7])
        for r in range(2):
            for j in (0, n // 2, n - 1):
                check(_horner(got[r], xs[j]) == want[r][j],
                      f"vandermonde_batch_interpolate n={n}")
        rates[f"lagrange_interpolate_n{n}"] = _rate(
            lambda: vandermonde_batch_interpolate(xs, ys), "points_per_s",
            8 * n)
    for logn in (4, 8, 12, 14):
        n = 1 << logn
        batch = (1 << 16) // n
        omega = get_omega_int(P, n, seed=0)
        ys = FpArray(rand_field(dev, (91, n), (batch, n)))
        coeffs = ntt.fft_interpolate(ys, omega)
        evals = ntt.fft_evaluate(coeffs, omega, n)
        check(torch.equal(evals.limbs, ys.limbs),
              f"fft_evaluate(fft_interpolate(y)) != y at n={n}")
        got = _int_rows(coeffs, [0, batch - 1])
        want = _int_rows(ys, [0, batch - 1])
        for r in range(2):
            for j in (0, 1, n - 1):
                check(_horner(got[r], pow(omega, j, P)) == want[r][j],
                      f"fft_interpolate n={n}")
        rates[f"fft_interpolate_n{n}"] = _rate(
            lambda: ntt.fft_interpolate(ys, omega), "points_per_s",
            batch * n)
        rates[f"fft_evaluate_n{n}"] = _rate(
            lambda: ntt.fft_evaluate(coeffs, omega, n), "points_per_s",
            batch * n)
    for n in (4, 16, 64):
        t = (n - 1) // 3
        k = n - t
        shares = FpArray(rand_field(dev, (92, n), (512, k)))
        out = refine_randoms(n, t, shares)
        for r in (0, 511):
            check(_int_rows(out, [r])[0] == refine_randoms_host(
                n, t, GF(P), _int_rows(shares, [r])[0]),
                f"refine_randoms n={n}")
        rates[f"random_refinement_n{n}"] = _rate(
            lambda: refine_randoms(n, t, shares), "outputs_per_s",
            512 * (k - t))

    enc = Encoding(128, use_omega_powers=True)
    zs = tuple(range(0, 128, 3))                      # 43 parties
    coeffs = FpArray(rand_field(dev, (93, 1), (CODING_B, len(zs))))
    shares = enc.encode(coeffs)
    sub = shares.take(list(zs), axis=1)
    back = enc.decode(zs, sub)
    check(torch.equal(back.limbs, coeffs.limbs),
          "Encoding(128, omega): decode(encode(c)) != c")
    row = _int_rows(coeffs, [CODING_B - 1])[0]
    check(_int_rows(shares, [CODING_B - 1])[0][5] ==
          _horner(row, enc.points[5]), "omega encode != Python ints")
    rates["fnt_encode_n128"] = _rate(lambda: enc.encode(coeffs),
                                     "polys_per_s", CODING_B)
    rates["fnt_decode_n128_from43"] = _rate(lambda: enc.decode(zs, sub),
                                            "polys_per_s", CODING_B)

    # every ntl function once, against the host fallbacks and Python ints
    rng = __import__("random").Random(2026)
    pts = list(range(1, 6))
    poly = [rng.randrange(P) for _ in range(5)]
    vals = [ntl.evaluate(poly, x, P) for x in pts]
    check(ntl.lagrange_interpolate(pts, vals, P) == poly,
          "ntl.lagrange_interpolate")
    check(ntl.vandermonde_inverse(pts, P) == [
        ntl._lagrange_coeffs_host(pts, [int(i == j) for i in range(5)], P)
        for j in range(5)], "ntl.vandermonde_inverse")
    polys = [[rng.randrange(P) for _ in range(4)] for _ in range(3)]
    evals = ntl.vandermonde_batch_evaluate(pts[:4], polys, P)
    check(evals == [[ntl.evaluate(q, x, P) for x in pts[:4]] for q in polys],
          "ntl.vandermonde_batch_evaluate (small)")
    check(ntl.vandermonde_batch_interpolate(pts[:4], evals, P) == polys,
          "ntl.vandermonde_batch_interpolate")
    n = 8
    omega = get_omega_int(P, n, seed=0)
    full = ntl.fft(polys[0] + [0] * 4, omega, P, n)
    check(full == ntl._fft_host(polys[0], omega, P, n), "ntl.fft")
    check(ntl.partial_fft(polys[0], omega, P, n, 3) == full[:3],
          "ntl.partial_fft")
    check(ntl.fft_batch_evaluate(polys, omega, P, n, n) ==
          [ntl._fft_host(q, omega, P, n) for q in polys],
          "ntl.fft_batch_evaluate")
    fz = [0, 2, 5, 7]
    fys = [full[z] for z in fz]
    check(ntl.fft_interpolate(fz, fys, omega, P, n)[:4] == polys[0],
          "ntl.fft_interpolate")
    check(ntl.fft_batch_interpolate(fz, [fys], omega, P, n)[0][:4] ==
          polys[0], "ntl.fft_batch_interpolate")
    gx = list(range(1, 10))
    gy = [ntl.evaluate(polys[1][:3], x, P) for x in gx]
    gy[1], gy[6] = (gy[1] + 17) % P, None
    msg, errp = ntl.gao_interpolate(gx, gy, 3, P)
    check(msg[:3] == polys[1][:3] and ntl.evaluate(errp, 2, P) == 0,
          "ntl.gao_interpolate")
    keep = [i for i, y in enumerate(gy) if y is not None]
    check(ntl._gao_host([gx[i] for i in keep], [gy[i] for i in keep], 3,
                        P)[0] == polys[1][:3], "ntl._gao_host")
    sq = poly[0] * poly[0] % P
    check(ntl.sqrt_mod(sq, P) ** 2 % P == sq, "ntl.sqrt_mod")
    ntl.SetNumThreads(4)
    ntl.SetNTLNumThreads(4)
    check(ntl.AvailableNTLThreads() == ntl.GetMaxThreads() == 1,
          "ntl thread controls")
    try:
        ntl.lagrange_interpolate([1, 1], [2, 3], P)
        check(False, "ntl.InterpolationError not raised")
    except ntl.InterpolationError:
        pass
    # row 14 through the entry point: 1024 polynomials, 512 coefficients,
    # 4 points (fused2_fits fails, fused_fits holds)
    big = [[rng.randrange(P) for _ in range(512)] for _ in range(1024)]
    before = mxu.launches_fused
    bx = [3, 5, 7, 11]
    bev = ntl.vandermonde_batch_evaluate(bx, big, P)
    check(mxu.launches_fused == before + 1,
          "ntl.vandermonde_batch_evaluate(1024 x 512 at 4 points) did not "
          "launch mxu_fused")
    for r in (0, 511, 1023):
        check(bev[r] == [ntl.evaluate(big[r], x, P) for x in bx],
              "ntl.vandermonde_batch_evaluate (row 14) != Python ints")
    cs = FpArray.from_ints(big, dev)
    from honeybadgermpc_tpu_torch.ops.fpmatmul import \
        vandermonde_batch_evaluate
    rates["vandermonde_batch_evaluate_1024x512_at4"] = _rate(
        lambda: vandermonde_batch_evaluate(bx, cs), "points_per_s", 4096)
    launches = read_launches()
    plain = read_plain()
    check(not any(plain.values()), f"a plain version ran on the card: "
          f"{plain}")
    check(launches["mont_mul"] > 0 and launches["mxu_fused"] > 0 and
          launches["mxu_redc"] > 0 and launches["fp_matmul_cios"] > 0,
          f"the coding path missed a kernel: {launches}")
    say("ntl", ok=True, launches={k: v for k, v in launches.items() if v},
        plain_on_card=plain, seconds=round(time.perf_counter() - t0, 3))
    return launches, rates


def kernels_line(times, err, launches, launches_triples, launches_robust,
                 launches_programs, launches_ntl, int_mm_ms):
    """The rows of the `kernels` JSON line, one per kernel: its source, the
    TPU kernel it replaces, launches on its path, times and bound."""
    meta = {
        "open_direct": ("honeybadgermpc_tpu_torch/csrc/open_direct.cu",
                        "honeybadgermpc_tpu/ops/fused_open_direct.py:202",
                        f"n={N} k={K} B={SEG}"),
        "rand_limbs": ("honeybadgermpc_tpu_torch/csrc/rand_limbs.cu",
                       "honeybadgermpc_tpu/ops/pallas_field.py:452",
                       f"numel={SEG * T}"),
        "band_matmul": ("honeybadgermpc_tpu_torch/csrc/band_matmul.cu",
                        "honeybadgermpc_tpu/ops/band_matmul.py:76",
                        f"B={SEG} k={K} m={N}"),
        "randousha_deal": (
            "honeybadgermpc_tpu_torch/csrc/randousha_deal.cu",
            "honeybadgermpc_tpu/ops/fused_randousha.py:293",
            f"n={N} degree t={T} (k={K}) sp={KT}"),
        "randousha_extract": (
            "honeybadgermpc_tpu_torch/csrc/randousha_extract.cu",
            "honeybadgermpc_tpu/ops/fused_randousha.py:367",
            f"n={N} n_out={N_OUT} (+1 check column) sp={KT}"),
        "mul_add_packed4": (
            "honeybadgermpc_tpu_torch/csrc/packed_arith.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:244",
            f"[{PL},{N},{N_OUTP},{KT}]"),
        "sub_bcast_packed4": (
            "honeybadgermpc_tpu_torch/csrc/packed_arith.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:308",
            f"[{PL},{N_OUTP},{KT}] - [{PL},{N},{N_OUTP},{KT}]"),
        "mont_mul": (
            "honeybadgermpc_tpu_torch/csrc/mont_mul.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:127",
            f"[{L},2048,{N + 1}] (a Gao EEA step)"),
        "fp_matmul_cios": (
            "honeybadgermpc_tpu_torch/csrc/fp_matmul_cios.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:529",
            f"B={N} k={K} n={N - K + 1}"),
        "mxu_fused2": (
            "honeybadgermpc_tpu_torch/csrc/mxu_fused2.cu",
            "honeybadgermpc_tpu/ops/mxu_matmul.py:453",
            f"B={N * C} k={K} n={N - K + 1}"),
        "mxu_fused": (
            "honeybadgermpc_tpu_torch/csrc/mxu_fused.cu",
            "honeybadgermpc_tpu/ops/mxu_matmul.py:224",
            f"B={CODING_B} k=512 n=4"),
        "mxu_redc": (
            "honeybadgermpc_tpu_torch/csrc/mxu_redc.cu",
            "honeybadgermpc_tpu/ops/mxu_matmul.py:547",
            f"M=2048*{N} (B=2048 k={N} n={N})"),
        "open_fused_k1": (
            "honeybadgermpc_tpu_torch/csrc/open_fused.cu",
            "honeybadgermpc_tpu/ops/fused_open.py:419",
            f"n={N} k={K} C={C_T}"),
        "open_fused_k2": (
            "honeybadgermpc_tpu_torch/csrc/open_fused.cu",
            "honeybadgermpc_tpu/ops/fused_open.py:442",
            f"n={N} k={K} C={C_T}"),
        "open_fused_k3": (
            "honeybadgermpc_tpu_torch/csrc/open_fused.cu",
            "honeybadgermpc_tpu/ops/fused_open.py:470",
            f"n={N} k={K} C={C_T} (one decode)"),
        "mul_add_packed": (
            "honeybadgermpc_tpu_torch/csrc/packed_arith.cu",
            "honeybadgermpc_tpu/ops/pallas_field.py:194",
            f"[{PL},{N * N_OUT * KT}]"),
    }
    # extra shapes timed beside a kernel's main one
    extra = {"randousha_deal": ("randousha_deal_2t", f"k={2 * T + 1}"),
             "mont_mul": ("mont_mul_folded_band", f"[{L},{2 * T},{N}]"),
             "mxu_fused2": (f"mxu_fused2_n{N}", f"B={N * C} k={K} n={N}")}
    for s in (1, 2, 3):
        extra[f"open_fused_k{s}"] = (f"open_fused_k{s}_k{2 * T + 1}",
                                     f"k={2 * T + 1} C={C_2T}")
    extra_streamed = {"mxu_fused2": ("mxu_fused2_streamed",
                                     f"B={CODING_B} k=438 n=4 (k-streamed)")}
    robust_path = ("mont_mul", "fp_matmul_cios", "mxu_fused2", "mxu_redc")
    program_path = ("open_fused_k1", "open_fused_k2", "open_fused_k3",
                    "mul_add_packed")
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        ms, plain_ms, (bound_ms, bound_by) = times[name]
        # launches: from the run of the path the kernel belongs to (the
        # open path for the first three, the triple call for the next four,
        # the robust open for the last four); the open kernel serves all
        if name == "mxu_fused":      # the NTL path (phase 17) reaches it
            count = launches_ntl[name]
        elif name in program_path:
            count = launches_programs[name]
        elif name in robust_path:
            count = launches_robust[name]
        elif launches[name] > 0:
            count = launches[name]
        else:
            count = launches_triples[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape, "share_of_bound": bound_ms / ms}
        if name in ("open_direct", "mont_mul"):
            row["launches_triple_call"] = launches_triples[name]
            row["launches_programs"] = launches_programs[name]
        if name == "open_direct":
            row["launches_robust_open"] = launches_robust[name]
        if name == "mxu_redc":      # its dot, outside the kernel
            row["dot_int_mm_ms"] = int_mm_ms
        if name in robust_path:
            row["launches_ntl"] = launches_ntl[name]
        if name in extra_streamed:
            key, shape3 = extra_streamed[name]
            ms3, plain3, (bound3, by3) = times[key]
            row["streamed_shape"] = {"ms": ms3, "plain_ms": plain3,
                                     "bound_ms": bound3, "bound_by": by3,
                                     "shape": shape3}
        if name in extra:
            key, shape2 = extra[name]
            ms2, plain2, (bound2, by2) = times[key]
            row["second_shape"] = {"ms": ms2, "plain_ms": plain2,
                                   "bound_ms": bound2, "bound_by": by2,
                                   "shape": shape2}
        kernels.append(row)
    return kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nseg", type=int, default=64,
                    help="segments of 16896 sharings held on the card")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed repeats of opening every segment, and "
                         "timed triple calls")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the GPU only")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    say("device", kind=kind, count=torch.cuda.device_count(), card=card,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.lib()
    say("build", ok=True, seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=_build.build_seconds,
        ptxas=[ln.strip() for ln in _build.build_log().splitlines()
               if "registers" in ln])

    err, times = phase_kernels(dev)
    launches, rates = phase_main(dev, args.nseg, args.reps)
    say("timing", card=card, **rates)
    torch.cuda.empty_cache()

    err2, times2 = phase_kernels_offline(dev)
    err.update(err2)
    times.update(times2)
    launches_triples, trip = phase_triples(dev, args.reps)
    say("triple_timing", card=card, **trip)
    torch.cuda.empty_cache()

    err3, times3, int_mm_ms = phase_kernels_robust(dev)
    err.update(err3)
    times.update(times3)
    launches_robust, robust = phase_robust_open(dev)
    say("robust_timing", card=card, **robust)
    torch.cuda.empty_cache()

    err4, times4 = phase_kernels_programs(dev)
    err.update(err4)
    times.update(times4)
    torch.cuda.empty_cache()
    launches_programs, programs = phase_programs(dev, args.reps)
    say("program_timing", card=card, **programs)
    phase_program_fault(dev)
    torch.cuda.empty_cache()

    err5, times5 = phase_kernels_coding(dev)
    err.update(err5)
    times.update(times5)
    torch.cuda.empty_cache()
    launches_ntl, ntl_rates = phase_ntl(dev)
    say("ntl_timing", card=card, **ntl_rates)

    kernels = kernels_line(times, err, launches, launches_triples,
                           launches_robust, launches_programs, launches_ntl,
                           int_mm_ms)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
