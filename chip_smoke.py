"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size; needs one CUDA card

Drives the port's main path — deal -> pack -> open (detect-only) -> check —
through the entry points a user calls, at n=64, t=21 in segments of
22*768 = 16896 sharings, 64 segments resident (about 2.2 GB of packed
shares). The first run builds the kernels from
``honeybadgermpc_tpu_torch/csrc`` into ``honeybadgermpc_tpu_torch/build``.

Phases, each printing one JSON line; any failure exits non-zero:
  1 device    a CUDA card must be present; prints its name and power limit
  2 build     compile and load the three kernels
  3 kernels   each kernel against its plain PyTorch version on the card,
              bit for bit, at small, unaligned and main-path shapes, with
              times and the computed bound
  4 main      deal, pack and open every segment; nerr == 0; opened secrets
              against a Python-int Lagrange oracle; launch counters moved
  5 faults    a flipped word is detected and charged to the right party
  6 state     save the pool, load it into a fresh dealer, same secrets
  7 timing    opened and dealt sharings per second

The last line of the output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Bounds. ``bound_ms`` is the least time the card could take: the larger of
bytes moved (each input read once, each output written once) over 3.35
TB/s and operations over the peak for their type — 1,979 TOP/s for the
int8 dots (H100 SXM, dense). The sampler does 32-bit integer work on the
CUDA cores, for which the data sheet names no rate; its bound uses the
card's instruction-rate limit, 33.5 T instructions/s (4 warp instructions
per SM and clock, the same 128 lanes that give 67 TFLOP/s of float32 at 2
flop each), over the least number of instructions the arithmetic needs.
"""

import argparse
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
from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod  # noqa: E402
from honeybadgermpc_tpu_torch.ops.fpmatmul import \
    _vandermonde_int_rows  # noqa: E402
from honeybadgermpc_tpu_torch.ops.fused_open import (  # noqa: E402
    PL, _lam_int, pack_limbs, unpack_limbs)
from honeybadgermpc_tpu_torch.ops.limbs import L, P  # noqa: E402
from honeybadgermpc_tpu_torch.parallel.reconstruct import \
    _sim_reconstruct_packed_jit  # noqa: E402
from honeybadgermpc_tpu_torch.runtime.preprocessing import \
    PreProcessedElements  # noqa: E402

N, T = 64, 21
K = T + 1
C = 768
SEG = K * C                       # 16896 sharings per segment
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 67e12 / 2     # 128 lanes x 1 instruction
# Least 32-bit integer instructions per sampled element
# (csrc/rand_limbs.cu), counting what the hardware can fuse (three-input
# adds, multiply-add, three-input logic) as one: 6 Threefry calls x
# (20 rounds x (add, rotate, xor) + 2 + 5 x 2 key adds), 24 halfword
# splits, 9 REDC rounds x (2 + 16 x (multiply, low half + add, high half
# + add) + 2), carry normalization 16 x 3, conditional subtract 16 x 4.
RAND_OPS_PER_ELEMENT = 6 * (20 * 3 + 2 + 10) + 24 + 9 * (2 + 16 * 4 + 2) \
    + 16 * 3 + 16 * 4
KERNEL_MODULES = {"open_direct": fod, "band_matmul": bm, "rand_limbs": fk}


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
    """Mean device time of the CUDA kernel `kernel_name` over `reps` calls
    of fn(), from the profiler's device trace (so host time between
    launches does not count); CUDA events if the trace shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    if total_us <= 0.0:
        return time_ms(fn, reps), "cuda_events"
    return total_us / reps / 1e3, "profiler"


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def reset_launches():
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def read_launches():
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


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
    for name, count in launches.items():
        check(count > 0, f"main path never launched the {name} kernel")
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nseg", type=int, default=64,
                    help="segments of 16896 sharings held on the card")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed repeats of opening every segment")
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
    }
    kernels = []
    for name, (source, replaces, shape) in meta.items():
        ms, plain_ms, (bound_ms, bound_by) = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape, "share_of_bound": bound_ms / ms})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
