"""Where the wgmma band core's time goes (rows 1, 3, 4, 5a, 5b, 6, 13, 14,
16, 17 and 18 of PERF.md), and the field sampler's (row 2).

    python3 honeybadgermpc_tpu_torch/tools/band_core_study.py [--parent DIR]
        [--mxu-only | --sampler-k3 | --finish-cios]

Needs one CUDA card and nvcc. Builds knock-out variants of
``csrc/band_gemm.cuh`` (patched copies under the package's build
directory: the sources in the checkout stay as they are) with
``band_matmul.cu``, ``open_direct.cu``, ``open_fused.cu``,
``randousha_extract.cu`` and ``randousha_deal.cu``, and times each at the
main-path shapes of band_matmul, the direct open, K1, K2, the per-column
check, both extractions and the deal with CUDA events, on the launch plan
the wrappers choose. The compare-and-count kernels (the direct open, K2,
the check) and the extractions run on consistent shares, as on their paths
(no mismatch, so no atomics but where the dot is knocked out); the direct
open also on a segment with 21 faulty parties. Variants:

  final           the sources as they are
  no_epilogue     the dot, the band stream and the planes; no fold, no
                  store, no compare and no fetch of K2's received words
  no_stores       everything but the core's stores (band_matmul, K1, the
                  extraction)
  no_dot          everything but the wgmma (the accumulators stay 0)
  no_planes       everything but the plane build (for the deal: no draw)
  stream_only     the band stream alone
  two_consumers   2 consumer warpgroups whatever the lane tile
  one_step_slots  one k-step per bulk copy (8 slots of 2 KB per ring)
  rows_out        band_matmul writing [PL, B, m] instead of [PL, m, B]
  fetch_after_fold  K2 loading a lane's received words after its fold
                  instead of ahead (the other kernels fetch nothing)
  cluster2        blocks in clusters of two that share the band stream
                  (each copies half of every slot, multicast to both;
                  the grid rounded up to an even count)

K2 is timed on final, no_epilogue, no_dot, stream_only and
fetch_after_fold, and on final at every lane tile that fits shared memory
besides the planned one; the direct open (n=64, k=22, B=16,896; honest and
21 faulty parties) and the per-column check (n=64, 48 check columns x 4096
slots, k = 22 and 43) on final, no_epilogue, no_dot and stream_only at
every lane tile that fits; the per-column extraction on the first four; the
deal (at t and 2t: k = 22 and 43) and the aggregated extraction (n_out + 1
= 23 columns) on final, no_epilogue, no_dot, no_planes and stream_only at
their plans, on final at every other lane tile that fits, and on
cluster2 at every lane tile that fits. With ``--parent DIR`` (a checkout
of another commit of the port, e.g. its parent unpacked with ``git
archive``) the script also times that tree's band_matmul, the direct open,
K1, K2, the check, both extractions and the deal through their wrappers,
before and after the variants, in separate processes on the same card. Prints one JSON
line per measurement; the card's name and power limit come first.

Rows 13 and 14 (the MXU field matmuls, time_mxu) at B=49,152, k=22, n=43
and 64, B=16,896, k=438, n=4 (row 13) and B=16,896, k=512, n=4 (row 14):
the device time of the kernel alone (the profiler's trace, by the
epilogue type in its name) through the wrappers, on knock-out variants
of the core the checkout runs them on -- band_gemm.cuh's mxu_gemm_body,
or mxu_core.cuh's mma.sync stream kernel in a checkout from before --
final, no_epilogue (no exchange, fold or stores), no_dot, no_planes (no
limb loads or digit split), no_store, stream_only, no_transpose (the
results stay in the scratch tensor: no last phase) and, for row 13 with
resident planes, cluster2 (two-block clusters multicasting the band). With
--parent the other checkout's variants are timed the same way in a
process of its own; --mxu-only times rows 13 and 14 alone.

Rows 2 and 18 (--sampler-k3, time_r2_r18): the sampler at SEG x T =
354,816 elements and K3 at n=64, k=22, C=7,820 and k=43, C=4,001 (the
fallback runs' shapes), through the wrappers, the kernel's device time
from the profiler, on knock-out variants of the checkout's sources (the
16-bit kernels before the redesign or the word kernel and the core):
sampler final, threefry_only (no reduction), reduction_only (of a word
made from the counter, no Threefry), store_only, and for the word kernel
one_element (one element per thread and pass) and full_grid (one thread
per pair of elements, no grid-stride loop), with its SASS instruction
mix (cuobjdump); K3 final, no_epilogue, no_dot, no_planes and
stream_only, on the core at its plan and at 64-lane blocks in one group,
final also at every (lane tile, column groups) of K3_PLANS that fits,
and slots4 / ks8 (deeper band rings: 4 slots, 8 k-steps per slot) where
they fit. The final variants are held against the plain versions. With
--parent the other tree is timed the same way before and after.

Rows 7 and 12 (--finish-cios, time_r7_r12): the packed triple finish's
mul_add_packed4 at [8, 64, 24, 4096] with the call's pad (37) and none,
and the CIOS matmul at robust_open_single's B=64, k=22, n=43 and at
R12_SHAPES, through the wrappers, the kernel's device time from the
profiler, on knock-out variants of the checkout's sources: row 7 final,
no_product (the words' xor for the Montgomery product) and, on the word
kernel, store_only (no loads, no arithmetic); row 12 final and, on the
split kernel, no_reduction (the column sums folded by xor, no
reduction), no_butterfly (each lane stores its own sum) and
loads_stores (no product, no reduction), each at the plan's split, and
final and loads_stores also at every other split (1-32 lanes per
output); the kernel before its redesign also no_product. ptxas' report of
both final builds comes first. The final variants are held against the
plain versions. With --parent the other tree is timed the same way
before and after.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

BAND_SHAPES = ((16896, 22, 64), (262144, 22, 64), (262144, 43, 64),
               (262144, 64, 64))
K1_SHAPES = ((64, 22, 7820), (64, 43, 4001))
K2_SHAPES = K1_SHAPES
EXTRACT_PC = (64, 21, 4096)           # n, t, slots: 262,144 lanes, k = 64
DEAL = EXTRACT_PC                     # the deal and the aggregated extraction
DIRECT = (64, 21, 16896)              # n, t, B: one segment of the open
CHECK = (64, 21, 4096, 48)            # n, t, slots, check columns
NEW_VARIANTS = ("final", "no_epilogue", "no_dot", "stream_only")
K2_VARIANTS = NEW_VARIANTS + ("fetch_after_fold",)
DEAL_VARIANTS = ("final", "no_epilogue", "no_dot", "no_planes",
                 "stream_only")
SOURCES = ("band_matmul.cu", "open_direct.cu", "open_fused.cu",
           "randousha_extract.cu", "randousha_deal.cu")


# The cluster2 variant: every core kernel in thread-block clusters of two
# blocks (neighbouring lane tiles, the same band walk) that share their
# band stream. Each producer copies half of every ring slot and multicasts
# it to both blocks, so each block reads half the band from L2. A slot is
# refilled only when the consumers of both blocks are done with it: its
# empty mbarrier counts both blocks' consumer warps (a remote arrive for
# the peer's), but for the last SLOTS loads of a ring, which no producer
# waits for (so no arrive reaches a block that may have exited). The
# remote arrive releases at CTA scope: a cluster-scope release would also
# wait for the warp's outstanding global stores.
_CLUSTER_HELPERS = """\
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(static_cast<uint16_t>(3))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\\n" ::"r"(
                   remote)
               : "memory");
}

"""


def _cluster2():
    return [
        ("// Shared-memory matrix descriptor, no swizzle",
         _CLUSTER_HELPERS + "// Shared-memory matrix descriptor, no swizzle"),
        ("mbar_init(empty_s + 8 * s, 4);", "mbar_init(empty_s + 8 * s, 8);"),
        ("  __syncthreads();\n  // Tile ct goes to consumer",
         "  uint32_t rank;\n"
         "  asm volatile(\"mov.u32 %0, %%cluster_ctarank;\\n\" : \"=r\"(rank));\n"
         "  asm volatile(\"barrier.cluster.arrive.release.aligned;\\n\"\n"
         "               \"barrier.cluster.wait.acquire.aligned;\\n\" ::: "
         "\"memory\");\n"
         "  // Tile ct goes to consumer"),
        ("    bulk_load(ring_s + slot * SLOT_BYTES,\n"
         "              band + (static_cast<size_t>(ct) * k + kk0) * "
         "STEP_BYTES,\n"
         "              steps * STEP_BYTES, full_s + 8 * slot);\n",
         "    const uint32_t part = steps * STEP_BYTES / 2;\n"
         "    bulk_load_multicast(ring_s + slot * SLOT_BYTES + rank * part,\n"
         "                        band + (static_cast<size_t>(ct) * k + kk0) *"
         " STEP_BYTES + rank * part,\n"
         "                        part, full_s + 8 * slot);\n"),
        ("  const uint32_t planes_s = smem_u32(planes);\n",
         "  const uint32_t planes_s = smem_u32(planes);\n"
         "  const int nload_c = ((ntiles - wgi + CONSUMERS - 1) / CONSUMERS)"
         " * nst;\n"
         "  auto release = [&](int ld) {\n"
         "    const uint32_t bar = empty_s + 8 * (wgi * SLOTS + ld % SLOTS);\n"
         "    mbar_arrive(bar);\n"
         "    if (ld + SLOTS < nload_c) mbar_arrive_peer(bar, rank ^ 1u);\n"
         "  };\n"),
        ("mbar_arrive(empty_s + 8 * (wgi * SLOTS + (sr - 1) % SLOTS));",
         "release(sr - 1);"),
        ("  const unsigned grid =\n"
         "      static_cast<unsigned>((mp.nlanes + 64 * MB - 1) / (64 * MB));\n"
         "  kern<<<grid, threads(MB), smem, static_cast<cudaStream_t>(stream)"
         ">>>(\n"
         "      src, static_cast<const unsigned char*>(band), mp, wf, epi);\n",
         "  const long long blocks = (mp.nlanes + 64 * MB - 1) / (64 * MB);\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(static_cast<unsigned>((blocks + 1) / 2 * 2));\n"
         "  cfg.blockDim = dim3(threads(MB));\n"
         "  cfg.dynamicSmemBytes = smem;\n"
         "  cfg.stream = static_cast<cudaStream_t>(stream);\n"
         "  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = 2;\n"
         "  attr[0].val.clusterDim.y = 1;\n"
         "  attr[0].val.clusterDim.z = 1;\n"
         "  cfg.attrs = attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  err = cudaLaunchKernelEx(&cfg, kern, src,\n"
         "      static_cast<const unsigned char*>(band), mp, wf, epi);\n"
         "  if (err != cudaSuccess) return static_cast<int>(err);\n"),
    ]


def _patches():
    wgmma = ("wgmma_s8(acc[mb], da, db, kk > 0);", "(void)da; (void)db;")
    planes = ("build_planes<MB>(planes, src, mp, lane0);", "")
    store = ("      for (int w = 0; w < PL; ++w) o[w * ow] = words[w];",
             "      if ((words[0] ^ words[7]) == 0x9e3779b9u) "
             "o[0] = words[3];")
    return {
        "final": [],
        "no_epilogue": ["NOEPI"],
        "no_stores": [store],
        "no_dot": [wgmma],
        "no_planes": [planes],
        "stream_only": ["NOEPI", wgmma, planes],
        "two_consumers": [("return mb == 1 ? 4 : (mb == 2 ? 3 : 2);",
                           "return 2;")],
        "one_step_slots": [("constexpr int KS = 4;", "constexpr int KS = 1;"),
                           ("constexpr int SLOTS = 2;",
                            "constexpr int SLOTS = 8;")],
        "rows_out": [],
        "cluster2": _cluster2(),
        "fetch_after_fold": [
            ("    typename Epi::Fetch fx;\n    epi.fetch(mp, ln[0], col, fx);"
             "\n", ""),
            ("      epi.apply(mp, ln[mb], col, words, fx);\n"
             "      if (mb + 1 < MB) epi.fetch(mp, ln[mb + 1], col, fx);\n",
             "      typename Epi::Fetch fx;\n"
             "      epi.fetch(mp, ln[mb], col, fx);\n"
             "      epi.apply(mp, ln[mb], col, words, fx);\n")],
    }


def _source(name, patches, base):
    src = base
    if "NOEPI" in patches:          # cut from the fold to the end of the body
        a = base.index("    // the epilogue: fold, then the policy")
        b = base.index("// Launch `kern`")
        src = (base[:a] + "    if (acc[0][0] == 0x7fffffff && "
               "acc[MB - 1][31] == 3) __trap();\n  }\n}\n\n" + base[b:])
        fetch = "    epi.fetch(mp, ln[0], col, fx);\n"
        if fetch not in src:
            raise SystemExit(f"variant {name}: patch anchor missing")
        src = src.replace(fetch, "")
    for p in patches:
        if p != "NOEPI":
            if p[0] not in src:
                raise SystemExit(f"variant {name}: patch anchor missing")
            src = src.replace(p[0], p[1])
    return src


def build_variants(work):
    csrc = os.path.join(ROOT, "honeybadgermpc_tpu_torch", "csrc")
    base = open(os.path.join(csrc, "band_gemm.cuh")).read()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, patches in _patches().items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "band_gemm.cuh"), "w") as f:
            f.write(_source(name, patches, base))
        for fn in ("field_core.cuh",) + SOURCES:
            shutil.copy(os.path.join(csrc, fn), d)
        if name == "rows_out":
            fn = os.path.join(d, "band_matmul.cu")
            s = open(fn).read()
            old = "{static_cast<uint32_t*>(out), bm, 0, 1, B, 0, m}"
            if old not in s:
                raise SystemExit("variant rows_out: patch anchor missing")
            with open(fn, "w") as f:
                f.write(s.replace(old, "{static_cast<uint32_t*>(out), bm, "
                                       "0, m, 1, 0, m}"))
        so = os.path.join(d, "lib.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
             *(os.path.join(d, fn) for fn in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    u32p = ctypes.POINTER(ctypes.c_uint32)
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{out}")
        lib = ctypes.CDLL(so)
        lib.hb_band_matmul.argtypes = [vp, vp, vp, i64, i32, i32, i32, u32p,
                                       vp]
        lib.hb_open_fused_k1.argtypes = [vp, vp, vp, i32, i32, i64, i32,
                                         u32p, vp]
        lib.hb_open_fused_k2.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32,
                                         u32p, vp]
        lib.hb_randousha_extract_pc.argtypes = [vp, vp, vp, vp, i32, i32,
                                                i32, i32, i32, i32, u32p, vp]
        lib.hb_randousha_extract.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                             i32, i32, u32p, vp]
        lib.hb_randousha_deal.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                          vp, vp, i32, i32, i32, i32, i32,
                                          u32p, vp]
        lib.hb_open_direct.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32,
                                       u32p, vp]
        lib.hb_randousha_check.argtypes = [vp, vp, vp, vp, i32, i32, i64,
                                           i64, i32, u32p, vp]
        for fn in (lib.hb_band_matmul, lib.hb_open_fused_k1,
                   lib.hb_open_fused_k2, lib.hb_randousha_extract_pc,
                   lib.hb_randousha_extract, lib.hb_randousha_deal,
                   lib.hb_open_direct, lib.hb_randousha_check):
            fn.restype = i32
        libs[name] = lib
    return libs


def ev_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def say(**rec):
    print(json.dumps(rec), flush=True)


def time_variants(work):
    import torch
    from honeybadgermpc_tpu_torch.ops import band_matmul as bm
    from honeybadgermpc_tpu_torch.ops import field_kernels as fk
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    from honeybadgermpc_tpu_torch.ops import band_gemm as bg
    from honeybadgermpc_tpu_torch.ops.band_gemm import (_fold_array,
                                                        _gemm_band_index,
                                                        _gemm_plan)
    from honeybadgermpc_tpu_torch.ops.fpmatmul import _vandermonde_int_rows
    dev = torch.device("cuda")
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build_variants(work)
    stream = torch.cuda.current_stream().cuda_stream
    for b, k, m in BAND_SHAPES:
        a = fo.pack_limbs(fk.rand_limbs((21, k), b * k, dev).reshape(
            16, b, k))
        mat = _vandermonde_int_rows(tuple(range(1, m + 1)), k)
        _, band, _ = bm._band_device(mat, dev)
        fold = _fold_array(fo._bal_fold_init(k), fo._bal_bias(k))
        mb = _gemm_plan(k, b, nsm)
        out = torch.empty((8, b, m), dtype=torch.int32, device=dev)
        for name, lib in libs.items():
            if name in ("fetch_after_fold", "cluster2"):
                continue
            def run():
                return lib.hb_band_matmul(a.data_ptr(), band.data_ptr(),
                                          out.data_ptr(), b, k, m, mb, fold,
                                          stream)
            if run() != 0:
                raise SystemExit(f"band_matmul {name} launch failed")
            say(kernel="band_matmul", variant=name, B=b, k=k, m=m,
                lanes_per_block=64 * mb, ms=ev_ms(run))
        del a, out
    for n, k, c in K1_SHAPES:
        pts = tuple(range(1, n + 1))
        view = fo.pack_limbs(fk.rand_limbs((5, c), n * k * c, dev).reshape(
            16, n, k, c)).contiguous()
        kern = fo._open_bands(pts, k, dev)[0][0][3]
        fold = _fold_array(fo._bal_fold_init(k), fo._bal_bias(k))
        mb = _gemm_plan(k, n * c, nsm)
        out = torch.empty((8, n, n, c), dtype=torch.int32, device=dev)
        for name, lib in libs.items():
            if name in ("rows_out", "fetch_after_fold", "cluster2"):
                continue
            def run():
                return lib.hb_open_fused_k1(view.data_ptr(), kern.data_ptr(),
                                            out.data_ptr(), n, k, c, mb,
                                            fold, stream)
            if run() != 0:
                raise SystemExit(f"K1 {name} launch failed")
            say(kernel="open_fused_k1", variant=name, n=n, k=k, C=c,
                lanes_per_block=64 * mb, ms=ev_ms(run))
        del view, out
    for n, k, c in K2_SHAPES:
        pts, cols = k2_input(n, k, c)
        tiles = fo._open_bands(pts, k, dev)[0][1][3]
        fold = _fold_array(fo._bal_fold_init(k), fo._bal_bias(k))
        mb = _gemm_plan(k, n * c, nsm)
        vals = torch.empty((8, n, c), dtype=torch.int32, device=dev)
        errs = torch.zeros(n, dtype=torch.int32, device=dev)
        fit = [b for b in (4, 2, 1) if bg.smem_bytes(k, b) <= bg.SMEM_MAX]
        for name, b in [(v, mb) for v in K2_VARIANTS] + [
                ("final", b) for b in fit if b != mb]:
            def run():
                return libs[name].hb_open_fused_k2(
                    cols.data_ptr(), tiles.data_ptr(), vals.data_ptr(),
                    errs.data_ptr(), n, k, c, b, fold, stream)
            if run() != 0:
                raise SystemExit(f"K2 {name} launch failed")
            say(kernel="open_fused_k2", variant=name, n=n, k=k, C=c,
                lanes_per_block=64 * b, planned=b == mb, ms=ev_ms(run))
        del cols, vals
    n, t, sp = EXTRACT_PC
    n_out, n_outp, ncheckp = n - 2 * t, 24, 48
    cols, band = extract_pc_input(n, t, sp)
    tiles = band.reshape(-1)[torch.from_numpy(
        _gemm_band_index(band.shape[0] // 32, n, n, band.shape[1])).to(dev)]
    fold = _fold_array(fo._bal_fold_init(n), fo._bal_bias(n))
    mb = _gemm_plan(n, n * sp, nsm)
    keep = torch.empty((8, n, n_outp, sp), dtype=torch.int32, device=dev)
    chk = torch.empty((8, n, ncheckp, sp), dtype=torch.int32, device=dev)
    for name in NEW_VARIANTS:
        def run():
            return libs[name].hb_randousha_extract_pc(
                cols.data_ptr(), tiles.data_ptr(), keep.data_ptr(),
                chk.data_ptr(), n, sp, n_out, n_outp, ncheckp, mb, fold,
                stream)
        if run() != 0:
            raise SystemExit(f"extract_pc {name} launch failed")
        say(kernel="randousha_extract_pc", variant=name, n=n, t=t, sp=sp,
            lanes_per_block=64 * mb, ms=ev_ms(run))
    del keep, chk, cols, tiles
    time_compare_variants(libs, nsm, stream)
    time_deal_variants(libs, nsm, stream)


def fitting_tiles(k):
    """The lane tiles (64-lane blocks per thread block) whose planes fit a
    block's shared memory at contraction length k."""
    from honeybadgermpc_tpu_torch.ops import band_gemm as bg
    return [b for b in (4, 2, 1) if bg.smem_bytes(k, b) <= bg.SMEM_MAX]


def time_compare_variants(libs, nsm, stream):
    """The direct open (row 1) at one segment of the open, honest and with
    21 faulty parties, and the per-column check (row 6) at both degrees, on
    NEW_VARIANTS at every lane tile that fits."""
    import torch
    from honeybadgermpc_tpu_torch.ops import band_gemm as bg
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod
    from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
    dev = torch.device("cuda")
    n, t, b = DIRECT
    k = t + 1
    pts, shares = direct_input(n, t, b)
    tiles = torch.from_numpy(fod._direct_tiles(pts, k)).to(dev)
    fold = bg._fold_array(fo._bal_fold_init(k), fo._bal_bias(k))
    plan = bg._gemm_plan(k, b, nsm)
    sec = torch.empty((8, b), dtype=torch.int32, device=dev)
    nerr = torch.zeros(n, dtype=torch.int32, device=dev)
    for case, x in (("honest", shares), ("faulty", faulty(shares, n, t))):
        for name in NEW_VARIANTS:
            for m in fitting_tiles(k):
                def run():
                    return libs[name].hb_open_direct(
                        x.data_ptr(), tiles.data_ptr(), sec.data_ptr(),
                        nerr.data_ptr() + 4 * k, n, k, b, m, fold, stream)
                if run() != 0:
                    raise SystemExit(f"open_direct {name} launch failed")
                say(kernel="open_direct", variant=name, case=case, n=n,
                    k=k, B=b, lanes_per_block=64 * m, planned=m == plan,
                    ms=ev_ms(run))
    del shares, sec
    n, t, sp, ncheckp = CHECK
    pts = fr._party_points(n)
    for k, chk in check_inputs():
        tiles = fo._open_bands(pts, k, dev)[0][1][3]
        fold = bg._fold_array(fo._bal_fold_init(k), fo._bal_bias(k))
        plan = bg._gemm_plan(k, ncheckp * sp, nsm)
        vals = torch.empty((8, ncheckp, sp), dtype=torch.int32, device=dev)
        errs = torch.zeros((ncheckp, sp), dtype=torch.int32, device=dev)
        for name in NEW_VARIANTS:
            for m in fitting_tiles(k):
                def run():
                    return libs[name].hb_randousha_check(
                        chk.data_ptr(), tiles.data_ptr(), vals.data_ptr(),
                        errs.data_ptr(), n, k, sp, ncheckp, m, fold, stream)
                if run() != 0:
                    raise SystemExit(f"randousha_check {name} launch failed")
                say(kernel="randousha_check", variant=name, n=n, k=k,
                    ncheckp=ncheckp, sp=sp, lanes_per_block=64 * m,
                    planned=m == plan, ms=ev_ms(run))
        del chk, vals, errs


def direct_input(n, t, b):
    """b consistent degree-t sharings at the points 1..n, packed [PL, n, b]
    (band_matmul of drawn coefficients, as chip_smoke.py deals them)."""
    import torch
    from honeybadgermpc_tpu_torch.ops import band_matmul as bm
    from honeybadgermpc_tpu_torch.ops import field_kernels as fk
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    from honeybadgermpc_tpu_torch.ops.fpmatmul import _vandermonde_int_rows
    k = t + 1
    coeffs = fo.pack_limbs(fk.rand_limbs((31, n), b * k, torch.device(
        "cuda")).reshape(16, b, k))
    mat = _vandermonde_int_rows(tuple(range(1, n + 1)), k)
    shares = bm.band_matmul_packed(coeffs, mat).permute(0, 2, 1)
    return tuple(range(1, n + 1)), shares.contiguous()


def faulty(shares, n, t):
    """The shares with t parties spread over 0..n-1 faulty in every lane
    (chip_smoke.py's t_faulty_parties case)."""
    x = shares.clone()
    for p in sorted({(i * n) // t for i in range(t)}):
        x[p % 8, p] ^= p + 1
    return x


def check_inputs():
    """(k, the check tensor [PL, n, ncheckp, sp]) of the per-column
    pipeline at degree t and 2t: the deal, then the per-column
    extraction."""
    import torch
    from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
    dev = torch.device("cuda")
    n, t, sp, ncheckp = CHECK
    pts = fr._party_points(n)
    band = fr._encode_band_device(pts, n, dev)[0]
    for degree in (t, 2 * t):
        cols = fr.randousha_deal((61, degree), n, t, degree, sp, pts, dev)
        _, chk = fr.randousha_extract(cols, band, n - 2 * t,
                                      -(-(n - 2 * t) // 8) * 8, ncheckp)
        del cols
        yield degree + 1, chk


def tile_runs(k, plan):
    """(variant, lane tile) pairs the deal and the aggregated extraction
    are timed on: DEAL_VARIANTS at the plan, final at every other tile
    that fits, cluster2 at every tile that fits."""
    from honeybadgermpc_tpu_torch.ops import band_gemm as bg
    fit = [b for b in (4, 2, 1) if bg.smem_bytes(k, b) <= bg.SMEM_MAX]
    return ([(v, plan) for v in DEAL_VARIANTS]
            + [("final", b) for b in fit if b != plan]
            + [("cluster2", b) for b in fit])


def time_deal_variants(libs, nsm, stream):
    """The deal at t and 2t at every lane tile that fits, and the
    aggregated extraction of its degree-t receive tensor, on the variants
    of DEAL_VARIANTS."""
    import torch
    from honeybadgermpc_tpu_torch.ops import band_gemm as bg
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
    dev = torch.device("cuda")
    n, t, sp = DEAL
    pts = fr._party_points(n)
    key = (77, 5)
    k0, k1 = key
    out = torch.empty((8, n, n, sp), dtype=torch.int32, device=dev)
    for degree in (t, 2 * t):
        rows = fr._deal_rows(t, degree)
        kk = len(rows)
        tiles = torch.from_numpy(fr._deal_band_tiles(pts, kk)).to(dev)
        fold = bg._fold_array(fo._bal_fold_init(kk), fo._bal_bias(kk))
        plan = fr._deal_plan(kk, n * sp, nsm)
        for name, b in tile_runs(kk, plan):
            def run():
                return libs[name].hb_randousha_deal(
                    k0, k1, tiles.data_ptr(), out.data_ptr(), n, sp, kk,
                    rows[1], b, fold, stream)
            if run() != 0:
                raise SystemExit(f"deal {name} launch failed")
            say(kernel="randousha_deal", variant=name, n=n, t=t,
                degree=degree, sp=sp, lanes_per_block=64 * b,
                planned=b == plan, ms=ev_ms(run))
    del out
    cols = fr.randousha_deal(key, n, t, t, sp, pts, dev)
    calls = fr._randousha_calls(n, t, sp, pts, device=dev)
    n_out, n_outp = calls.meta[:2]
    band = calls.folded_band(key)[0]
    tiles = band.reshape(-1)[torch.from_numpy(bg._gemm_band_index(
        band.shape[0] // 32, n, n_out + 1, band.shape[1])).to(dev)]
    fold = bg._fold_array(fo._bal_fold_init(n), fo._bal_bias(n))
    plan = bg._gemm_plan(n, n * sp, nsm)
    keep = torch.empty((8, n, n_outp, sp), dtype=torch.int32, device=dev)
    z = torch.empty((8, n, sp), dtype=torch.int32, device=dev)
    for name, b in tile_runs(n, plan):
        def run():
            return libs[name].hb_randousha_extract(
                cols.data_ptr(), tiles.data_ptr(), keep.data_ptr(),
                z.data_ptr(), n, sp, n_out, n_outp, b, fold, stream)
        if run() != 0:
            raise SystemExit(f"extract {name} launch failed")
        say(kernel="randousha_extract", variant=name, n=n, t=t, sp=sp,
            columns=n_out + 1, lanes_per_block=64 * b, planned=b == plan,
            ms=ev_ms(run))


def k2_input(n, k, c):
    """Consistent K2 input at n parties, k = t+1 or 2t+1, C chunks: K1 of
    dealt shares (a receive tensor of the deal, its first k dealers' words
    read as every party's k coefficients), as the fallback programs give
    it. -> (points, cols [PL, n, n, C])."""
    import torch
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
    pts = tuple(range(1, n + 1))
    t = (n - 1) // 3
    recv = fr.randousha_deal((5, c), n, t, k - 1, -(-c // 128) * 128, pts,
                             torch.device("cuda"))
    view = recv[:, :, :k, :c].contiguous()
    del recv
    return pts, fo.open_k1(view, pts)


def extract_pc_input(n, t, sp):
    """A receive tensor of the degree-t deal and the n-point band."""
    import torch
    from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
    dev = torch.device("cuda")
    pts = fr._party_points(n)
    return (fr.randousha_deal((61, t), n, t, t, sp, pts, dev),
            fr._encode_band_device(pts, n, dev)[0])


def time_tree(tag):
    """band_matmul, K1, K2 and the per-column extraction of the tree this
    process imports, through their wrappers (whatever design that tree
    has)."""
    import torch
    from honeybadgermpc_tpu_torch.ops import band_matmul as bm
    from honeybadgermpc_tpu_torch.ops import field_kernels as fk
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    from honeybadgermpc_tpu_torch.ops import fused_randousha as fr
    from honeybadgermpc_tpu_torch.ops.fpmatmul import _vandermonde_int_rows
    dev = torch.device("cuda")
    for b, k, m in BAND_SHAPES:
        a = fo.pack_limbs(fk.rand_limbs((21, k), b * k, dev).reshape(
            16, b, k))
        mat = _vandermonde_int_rows(tuple(range(1, m + 1)), k)
        say(kernel="band_matmul", tree=tag, B=b, k=k, m=m,
            ms=ev_ms(lambda: bm.band_matmul_packed(a, mat)))
        del a
    for n, k, c in K1_SHAPES:
        pts = tuple(range(1, n + 1))
        view = fo.pack_limbs(fk.rand_limbs((5, c), n * k * c, dev).reshape(
            16, n, k, c)).contiguous()
        say(kernel="open_fused_k1", tree=tag, n=n, k=k, C=c,
            ms=ev_ms(lambda: fo.open_k1(view, pts)))
        del view
    for n, k, c in K2_SHAPES:
        pts, cols = k2_input(n, k, c)
        _, errs = fo.open_k2(cols, pts, k)
        if errs.any():
            raise SystemExit(f"K2 input not consistent at {(n, k, c)}")
        say(kernel="open_fused_k2", tree=tag, n=n, k=k, C=c,
            ms=ev_ms(lambda: fo.open_k2(cols, pts, k)))
        del cols
    from honeybadgermpc_tpu_torch.ops import fused_open_direct as fod
    n, t, b = DIRECT
    pts, shares = direct_input(n, t, b)
    for case, x in (("honest", shares), ("faulty", faulty(shares, n, t))):
        say(kernel="open_direct", tree=tag, case=case, n=n, k=t + 1, B=b,
            ms=ev_ms(lambda: fod._open_direct_cuda(x, n, t + 1, pts)))
    del shares, x
    n, t, sp, ncheckp = CHECK
    pts = fr._party_points(n)
    for k, chk in check_inputs():
        say(kernel="randousha_check", tree=tag, n=n, k=k, ncheckp=ncheckp,
            sp=sp, ms=ev_ms(lambda: fr.randousha_check(chk, k, pts)))
        del chk
    n, t, sp = EXTRACT_PC
    cols, band = extract_pc_input(n, t, sp)
    say(kernel="randousha_extract_pc", tree=tag, n=n, t=t, sp=sp,
        ms=ev_ms(lambda: fr.randousha_extract(cols, band, n - 2 * t, 24,
                                              48)))
    del cols, band
    n, t, sp = DEAL
    pts = fr._party_points(n)
    key = (77, 5)
    for degree in (t, 2 * t):
        say(kernel="randousha_deal", tree=tag, n=n, t=t, degree=degree,
            sp=sp, ms=ev_ms(lambda: fr.randousha_deal(key, n, t, degree, sp,
                                                      pts, dev)))
    cols = fr.randousha_deal(key, n, t, t, sp, pts, dev)
    calls = fr._randousha_calls(n, t, sp, pts, device=dev)
    n_out, n_outp = calls.meta[:2]
    band = calls.folded_band(key)[0]
    say(kernel="randousha_extract", tree=tag, n=n, t=t, sp=sp,
        ms=ev_ms(lambda: fr.randousha_extract(cols, band, n_out, n_outp)))


# -- rows 13 and 14: the MXU field matmuls ------------------------------------

# (row, B, k, n): row 13's two robust-open shapes and its k-streamed one,
# row 14's ntl shape
MXU_SHAPES = ((13, 49152, 22, 43), (13, 49152, 22, 64), (13, 16896, 438, 4),
              (14, 16896, 512, 4))
MXU_VARIANTS = ("final", "no_epilogue", "no_dot", "no_planes", "no_store",
                "stream_only")
# the profiler's kernel names hold the epilogue type of each row
MXU_KERNEL_NAME = {13: "Fold37", 14: "Redc73"}


def _mxu_old_patches():
    """Knock-outs of mxu_core.cuh's mxu_stream_kernel (the mma.sync stream
    kernel rows 13 and 14 ran on before the wgmma core took them)."""
    dot = ("mma_s8(acc[mt][nt], af[mt], b0w, b1w);",
           "{ acc[mt][nt][0] += b0w ^ af[mt].x; "
           "acc[mt][nt][1] += b1w ^ af[mt].w; }")
    planes = [("    build(0);\n", ""), ("        build(c);\n", "")]
    store = ("        out[j * Bn + static_cast<size_t>(b) * n + col] = "
             "limbs[j];",
             "        if ((limbs[0] ^ limbs[15]) == 0x9e3779b9u) "
             "out[j * Bn + static_cast<size_t>(b) * n + col] = limbs[j];")
    noepi = ("CUT", "    // transpose: thread laneid takes",
             "  }\n}\n\n// Launch one instance",
             "    if (acc[0][0][0] == 0x7fffffff && acc[MT - 1][3][3] == 3) "
             "__trap();\n")
    return {"final": [], "no_epilogue": [noepi], "no_dot": [dot],
            "no_planes": planes, "no_store": [store],
            "stream_only": [noepi, dot] + planes}


def _mxu_new_patches():
    """Knock-outs of band_gemm.cuh's mxu_gemm_body (rows 13 and 14 on the
    wgmma core)."""
    dot = ("mxu_wgmma(acc[mb], da, db, ks > 0);", "(void)da; (void)db;")
    planes = [("    for (int oct = bw; kk0 < k && oct < OCT; oct += 4) {",
               "    for (int oct = bw; false && oct < OCT; oct += 4) {")]
    magic = "if ((limbs[0] ^ limbs[15]) == 0x9e3779b9u) "
    no_transpose = ("  // (the transpose)\n", "  return;\n")
    store = [("          dst[static_cast<size_t>(j) * ncolsp * TM] =\n"
              "              static_cast<uint16_t>(limbs[j]);",
              "          " + magic +
              "dst[static_cast<size_t>(j) * ncolsp * TM] =\n"
              "              static_cast<uint16_t>(limbs[j]);"),
             ("          dst[static_cast<size_t>(j) * Bn] = limbs[j];",
              "          " + magic + "dst[static_cast<size_t>(j) * Bn] = "
              "limbs[j];"),
             no_transpose]
    noepi = ("CUT", "    // the epilogue: exchange, fold, store",
             "    // end of the epilogue",
             "      if (acc[0][0] == 0x7fffffff && acc[MB - 1][39] == 3) "
             "__trap();\n")
    return {"final": [], "no_epilogue": [noepi, no_transpose],
            "no_dot": [dot], "no_planes": planes, "no_store": store,
            "stream_only": [noepi, no_transpose, dot] + planes,
            "no_transpose": [no_transpose],
            "cluster2": _mxu_cluster2()}


def _mxu_cluster2():
    """Row 13 with resident planes in thread-block clusters of two
    neighbouring 128-lane blocks (the same tile walk) that share their band
    stream, as _cluster2 does for the core: each producer copies half of
    every ring slot and multicasts it to both blocks, so each block reads
    half the band from L2; a slot is refilled when the consumers of both
    blocks are done with it. Only for the resident launch (one tile group);
    the row-14 kernel in this build is not launched."""
    return [
        ("// Shared-memory matrix descriptor, no swizzle",
         _CLUSTER_HELPERS + "// Shared-memory matrix descriptor, no swizzle"),
        ("      mbar_init(empty_s + 8 * s, 4);\n    }\n    for (int b = 0;",
         "      mbar_init(empty_s + 8 * s, 8);\n    }\n    for (int b = 0;"),
        ("  __syncthreads();\n\n  if (warp >= MXU_CONS * 4 + 4) {",
         "  __syncthreads();\n"
         "  uint32_t rank;\n"
         "  asm volatile(\"mov.u32 %0, %%cluster_ctarank;\\n\" : \"=r\"(rank));\n"
         "  asm volatile(\"barrier.cluster.arrive.release.aligned;\\n\"\n"
         "               \"barrier.cluster.wait.acquire.aligned;\\n\" ::: "
         "\"memory\");\n\n  if (warp >= MXU_CONS * 4 + 4) {"),
        ("      bulk_load(ring_s + slot * MXU_SLOT_BYTES,\n"
         "                band + (static_cast<size_t>(ct) * ksteps + kk0) *\n"
         "                           MXU_STEP_BYTES,\n"
         "                steps * MXU_STEP_BYTES, full_s + 8 * slot);\n",
         "      const uint32_t half = steps * MXU_STEP_BYTES / 2;\n"
         "      bulk_load_multicast(ring_s + slot * MXU_SLOT_BYTES + rank * half,"
         "\n                          band + (static_cast<size_t>(ct) * ksteps"
         " + kk0) * MXU_STEP_BYTES + rank * half,\n"
         "                          half, full_s + 8 * slot);\n"),
        ("  const size_t Bn = static_cast<size_t>(B) * n;\n  int acc[MB][40];",
         "  const size_t Bn = static_cast<size_t>(B) * n;\n"
         "  const int nload_c = ((t1 - t0 - wgi + MXU_CONS - 1) / MXU_CONS) *\n"
         "                      ((ksteps + MXU_KS - 1) / MXU_KS);\n"
         "  auto release = [&](int ld) {\n"
         "    const uint32_t bar = empty_s + 8 * (wgi * MXU_SLOTS + ld % "
         "MXU_SLOTS);\n"
         "    mbar_arrive(bar);\n"
         "    if (ld + MXU_SLOTS < nload_c) mbar_arrive_peer(bar, rank ^ 1u);\n"
         "  };\n  int acc[MB][40];"),
        ("          mbar_arrive(empty_s + 8 * (wgi * MXU_SLOTS + (sr - 1) % "
         "MXU_SLOTS));", "          release(sr - 1);"),
        ("      mbar_arrive(empty_s + 8 * (wgi * MXU_SLOTS + (sr - 1) % "
         "MXU_SLOTS));", "      release(sr - 1);"),
    ]


_MXU_CLUSTER_LAUNCH = (
    "  const unsigned grid = static_cast<unsigned>((B + 127) / 128 * tgroups);\n"
    "  kern<<<grid, gemm::MXU_THREADS, smem, static_cast<cudaStream_t>(stream)"
    ">>>(\n"
    "      static_cast<const uint32_t*>(a),\n"
    "      static_cast<const unsigned char*>(band), static_cast<uint32_t*>(out),"
    "\n      static_cast<uint16_t*>(tmp), B, k, n, tgroups, nbuf);\n",
    "  const long long blocks = (B + 127) / 128 * tgroups;\n"
    "  cudaLaunchConfig_t cfg = {};\n"
    "  cfg.gridDim = dim3(static_cast<unsigned>((blocks + 1) / 2 * 2));\n"
    "  cfg.blockDim = dim3(gemm::MXU_THREADS);\n"
    "  cfg.dynamicSmemBytes = smem;\n"
    "  cfg.stream = static_cast<cudaStream_t>(stream);\n"
    "  cudaLaunchAttribute attr[1];\n"
    "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
    "  attr[0].val.clusterDim.x = 2;\n"
    "  attr[0].val.clusterDim.y = 1;\n"
    "  attr[0].val.clusterDim.z = 1;\n"
    "  cfg.attrs = attr;\n"
    "  cfg.numAttrs = 1;\n"
    "  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const uint32_t*>(a),\n"
    "      static_cast<const unsigned char*>(band), static_cast<uint32_t*>(out),"
    "\n      static_cast<uint16_t*>(tmp), B, k, n, tgroups, nbuf);\n"
    "  if (err != cudaSuccess) return static_cast<int>(err);\n")


def _patch(src, patches, what):
    for p in patches:
        if p[0] == "CUT":
            _, start, end, repl = p
            if start not in src or end not in src:
                raise SystemExit(f"{what}: patch anchor missing")
            a, b = src.index(start), src.index(end)
            src = src[:a] + repl + src[b:]
        else:
            if p[0] not in src:
                raise SystemExit(f"{what}: patch anchor missing: {p[0]!r}")
            src = src.replace(p[0], p[1])
    return src


def build_mxu_variants(csrc, work):
    """Knock-out variants of the core that rows 13 and 14 run on in the
    checkout whose kernel sources are `csrc`: mxu_core.cuh's stream kernel
    (before the wgmma core took them) or band_gemm.cuh's mxu_gemm_body.
    -> ({variant: CDLL holding hb_mxu_fused2 and hb_mxu_fused}, core)."""
    core_src = open(os.path.join(csrc, "mxu_core.cuh")).read()
    old = "mxu_stream_kernel" in core_src
    header = "mxu_core.cuh" if old else "band_gemm.cuh"
    base = open(os.path.join(csrc, header)).read()
    patches = _mxu_old_patches() if old else _mxu_new_patches()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, pset in patches.items():
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        for fn in os.listdir(csrc):
            if fn.endswith((".cuh", ".cu")):
                shutil.copy(os.path.join(csrc, fn), d)
        with open(os.path.join(d, header), "w") as f:
            f.write(_patch(base, pset, f"mxu variant {name}"))
        if name == "cluster2":
            fn = os.path.join(d, "mxu_fused2.cu")
            src = _patch(open(fn).read(), [_MXU_CLUSTER_LAUNCH],
                         "mxu variant cluster2 (launch)")
            with open(fn, "w") as f:
                f.write(src)
        so = os.path.join(d, "libmxu.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
             os.path.join(d, "mxu_fused2.cu"), os.path.join(d, "mxu_fused.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"mxu variant {name} does not build:\n{out}")
        libs[name] = ctypes.CDLL(so)
    return libs, "mma.sync stream kernel (mxu_core.cuh)" if old else \
        "wgmma core (band_gemm.cuh)"


class _LibProxy:
    """The tree's kernel library with the entries `fns` (by default
    hb_mxu_fused2 and hb_mxu_fused) taken from a variant build (same
    argument types)."""

    def __init__(self, real, var, fns=("hb_mxu_fused2", "hb_mxu_fused")):
        self._real = real
        for fn in fns:
            f = getattr(var, fn)
            f.argtypes = getattr(real, fn).argtypes
            f.restype = getattr(real, fn).restype
            setattr(self, fn, f)

    def __getattr__(self, name):
        return getattr(self._real, name)


def kernel_ms(fn, reps, name):
    """Mean device time of the kernel whose profiler name holds `name`,
    one launch per call of fn(); CUDA events when the trace holds fewer
    than half the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    if total <= 0.0 or 2 * count < reps:
        return ev_ms(fn, reps), "cuda_events"
    return total / count / 1e3, "profiler"


def mxu_inputs(row, b, k, n):
    """Montgomery limbs a [L, B, k], v [L, k, n] (and row 13's band digits)
    -> (launch thunk through the wrapper, plain thunk)."""
    import torch
    from honeybadgermpc_tpu_torch.ops import field_kernels as fk
    from honeybadgermpc_tpu_torch.ops import mxu_matmul as mxu
    dev = torch.device("cuda")
    a = fk.rand_limbs((91, b + k), b * k, dev).reshape(16, b, k)
    v = fk.rand_limbs((92, n + k), k * n, dev).reshape(16, k, n)
    if row == 13:
        r = mxu._rounds_for(k)
        wd = mxu._folded_band_digits(v, r)
        return (lambda: mxu._fused2_cuda(a, wd, r),
                lambda: mxu._fused2_plain(a, wd, r))
    return (lambda: mxu._fused_cuda(a, v), lambda: mxu._fused_plain(a, v))


def time_mxu(tag, work, variants=True):
    """Rows 13 and 14 of the tree this process imports at MXU_SHAPES:
    through its wrappers (the kernel's own device time), and with
    `variants` its core's knock-outs too. The final variant is held
    against the plain version once per shape."""
    import torch
    import honeybadgermpc_tpu_torch as pkg
    from honeybadgermpc_tpu_torch import _build
    real = _build.lib()
    csrc = os.path.join(os.path.dirname(pkg.__file__), "csrc")
    libs, core = (build_mxu_variants(csrc, work) if variants
                  else ({"final": None}, ""))
    for row, b, k, n in MXU_SHAPES:
        run, plain = mxu_inputs(row, b, k, n)
        for name, var in libs.items():
            if name == "cluster2" and (row != 13 or k > 38):
                continue                   # resident row 13 only
            _build._lib = real if var is None else _LibProxy(real, var)
            if name == "final" and var is not None:
                got = run()
                ok = bool(torch.equal(got, plain()))
                if not ok:
                    raise SystemExit(f"row {row} final != plain at "
                                     f"{(b, k, n)} ({tag})")
            ms, by = kernel_ms(run, 10, MXU_KERNEL_NAME[row])
            rec = dict(kernel=f"row{row}", tree=tag, B=b, k=k, n=n, ms=ms,
                       timed_by=by)
            if var is not None:
                rec.update(variant=name, core=core)
            say(**rec)
        _build._lib = real
        torch.cuda.empty_cache()


# -- rows 2 and 18: the field sampler and K3 ----------------------------------

RAND_NUMEL = 16896 * 21               # SEG x T: the open path's dealer draw
K3_SHAPES = ((64, 22, 7820), (64, 43, 4001))   # n, k, C on the fallback runs
# (64-lane blocks per thread block, column groups) K3 is timed at on the
# core, where the planes fit shared memory and every consumer warpgroup
# gets a tile
K3_PLANS = ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4), (2, 8), (4, 1),
            (4, 2), (4, 4), (4, 8))


def sass_mix(so, kernel):
    """Static SASS instruction counts of the function whose mangled name
    holds `kernel` in the shared library `so` (cuobjdump): {opcode with
    its modifiers: count}, and the total under key "total"."""
    import collections
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    mix, inside = collections.Counter(), False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      ln)
        if inside and m:
            mix[m.group(1)] += 1
    mix["total"] = sum(mix.values())
    return dict(mix)


def _sampler_patches(src):
    """Knock-outs of csrc/rand_limbs.cu as the checkout has it: the 16-bit
    kernel (one thread per element, field_core.cuh's redc384) or the word
    kernel (redc384_words, a grid-stride loop over pairs of elements)."""
    if "redc384(rows, limbs);" in src:
        draw = ("    threefry2x32(k0, k1, static_cast<uint32_t>(s), "
                "static_cast<uint32_t>(e),\n                 w0, w1);",
                "    w0 = static_cast<uint32_t>(e) * 0x9E3779B9u + k0 + s;\n"
                "    w1 = w0 ^ (k1 + s);")
        redc = ("  redc384(rows, limbs);",
                "#pragma unroll\n  for (int j = 0; j < L; ++j) "
                "limbs[j] = rows[j] ^ rows[j + 8];")
        return {"final": [], "threefry_only": [redc],
                "reduction_only": [draw], "store_only": [draw, redc]}
    draw = ("        threefry2x32(k0, k1, s, c1, x[u][2 * s], x[u][2 * s + 1]);",
            "        { x[u][2 * s] = c1 * 0x9E3779B9u + k0 + s;\n"
            "          x[u][2 * s + 1] = x[u][2 * s] ^ (k1 + s); }")
    redc = ("      redc384_words(x[u], words[u]);",
            "#pragma unroll\n      for (int j = 0; j < PL; ++j) "
            "words[u][j] = x[u][j] ^ x[u][j + 4];")
    return {"final": [], "threefry_only": [redc], "reduction_only": [draw],
            "store_only": [draw, redc],
            "one_element": [("constexpr int RAND_EPT = 2;",
                             "constexpr int RAND_EPT = 1;")],
            "full_grid": [("  const long long waves = 1;",
                           "  const long long waves = (numel + per_wave - 1)"
                           " / per_wave;")]}


def _k3_old_patches():
    """Knock-outs of open_fused.cu's mma.sync K3 (before the wgmma core took
    it): {variant: {file: patches}}."""
    dot = ("      mma_s8(acc[0][nt], a_lo, b0, b1);\n"
           "      mma_s8(acc[1][nt], a_hi, b0, b1);",
           "      acc[0][nt][0] += b0 ^ a_lo.x;\n"
           "      acc[1][nt][1] += b1 ^ a_hi.w;")
    planes = ("  for (int i = slot; i < k; i += wg) {",
              "  for (int i = slot; false && i < k; i += wg) {")
    noepi = ("CUT", "    int32_t ds[NBAL];\n",
             "  // the column slots of a lane add into one count",
             "    if (acc[0][0][0] == 0x7fffffff && acc[1][3][3] == 3) "
             "bad += 1;\n  }\n")
    return {"final": {},
            "no_epilogue": {"open_fused.cu": [noepi]},
            "no_dot": {"field_core.cuh": [dot]},
            "no_planes": {"open_fused.cu": [planes]},
            "stream_only": {"open_fused.cu": [noepi, planes],
                            "field_core.cuh": [dot]}}


def build_r2_r18_variants(csrc, work):
    """Knock-out variants of the sampler and of K3 as the checkout whose
    kernel sources are `csrc` has them. -> ({("rand" | "k3", variant):
    CDLL}, K3's core: "mma.sync" or "wgmma")."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    text = {fn: open(os.path.join(csrc, fn)).read() for fn in os.listdir(csrc)
            if fn.endswith((".cu", ".cuh"))}
    old_k3 = "open_fused_k3_kernel(" in text["open_fused.cu"]
    jobs = {}
    for name, pset in _sampler_patches(text["rand_limbs.cu"]).items():
        jobs["rand", name] = ("rand_limbs.cu",
                              {"rand_limbs.cu": _patch(
                                  text["rand_limbs.cu"], pset,
                                  f"sampler variant {name}")})
    if old_k3:
        for name, files in _k3_old_patches().items():
            jobs["k3", name] = ("open_fused.cu", {
                fn: _patch(text[fn], pset, f"K3 variant {name}")
                for fn, pset in files.items()})
    else:
        core = _patches()
        core["slots4"] = [("constexpr int SLOTS = 2;",
                           "constexpr int SLOTS = 4;")]
        core["ks8"] = [("constexpr int KS = 4;", "constexpr int KS = 8;")]
        for name in NEW_VARIANTS + ("no_planes", "slots4", "ks8"):
            jobs["k3", name] = ("open_fused.cu", {
                "band_gemm.cuh": _source(name, core[name],
                                         text["band_gemm.cuh"])})
    procs = {}
    for (kind, name), (main, files) in jobs.items():
        d = os.path.join(work, f"{kind}_{name}")
        os.makedirs(d, exist_ok=True)
        for fn, src in text.items():
            with open(os.path.join(d, fn), "w") as f:
                f.write(files.get(fn, src))
        so = os.path.join(d, "lib.so")
        procs[kind, name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
             os.path.join(d, main)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {key} does not build:\n{out}")
        libs[key] = ctypes.CDLL(so)
    return libs, "mma.sync" if old_k3 else "wgmma"


def k3_input(n, k, c):
    """Consistent K3 input vals [PL, n, C]: K2 of k2_input's columns."""
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    pts, cols = k2_input(n, k, c)
    vals, errs = fo.open_k2(cols, pts, k)
    if errs.any():
        raise SystemExit(f"K3 input not consistent at {(n, k, c)}")
    return pts, vals


def time_r2_r18(tag, work):
    """Rows 2 and 18 of the tree this process imports, through its
    wrappers (the kernel's device time from the profiler): the sampler at
    SEG x T and K3 at K3_SHAPES, honest and with faults, on their
    knock-out variants; K3 on the wgmma core also at every column-group
    count of K3_GROUPS. The final variants are held against the plain
    versions."""
    import torch
    import honeybadgermpc_tpu_torch as pkg
    from honeybadgermpc_tpu_torch import _build
    from honeybadgermpc_tpu_torch.ops import field_kernels as fk
    from honeybadgermpc_tpu_torch.ops import fused_open as fo
    dev = torch.device("cuda")
    real = _build.lib()
    csrc = os.path.join(os.path.dirname(pkg.__file__), "csrc")
    libs, core = build_r2_r18_variants(csrc, work)
    for (kind, name), var in libs.items():
        if kind != "rand":
            continue
        _build._lib = _LibProxy(real, var, ("hb_rand_limbs",))
        run = lambda: fk._rand_limbs_cuda((1, 2), RAND_NUMEL, dev)  # noqa
        if name == "final" and not torch.equal(
                run(), fk._rand_limbs_plain((1, 2), RAND_NUMEL, dev)):
            raise SystemExit(f"sampler final != plain ({tag})")
        ms, by = kernel_ms(run, 50, "rand_limbs")
        wave = None
        if hasattr(var, "hb_rand_limbs_wave"):      # the word kernel's grid
            var.hb_rand_limbs_wave.restype = ctypes.c_longlong
            wave = var.hb_rand_limbs_wave()
        say(kernel="row2", tree=tag, variant=name, numel=RAND_NUMEL, ms=ms,
            timed_by=by, elements_per_wave=wave)
        if name == "final":
            say(kernel="row2", tree=tag, variant=name,
                sass=sass_mix(var._name, "rand_limbs_kernel"))
    _build._lib = real
    split = getattr(fo, "_gemm_split", None)
    for n, k, c in K3_SHAPES:
        pts, vals = k3_input(n, k, c)
        bad = vals.clone()
        bad[5, n - 1, c // 2] ^= 0x100
        bad[0, k, 0] ^= 1
        from honeybadgermpc_tpu_torch.ops import band_gemm as bg
        fit = [] if split is None else [
            (mb, g) for mb, g in K3_PLANS
            if bg.smem_bytes(k, mb) <= bg.SMEM_MAX
            and g <= max(1, -(-n // 2) // bg.consumers(mb))]
        for (kind, name), var in libs.items():
            if kind != "k3":
                continue
            _build._lib = _LibProxy(real, var, ("hb_open_fused_k3",))
            plans = [None]
            if fit and name == "final":
                plans += fit
            elif fit and name in ("slots4", "ks8"):    # deeper band rings
                plans += [(1, 2)]
            elif fit:
                plans += [(1, 1)]
            for groups in plans:
                if groups is not None:
                    fo._gemm_split = (lambda p: lambda kk, nl, m, nsm=132:
                                      p)(groups)
                for case, x in (("honest", vals), ("faulty", bad)):
                    run = lambda: fo._open_k3_cuda(x, pts, k)  # noqa
                    try:
                        run()
                    except RuntimeError as exc:   # a ring past the smem
                        say(kernel="row18", tree=tag, variant=name,
                            n=n, k=k, C=c, forced=groups, failed=str(exc))
                        break
                    if name == "final":
                        sec, errs = run()
                        want = fo._k3_plain(x, pts, k)
                        if not (torch.equal(sec, want[0])
                                and torch.equal(errs, want[1])):
                            raise SystemExit(f"K3 final != plain at "
                                             f"{(n, k, c, groups)} ({tag})")
                    elif case == "faulty":
                        continue
                    ms, by = kernel_ms(run, 20, "open_fused_k3")
                    say(kernel="row18", tree=tag, variant=name, core=core,
                        case=case, n=n, k=k, C=c,
                        forced=groups,
                        plan=(None if split is None else
                              list(split(k, c, n,
                                         torch.cuda.get_device_properties(
                                             dev).multi_processor_count))),
                        ms=ms, timed_by=by)
                if split is not None:
                    fo._gemm_split = split
        del vals, bad
        torch.cuda.empty_cache()
    _build._lib = real

# -- rows 7 and 12: the packed triple finish and the small-batch CIOS matmul --

R7_SHAPE = (8, 64, 24, 4096)          # [PL, n, R, S]: the packed triple call
R7_PADS = (37, 0)                     # the call's pad to 2t+1 = 43, and none
# (B, k, n): robust_open_single's decode first, then one decode, a square
# open at n = 64, a batch just under the MXU routes, and a contraction that
# takes the CIOS route at every batch (57 runs of 64 terms at split 1)
R12_SHAPES = ((64, 22, 43), (1, 22, 43), (64, 64, 64), (1000, 43, 64),
              (1, 3599, 2))
R12_SPLITS = (1, 2, 4, 8, 16, 32)


def _finish_cios_patches(text):
    """Knock-outs of row 7 (packed_arith.cu) and row 12 (fp_matmul_cios.cu)
    as the checkout has them: the 16-bit row 7 and the one-thread-per-output
    row 12 before their redesign, or the word kernels. -> {(row, variant):
    (file, patches)}."""
    r7, r12 = text["packed_arith.cu"], text["fp_matmul_cios.cu"]
    jobs = {("row7", "final"): ("packed_arith.cu", []),
            ("row12", "final"): ("fp_matmul_cios.cu", [])}
    if "mont_mul16(la, lb, prod);" in r7:           # before the redesign
        prod = ("  mont_mul16(la, lb, prod);",
                "  for (int j = 0; j < L; ++j) prod[j] = la[j] ^ lb[j];")
        jobs["row7", "no_product"] = ("packed_arith.cu", [prod])
    else:
        prod = ("  mont_mul_w(xa, xb, ab);",
                "  for (int w = 0; w < NW; ++w) ab[w] = xa[w] ^ xb[w];")
        store = ("CUT", "  uint32_t xa[NW], xb[NW], xc[NW], ab[NW], res[NW];",
                 "  const size_t plane =",
                 "  uint32_t res[NW];\n  for (int w = 0; w < NW; ++w) "
                 "res[w] = static_cast<uint32_t>(g) + w;\n")
        jobs["row7", "no_product"] = ("packed_arith.cu", [prod])
        jobs["row7", "store_only"] = ("packed_arith.cu", [store])
    if "mac_cols(cols, x, y);" in r12:               # the split kernel
        loads = ("      mac_cols(cols, x, y);",
                 "      for (int j = 0; j < NW; ++j) cols[j] ^= x[2 * j] ^ "
                 "x[2 * j + 1] ^ y[j];")
        redc = ("    redc_cols(cols, part);",
                "    for (int w = 0; w < NW; ++w) part[w] = static_cast<"
                "uint32_t>(cols[w] ^ (cols[NW + w] >> 7) ^ cols[2 * NW + w]"
                " ^ cols[3 * NW + w]);")
        fly = ("CUT", "#pragma unroll\n  for (int off = S / 2; off > 0;",
               "  if (o0 >= outputs) return;", "")
        jobs["row12", "no_reduction"] = ("fp_matmul_cios.cu", [redc])
        jobs["row12", "no_butterfly"] = ("fp_matmul_cios.cu", [fly])
        jobs["row12", "loads_stores"] = ("fp_matmul_cios.cu", [loads, redc])
    else:
        prod = ("      mont_mul_w(x, y, pr);",
                "      for (int q = 0; q < NW; ++q) pr[q] = x[q] ^ y[q];")
        jobs["row12", "no_product"] = ("fp_matmul_cios.cu", [prod])
    return jobs


def build_r7_r12_variants(csrc, work):
    """Knock-out variants of rows 7 and 12 as the checkout whose kernel
    sources are `csrc` has them, built in parallel. -> ({(row, variant):
    CDLL}, the ptxas report of each final build)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    text = {fn: open(os.path.join(csrc, fn)).read() for fn in os.listdir(csrc)
            if fn.endswith((".cu", ".cuh"))}
    procs = {}
    for (row, name), (main, pset) in _finish_cios_patches(text).items():
        d = os.path.join(work, f"{row}_{name}")
        os.makedirs(d, exist_ok=True)
        for fn, src in text.items():
            with open(os.path.join(d, fn), "w") as f:
                f.write(_patch(src, pset, f"{row} variant {name}")
                        if fn == main else src)
        so = os.path.join(d, "lib.so")
        procs[row, name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             so, os.path.join(d, main)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {key} does not build:\n{out}")
        libs[key] = ctypes.CDLL(so)
        if key[1] == "final":
            ptxas[key[0]] = [ln.strip() for ln in out.splitlines()
                             if "registers" in ln or "stack frame" in ln
                             or "entry function" in ln]
    return libs, ptxas


def time_r7_r12(tag, work):
    """Rows 7 and 12 of the tree this process imports, through its wrappers
    (the kernel's device time from the profiler): row 7 at R7_SHAPE with
    each pad, row 12 at R12_SHAPES, each on its knock-out variants, row 12's
    split kernel (final and loads_stores) also at every split of
    R12_SPLITS. The final variants are held against the plain versions."""
    import torch
    import honeybadgermpc_tpu_torch as pkg
    from honeybadgermpc_tpu_torch import _build
    from honeybadgermpc_tpu_torch.ops import field_kernels as fk
    from honeybadgermpc_tpu_torch.ops import montgomery as mont
    from honeybadgermpc_tpu_torch.ops.fpmatmul import _matmul_kernel
    from honeybadgermpc_tpu_torch.ops.fused_open import pack_limbs
    dev = torch.device("cuda")
    real = _build.lib()
    csrc = os.path.join(os.path.dirname(pkg.__file__), "csrc")
    libs, ptxas = build_r7_r12_variants(csrc, work)
    say(tree=tag, ptxas=ptxas)
    pl, n, r, s_ = R7_SHAPE
    numel = n * r * s_
    x = [pack_limbs(fk.rand_limbs((71, i), numel, dev)).reshape(R7_SHAPE)
         for i in range(3)]
    for pad in R7_PADS:
        for (row, name), var in libs.items():
            if row != "row7":
                continue
            _build._lib = _LibProxy(real, var, ("hb_mul_add_packed4",))
            run = lambda: fk.mul_add_packed4_flat(*x, pad=pad)  # noqa
            if name == "final":
                got = run()
                want = fk._mul_add_packed4_plain(*x).reshape(pl, n, r * s_)
                if not (torch.equal(got[:, :, :r * s_], want)
                        and not bool(got[:, :, r * s_:].any())):
                    raise SystemExit(f"row 7 final != plain at pad={pad} "
                                     f"({tag})")
            ms, by = kernel_ms(run, 20, "mul_add_packed4_kernel")
            say(kernel="row7", tree=tag, variant=name, shape=list(R7_SHAPE),
                pad=pad, ms=ms, timed_by=by)
    _build._lib = real
    del x
    torch.cuda.empty_cache()
    split_kernel = hasattr(fk, "_cios_plan")
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, k, n in R12_SHAPES:
        a = fk.rand_limbs((72, b + k), b * k, dev).reshape(16, b, k)
        v = fk.rand_limbs((73, n + k), k * n, dev).reshape(16, k, n)
        want = _matmul_kernel(a, v, mul=mont._mont_mul_plain)
        plan = fk._cios_plan(b, k, n, nsm) if split_kernel else None
        for (row, name), var in libs.items():
            if row != "row12":
                continue
            _build._lib = _LibProxy(real, var, ("hb_fp_matmul_cios",))
            splits = [None]
            if split_kernel and name in ("final", "loads_stores"):
                splits += [sp for sp in R12_SPLITS if sp != plan]
            for sp in splits:
                if sp is None:
                    run = lambda: fk.fp_matmul_pallas(a, v)  # noqa
                else:
                    run = lambda sp=sp: fk._fp_matmul_cios_cuda(  # noqa
                        a, v, sp)
                if name == "final" and not torch.equal(run(), want):
                    raise SystemExit(f"row 12 final != plain at "
                                     f"{(b, k, n, sp)} ({tag})")
                ms, by = kernel_ms(run, 50, "fp_matmul_cios_kernel")
                say(kernel="row12", tree=tag, variant=name, B=b, k=k, n=n,
                    split=plan if sp is None else sp, plan=sp is None,
                    ms=ms, timed_by=by)
        _build._lib = real


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout of the port to time "
                    "beside this one")
    ap.add_argument("--tree-only", metavar="TAG",
                    help="time this process's tree through its wrappers")
    ap.add_argument("--mxu-only", action="store_true",
                    help="rows 13 and 14 alone: this tree's knock-outs and, "
                    "with --parent, that tree's")
    ap.add_argument("--sampler-k3", action="store_true",
                    help="rows 2 and 18 alone (the sampler and K3): this "
                    "tree's knock-outs and, with --parent, that tree's")
    ap.add_argument("--finish-cios", action="store_true",
                    help="rows 7 and 12 alone (the packed triple finish and "
                    "the small-batch CIOS matmul): this tree's knock-outs "
                    "and, with --parent, that tree's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("band_core_study: no CUDA device")
    work = os.path.join(ROOT, "honeybadgermpc_tpu_torch", "build",
                        "band_core_study")
    if args.tree_only:
        if args.finish_cios:
            time_r7_r12(args.tree_only, os.path.join(
                os.getcwd(), "honeybadgermpc_tpu_torch", "build",
                "r7_r12_study_" + args.tree_only))
        elif args.sampler_k3:
            time_r2_r18(args.tree_only, os.path.join(
                os.getcwd(), "honeybadgermpc_tpu_torch", "build",
                "r2_r18_study_" + args.tree_only))
        elif args.mxu_only:
            time_mxu(args.tree_only, os.path.join(
                os.getcwd(), "honeybadgermpc_tpu_torch", "build",
                "mxu_study_" + args.tree_only))
        else:
            time_tree(args.tree_only)
            time_mxu(args.tree_only, None, variants=False)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(card=smi.splitlines()[0])

    def other(tag):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(args.parent))
        extra = (", '--mxu-only'" if args.mxu_only else
                 ", '--sampler-k3'" if args.sampler_k3 else
                 ", '--finish-cios'" if args.finish_cios else "")
        subprocess.run([sys.executable, "-c",
                        "import runpy, sys; sys.argv = ['study', "
                        f"'--tree-only', '{tag}'{extra}]; "
                        f"runpy.run_path({os.path.abspath(__file__)!r}, "
                        "run_name='__main__')"],
                       env=env, check=True, cwd=os.path.abspath(args.parent))

    if args.parent:
        other("parent")
    sys.path.insert(0, ROOT)
    if args.finish_cios:
        time_r7_r12("this", os.path.join(work, "r7_r12"))
    elif args.sampler_k3:
        time_r2_r18("this", os.path.join(work, "r2_r18"))
    elif args.mxu_only:
        time_mxu("this", os.path.join(work, "mxu"))
    else:
        time_tree("this")
        time_mxu("this", os.path.join(work, "mxu"))
        time_variants(work)
    if args.parent:
        other("parent")


if __name__ == "__main__":
    main()
