"""Build and load the port's CUDA kernels.

``lib()`` compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into one
shared library under ``build/`` (ignored by git) at first use, keyed by a
hash of the sources, and loads it with ``ctypes``. The sources have a plain
C interface and include no PyTorch header, so the build takes seconds. One
``nvcc`` runs per source file, all started together; a link step joins the
objects. A build or load failure raises — nothing falls back.

Interface convention: pointers come from ``tensor.data_ptr()``, the stream
from ``torch.cuda.current_stream().cuda_stream``; every entry returns
``cudaGetLastError()`` as an int and the wrapper raises when it is not 0.

``native()`` is the one host build: the repo's C++ extension
``native/hbmpc_native.cpp`` (the power mix's root finder), compiled as it
stands with ``g++`` against this Python's headers into the same
``build/`` directory, keyed by a hash of the source, the flags, the
compiler and the Python version, and loaded by file path as module
``_hbmpc_native``. Its failure raises too.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

NATIVE_SRC = os.path.join(_HERE, "..", "native", "hbmpc_native.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_native = None
build_seconds = None     # wall time of the build in this process, if any
native_build_seconds = None


def _sources():
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    cuh = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu, cuh


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in files:
        h.update(os.path.basename(fn).encode())
        with open(fn, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile(so_path: str, cu_files):
    """One nvcc per source, in parallel, then one link. The compiler's
    output (with ptxas' register and shared-memory report) goes to
    ``<library>.log``."""
    nvcc = _nvcc()
    tag = os.path.basename(so_path)[:-3]
    jobs = []
    for src in cu_files:
        obj = os.path.join(BUILD, f"{tag}_{os.path.basename(src)[:-3]}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        out, _ = proc.communicate()
        log.append("$ " + " ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(obj)
    if not failed:
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        log.append("$ " + " ".join(cmd) + "\n" + res.stdout)
        if res.returncode != 0:
            failed.append(tmp)
        else:
            os.replace(tmp, so_path)
    with open(so_path[:-3] + ".log", "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(log))


def _declare(lib):
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint32)
    init = ctypes.POINTER(ctypes.c_uint32)
    lib.hb_open_direct.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32, init,
                                   vp]
    lib.hb_open_direct_mma.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32,
                                       i32, init, i32, vp]
    lib.hb_band_matmul.argtypes = [vp, vp, vp, i64, i32, i32, i32, init,
                                   vp]
    lib.hb_rand_limbs.argtypes = [u32, u32, vp, i64, vp]
    lib.hb_randousha_deal.argtypes = [u32, u32, vp, vp, i32, i32, i32, i32,
                                      i32, init, vp]
    lib.hb_randousha_extract.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                         i32, init, vp]
    lib.hb_mul_add_packed4.argtypes = [vp, vp, vp, vp, i64, i64, i64, vp]
    lib.hb_sub_bcast_packed4.argtypes = [vp, vp, vp, i64, i64, i64, vp]
    lib.hb_mont_mul.argtypes = [vp, vp, vp, i64, vp]
    lib.hb_fp_matmul_cios.argtypes = [vp, vp, vp, i32, i32, i32, i32,
                                      vp]
    lib.hb_mxu_fused2.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                  i32, i32, vp]
    lib.hb_mxu_fused.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                 i32, vp]
    lib.hb_mxu_redc.argtypes = [vp, vp, i64, i32, vp]
    lib.hb_mul_add_packed.argtypes = [vp, vp, vp, vp, i64, vp]
    lib.hb_sub_bcast_packed.argtypes = [vp, vp, vp, i64, i64, i64, i64, i64,
                                         vp]
    lib.hb_randousha_extract_pc.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                            i32, i32, i32, init, vp]
    lib.hb_randousha_check.argtypes = [vp, vp, vp, vp, i32, i32, i64, i64,
                                       i32, init, vp]
    lib.hb_open_fused_k1.argtypes = [vp, vp, vp, i32, i32, i64, i32, init,
                                     vp]
    lib.hb_open_fused_k2.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32,
                                     init, vp]
    lib.hb_open_fused_k3.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32, i32,
                                     init, vp]
    lib.hb_rand_limbs_wave.argtypes = []
    lib.hb_rand_limbs_wave.restype = i64
    fused = (lib.hb_open_fused_k1, lib.hb_open_fused_k2,
             lib.hb_open_fused_k3)
    for fn in (lib.hb_open_direct, lib.hb_open_direct_mma,
               lib.hb_band_matmul, lib.hb_rand_limbs,
               lib.hb_randousha_deal, lib.hb_randousha_extract,
               lib.hb_mul_add_packed4, lib.hb_sub_bcast_packed4,
               lib.hb_mont_mul, lib.hb_fp_matmul_cios, lib.hb_mxu_fused2,
               lib.hb_mxu_fused, lib.hb_mxu_redc,
               lib.hb_mul_add_packed, lib.hb_sub_bcast_packed,
               lib.hb_randousha_extract_pc, lib.hb_randousha_check) + fused:
        fn.restype = ctypes.c_int


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    cu, cuh = _sources()
    so_path = os.path.join(BUILD, f"libhbmpc_{_digest(cu + cuh)}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD, exist_ok=True)
        t0 = time.perf_counter()
        _compile(so_path, cu)
        build_seconds = time.perf_counter() - t0
    loaded = ctypes.CDLL(so_path)
    _declare(loaded)
    _lib = loaded
    return _lib


def build_log() -> str:
    """The compiler output of the library in use ('' if it was not built
    by this checkout)."""
    cu, cuh = _sources()
    path = os.path.join(BUILD, f"libhbmpc_{_digest(cu + cuh)}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _gxx() -> str:
    cand = shutil.which("g++") or shutil.which("c++")
    if not cand:
        raise RuntimeError("g++ not found: the native root finder cannot "
                           "be built")
    return cand


def native():
    """The host extension built from ``native/hbmpc_native.cpp`` (built on
    first use into ``build/``; a failed build or load raises with the
    compiler's output)."""
    global _native, native_build_seconds
    if _native is not None:
        return _native
    gxx = _gxx()
    version = subprocess.run([gxx, "-dumpfullversion"], capture_output=True,
                             text=True).stdout.strip()
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(" ".join(GXX_FLAGS + [version, sys.version,
                                             include]).encode())
    with open(NATIVE_SRC, "rb") as f:
        h.update(f.read())
    so_path = os.path.join(BUILD, f"_hbmpc_native_{h.hexdigest()[:16]}"
                                  f"{sysconfig.get_config_var('EXT_SUFFIX')}")
    if not os.path.exists(so_path):
        os.makedirs(BUILD, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [gxx, *GXX_FLAGS, f"-I{include}", NATIVE_SRC, "-o", tmp]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError("native build failed:\n$ " + " ".join(cmd)
                               + "\n" + res.stdout)
        os.replace(tmp, so_path)
        native_build_seconds = time.perf_counter() - t0
    spec = importlib.util.spec_from_file_location("_hbmpc_native", so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _native = mod
    return _native
