"""Committed golden vectors of the port's heaviest parity tests.

Some port tests compare with results of the JAX package whose first
computation on a CPU compiles interpret-mode Pallas kernels or large jitted
programs (tens of seconds each). Those reference results are deterministic
functions of the tests' numpy seeds, so ``tests/make_golden.py`` computes
them once and stores them under ``tests/golden/<name>.npz``. The test loads
the file with ``golden(name)`` and holds the port against it, exactly as it
held it against the live result; a twin of the test, marked slow, computes
the reference live through the same function and runs the same checks.

Each test module that has golden vectors lists them in ``GOLDEN``: name ->
function returning a dict of numpy arrays (the reference's outputs, and
its inputs where the port takes them from the reference)."""

import os

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MODULES = ("test_torch_slice_robust_open", "test_torch_rs_fnt",
           "test_torch_offline_eager", "test_torch_open_fused",
           "test_torch_slice_triples", "test_torch_randousha",
           "test_torch_randousha_per_column", "test_torch_fp_matmul",
           "test_torch_slice_ntl", "test_torch_ntl",
           "test_torch_sqrt_mul_add", "test_torch_gao",
           "test_torch_band_gemm_epilogues", "test_torch_mont_mul",
           "test_torch_finish_cios", "test_torch_context",
           "test_torch_comparison", "test_torch_mimc_butterfly",
           "test_torch_refine_triples", "test_torch_fixedpoint",
           "test_torch_powermixing", "test_torch_fused",
           "test_torch_jubjub")


def golden(name):
    """The stored arrays of golden vector `name` (dict of numpy arrays)."""
    with np.load(os.path.join(DIR, name + ".npz")) as f:
        return {k: f[k] for k in f.files}
