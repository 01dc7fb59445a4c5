"""honeybadgermpc_tpu_torch — the PyTorch/CUDA port of honeybadgermpc_tpu.

The JAX package ``honeybadgermpc_tpu`` is the reference; this package is
its counterpart for an NVIDIA Hopper card. It imports ``torch`` and
``numpy`` only — never ``jax`` and nothing from the JAX package — and keeps
the same sub-package layout and function names so that a reader finds the
counterpart of every module.

Representation (bit-compatible with the reference, so tensors compare word
for word): the BLS12-381 scalar field, 16 limbs of 16 bits, Montgomery
radix R = 2**256, limbs leading ``[L, *shape]``, and the packed at-rest
format ``[PL=8, ...]`` with limb 2j in the low half of word j.

Integer types. PyTorch has no usable ``uint32`` arithmetic on the CPU, so
limbs and packed words are stored as ``torch.int32`` tensors holding the
uint32 bit pattern (``numpy.ndarray.view(np.int32)`` at the boundary, see
``interop.py``). Plain tensor code does its arithmetic in ``int64``; the
CUDA kernels read the very same buffers as ``uint32_t``.

Devices. Every entry point takes an explicit ``device`` that defaults to
``torch.device("cuda")``. On a CUDA tensor a kernel wrapper launches its
hand-written kernel (``csrc/``) or raises; it takes the plain PyTorch
version only for a tensor that lies on the CPU.

What is ported so far: the dealer for random sharings, the packed format
and the detect-only single-kernel n-party open (deal -> pack -> open); the
fused offline path, RanSha / RanDouSha with the aggregated check and the
packed triple finish (runtime/offline.py: verified Beaver triples); the
robust open with the Gao decoder (parallel/reconstruct.py, ops/gao.py);
every program of ``runtime/offline.py::sim_offline_jit`` — the eager
per-column RanDouSha, triples and bits, with the faithful three-kernel
open and its in-program robust fallback (ops/fused_open.py); and the
NTL-compatible API (``ntl.py``) with the coding layer beneath it: the NTT
(ops/ntt.py), the FNT decode (ops/rs.py), Welch-Berlekamp, the random
refinement, every route of ``fp_matmul`` on the card, and the host math
layer (``field.py``, ``polynomial.py``, ``elliptic_curve.py``); the MPC
runtime core (``runtime/context.py``: ``MpcContext``, ``ShareArray``,
``Share``; every dealer kind; ``runtime/comparison.py``; triple
refinement) and the models ``mimc``, ``mimc_symmetric``, ``butterfly``,
``fixedpoint`` and ``powermixing`` (its root finder the C++ of
``native/hbmpc_native.cpp``, built into ``build/`` by ``_build.native``);
the AsynchroMix app and the first tutorial (``apps/``).
"""

__version__ = "0.1.0"

from .elliptic_curve import Subgroup  # noqa: F401
from .field import GF, GFElement  # noqa: F401
from .ops.fparray import FpArray  # noqa: F401
