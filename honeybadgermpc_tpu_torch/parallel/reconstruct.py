"""Batch reconstruction entry points (single-device simulation).

Counterpart of ``honeybadgermpc_tpu/parallel/reconstruct.py``. So far only
the detect-only packed open is ported: the factory below, on the direct
single-kernel open of ops/fused_open_direct.py.
"""

from __future__ import annotations

from functools import lru_cache

from ..ops.fused_open_direct import direct_fits, sim_open_direct_packed
from ..ops.limbs import P
from ..ops.rs import Encoding


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

    The other branch — the faithful three-kernel open with its in-graph
    robust fallback — is not ported yet."""
    enc = Encoding(n, use_omega_powers=use_omega_powers)
    points = tuple(int(x) % P for x in enc.points)

    if robust and not fallback and direct_fits(n, t + 1):
        def run_direct(packed):
            return sim_open_direct_packed(packed, n, t, points,
                                          replicate=replicate)

        return run_direct

    raise NotImplementedError(
        "only the detect-only direct open (robust=True, fallback=False, "
        "n > t+1 <= 128) is ported; the three-kernel fused open with the "
        "robust fallback is not ported yet")
