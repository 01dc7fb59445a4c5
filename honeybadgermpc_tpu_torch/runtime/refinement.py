"""Randomness refinement (HoneyBadgerMPC progs/random_refinement.py:5).

Counterpart of ``honeybadgermpc_tpu/runtime/refinement.py``:
refine_randoms treats the n - t received shares as polynomial coefficients
and evaluates them at powers of omega with the NTT, dropping t outputs —
the hyperinvertible extraction that turns mixed honest and adversarial
randomness into unbiased randomness. A host variant for small control
batches and a device variant for FpArray batches. The reference's
``refine_triples`` and ``batch_beaver`` need the MPC runtime context and
are not ported yet.
"""

from __future__ import annotations

from ..ops.fparray import FpArray
from ..ops.limbs import P
from ..ops.ntt import fft_evaluate
from ..ops.rs import next_pow2
from ..polynomial import get_omega_int


def refine_randoms_host(n: int, t: int, field, random_shares: list) -> list:
    """Pure-host refinement for control-plane batches: the first n - t
    shares as coefficients, evaluated at omega^0 .. omega^(n-2t-1)."""
    k = n - t
    shares = random_shares[:k]
    order = next_pow2(n)
    omega = get_omega_int(field.modulus, 2 * order, seed=0) ** 2 \
        % field.modulus
    out = []
    for j in range(k - t):
        x = pow(omega, j, field.modulus)
        acc = 0
        for c in reversed(shares):
            acc = (acc * x + c) % field.modulus
        out.append(acc)
    return out


def refine_randoms(n: int, t: int, shares: FpArray) -> FpArray:
    """Device batched refinement: shares[..., k] with k = n - t ->
    unbiased [..., k - t]."""
    k = n - t
    if shares.shape[-1] != k:
        raise ValueError(f"{shares.shape[-1]} shares, expected n - t = {k}")
    order = next_pow2(n)
    omega = pow(get_omega_int(P, 2 * order, seed=0), 2, P)
    evals = fft_evaluate(shares, omega, order)
    return FpArray(evals.limbs[..., :k - t])
