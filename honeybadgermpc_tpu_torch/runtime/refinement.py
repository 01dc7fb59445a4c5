"""Randomness and triple refinement (HoneyBadgerMPC
progs/random_refinement.py:5 and progs/triple_refinement.py:19).

Counterpart of ``honeybadgermpc_tpu/runtime/refinement.py``:
refine_randoms treats the n - t received shares as polynomial coefficients
and evaluates them at powers of omega with the NTT, dropping t outputs —
the hyperinvertible extraction that turns mixed honest and adversarial
randomness into unbiased randomness. A host variant for small control
batches and a device variant for FpArray batches. ``refine_triples``
extracts verified-independent triples from dealer-supplied ones through
the MPC runtime context (``runtime/context.py``).
"""

from __future__ import annotations

from ..ops.fparray import FpArray
from ..ops.fpmatmul import (vandermonde_batch_evaluate,
                            vandermonde_batch_interpolate)
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


def batch_beaver(ctx, a, b, x, y, xy):
    """Beaver multiply given explicit triples (triple_refinement.py:7-16)."""
    d = ctx.open_share_array(a - x)
    e = ctx.open_share_array(b - y)
    return ctx.ShareArray(d * e + d * y.v + e * x.v + xy.v, a.t)


def refine_triples(ctx, dirty_a, dirty_b, dirty_c):
    """Triple extraction from d+1 dealer-supplied triples -> k = d+1-t
    verified-independent triples (triple_refinement.py:19-91).

    Interpolate A, B through the d+1 a/b shares at points 1..d+1, extend
    to 2d+1 points with batched Beaver products (the context's multiply
    mixin), interpolate C of degree 2d, and output evaluations at fresh
    points. Every step is a batched device op: the interpolations and
    evaluations go to the band kernel or fp_matmul's routes by shape."""
    d = dirty_a.v.shape[-1] - 1
    k = d + 1 - ctx.t
    assert k >= 1
    m = 2 * d + 1
    base_xs = list(range(1, d + 2))            # interpolation points for A,B
    ext_xs = list(range(d + 2, m + 1))         # extension points
    ca = vandermonde_batch_interpolate(base_xs, dirty_a.v)
    cb = vandermonde_batch_interpolate(base_xs, dirty_b.v)
    a_ext = vandermonde_batch_evaluate(ext_xs, ca)
    b_ext = vandermonde_batch_evaluate(ext_xs, cb)
    # c values: the first d+1 are the dealer's; the extension via Beaver
    ext_c = ctx.ShareArray(a_ext) * ctx.ShareArray(b_ext)
    all_c = FpArray.concatenate([dirty_c.v, ext_c.v],
                                axis=dirty_c.v.ndim - 1)
    cc = vandermonde_batch_interpolate(list(range(1, m + 1)), all_c)
    fresh = list(range(m + 1, m + 1 + k))
    return (ctx.ShareArray(vandermonde_batch_evaluate(fresh, ca)),
            ctx.ShareArray(vandermonde_batch_evaluate(fresh, cb)),
            ctx.ShareArray(vandermonde_batch_evaluate(fresh, cc)))
