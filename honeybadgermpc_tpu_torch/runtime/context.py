"""The MPC runtime context and dataflow types.

Counterpart of ``honeybadgermpc_tpu/runtime/context.py``: the reference's
Mpc context (honeybadgermpc/mpc.py:25-306) and its Viff-style dataflow
layer (progs/mixins/dataflow.py) as synchronous batched dataflow. A
``ShareArray`` holds a whole tensor of shares, linear algebra is local
FpArray math, and every nonlinear op lowers to a batched open. Nonlinear
ops dispatch through a name -> callable config (mpc.py:84-99), so a
program can swap Beaver for double-sharing multiplication.

Only the single-device ``SimBackend`` is ported: share tensors carry the
leading party axis ([n, ...]) and one context computes all parties. Any
other backend raises ``NotImplementedError`` (the mesh backends wait for
ROADMAP Queue A 6). The context lives on one device, ``cuda`` unless the
caller passes another; its dealer must live there too.

``nerr_total`` is per party: an int32 [n] tensor on the context's device,
to which every open adds its error counts summed over their trailing axes
(the reference starts a scalar and adds each open's nerr as returned,
which fails once a 2-D and a 3-D open meet).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.fparray import FpArray, scalar_const
from ..ops.limbs import P
from ..parallel.mesh import SimBackend
from ..parallel.reconstruct import sim_batch_reconstruct
from .preprocessing import PreProcessedElements


class MixinConstants:
    MultiplyShareArray = "multiply_share_array"
    InvertShareArray = "invert_share_array"
    DivideShareArrays = "divide_share_arrays"
    ShareEquality = "share_equality"
    ShareLessThan = "share_less_than"


class ShareArray:
    """A tensor of degree-t Shamir shares bound to a context.

    Linear operations are local (dataflow.py:85-117); ``*`` and ``/``
    between ShareArrays dispatch through the context's mixin config
    (dataflow.py:119-171). Values shape: [B] per party (the leading party
    axis is carried internally)."""

    __slots__ = ("ctx", "v", "t")

    def __init__(self, ctx: "MpcContext", v: FpArray, t: int | None = None):
        self.ctx = ctx
        self.v = v
        self.t = ctx.t if t is None else t

    @property
    def shape(self):
        return self.v.shape[self.ctx.lead:]

    def _like(self, v, t=None):
        return ShareArray(self.ctx, v, self.t if t is None else t)

    def _coerce_public(self, other):
        if isinstance(other, int):
            return FpArray(scalar_const(other, self.ctx.device))
        if isinstance(other, FpArray):
            return other
        return None

    def _check_ctx(self, other):
        """Shares from different contexts must never combine (the
        reference binds ops to one per-context Share type)."""
        if other.ctx is not self.ctx:
            raise TypeError("cannot combine shares from different contexts")

    # -- linear (local) ----------------------------------------------------
    def __add__(self, other):
        if isinstance(other, ShareArray):
            self._check_ctx(other)
            assert self.t == other.t, "degree mismatch"
            return self._like(self.v + other.v)
        return self._like(self.v + self._coerce_public(other))

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, ShareArray):
            self._check_ctx(other)
            assert self.t == other.t, "degree mismatch"
            return self._like(self.v - other.v)
        return self._like(self.v - self._coerce_public(other))

    def __rsub__(self, other):
        return self._like(self._coerce_public(other) - self.v)

    def __neg__(self):
        return self._like(-self.v)

    def __mul__(self, other):
        if isinstance(other, ShareArray):
            self._check_ctx(other)
            return self.ctx.call_mixin(MixinConstants.MultiplyShareArray,
                                       self, other)
        return self._like(self.v * self._coerce_public(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, ShareArray):
            self._check_ctx(other)
            return self.ctx.call_mixin(MixinConstants.DivideShareArrays,
                                       self, other)
        return self._like(self.v * self._coerce_public(other).inv())

    def __eq__(self, other):  # secure equality test -> shares of 0/1
        if isinstance(other, ShareArray):
            self._check_ctx(other)
        return self.ctx.call_mixin(MixinConstants.ShareEquality, self, other)

    def __lt__(self, other):
        if isinstance(other, ShareArray):
            self._check_ctx(other)
        return self.ctx.call_mixin(MixinConstants.ShareLessThan, self, other)

    __hash__ = None

    # -- nonlinear ---------------------------------------------------------
    def open(self) -> FpArray:
        """Batch-open: all parties learn the values."""
        return self.ctx.open_share_array(self)

    def square(self):
        return self * self

    def local_mul(self, other: "ShareArray") -> "ShareArray":
        """Degree-doubling local product (the front half of
        DoubleSharingMultiply, share_arithmetic.py:48-68)."""
        self._check_ctx(other)
        return ShareArray(self.ctx, self.v * other.v, self.t + other.t)

    def invert(self):
        return self.ctx.call_mixin(MixinConstants.InvertShareArray, self)

    def take(self, idx, axis=0):
        return self._like(self.v.take(idx, axis=axis + self.ctx.lead))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        lead = self.v.shape[:self.ctx.lead]
        return self._like(self.v.reshape(lead + tuple(shape)))

    @staticmethod
    def concat(arrays, axis=0):
        ctx = arrays[0].ctx
        t = arrays[0].t
        assert all(a.t == t for a in arrays)
        return ShareArray(ctx, FpArray.concatenate(
            [a.v for a in arrays], axis=axis + ctx.lead), t)

    def tree_fold(self, op):
        """Log-depth commutative reduce over the (1-D) element axis
        (dataflow.py:237-279 ``_tree_fold``): each level pairs even/odd
        elements and applies ``op`` as ONE batched ShareArray op (a
        nonlinear op costs one open per level), carrying an unpaired tail
        element to the next level. Returns a scalar ``Share``."""
        assert len(self.shape) == 1 and self.shape[0] > 0
        arr, k = self, self.shape[0]
        while k > 1:
            half = k // 2
            idx = np.arange(half)
            res = op(arr.take(idx * 2, axis=0), arr.take(idx * 2 + 1, axis=0))
            if k % 2:
                res = ShareArray.concat([res, arr.take([k - 1], axis=0)],
                                        axis=0)
            arr, k = res, half + (k % 2)
        return Share(arr)

    def multiplicative_product(self):
        """Product of all elements in log2(k) rounds of one batched
        multiply each (dataflow.py:281-287). An empty array folds to the
        constant-1 share (every party holds 1: the degree-0 sharing)."""
        if int(np.prod(self.shape)) == 0:
            if len(self.shape) != 1:
                raise ValueError(
                    f"multiplicative_product needs a 1-D ShareArray; got "
                    f"empty shape {self.shape}")
            lead = self.v.shape[:self.ctx.lead]
            return Share(self._like(FpArray.ones(lead + (1,),
                                                 self.ctx.device)))
        return self.tree_fold(ShareArray.__mul__)


class Share:
    """A single degree-t Shamir share (dataflow.py:50 Share): the scalar
    operator surface over a one-element ShareArray. Linear ops are local;
    ``*``, ``/``, ``==``, ``<`` dispatch through the context mixins;
    ``open()`` reveals the value."""

    __slots__ = ("_arr",)

    def __init__(self, arr: ShareArray):
        assert arr.shape == (1,), arr.shape
        self._arr = arr

    @property
    def ctx(self):
        return self._arr.ctx

    @property
    def t(self):
        return self._arr.t

    def _wrap(self, out):
        return Share(out) if isinstance(out, ShareArray) else out

    def _unlift(self, other):
        return other._arr if isinstance(other, Share) else other

    def __add__(self, other):
        return self._wrap(self._arr + self._unlift(other))

    __radd__ = __add__

    def __sub__(self, other):
        return self._wrap(self._arr - self._unlift(other))

    def __rsub__(self, other):
        return self._wrap(self._unlift(other) - self._arr)

    def __neg__(self):
        return self._wrap(-self._arr)

    def __mul__(self, other):
        return self._wrap(self._arr * self._unlift(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._wrap(self._arr / self._unlift(other))

    def __eq__(self, other):
        return self._wrap(self._arr == self._unlift(other))

    def __lt__(self, other):
        return self._wrap(self._arr < self._unlift(other))

    __hash__ = None

    def invert(self):
        return self._wrap(self._arr.invert())

    def square(self):
        return self._wrap(self._arr.square())

    def open(self) -> int:
        """Open this single share: all parties learn the value (they
        agree, so party 0's view is returned)."""
        vals = self._arr.open().to_ints()
        return int(np.asarray(vals, dtype=object).reshape(-1)[0])


# ----------------------------------------------------------------------------

def beaver_multiply_arrays(ctx: "MpcContext", x: ShareArray, y: ShareArray,
                           triples=None):
    """share_arithmetic.py:24 BeaverMultiplyArrays: one parallel open of
    (x-a, y-b); xy = de + db + ea + ab. Arbitrary element shapes: the
    element axes are flattened against the triple pool and restored.
    `triples` (a, b, ab ShareArrays of the flattened shape), if given,
    serve instead of a take from the pool."""
    xf, shape = _flatten_elements(ctx, x)
    yf, _ = _flatten_elements(ctx, y)
    k = xf.v.shape[-1]
    a, b, ab = triples or ctx.preproc_triples(k, xf)
    both = ShareArray.concat([xf - a, yf - b], axis=x_last_axis(ctx, xf))
    opened = ctx.open_share_array(both)
    d, e = _split2(ctx, opened, k)
    d, e = FpArray(d), FpArray(e)
    out = ShareArray(ctx, d * e + d * b.v + e * a.v + ab.v, x.t)
    return _unflatten_elements(ctx, out, shape)


def invert_share_array(ctx: "MpcContext", x: ShareArray):
    """share_arithmetic.py:120 InvertShareArray: open r*x, return r/(rx)."""
    xf, shape = _flatten_elements(ctx, x)
    k = xf.v.shape[-1]
    r = ctx.preproc_rands(k, xf)
    rx = ctx.open_share_array(beaver_multiply_arrays(ctx, r, xf))
    out = ShareArray(ctx, r.v * rx.inv(), x.t)
    return _unflatten_elements(ctx, out, shape)


def divide_share_arrays(ctx: "MpcContext", x: ShareArray, y: ShareArray):
    return beaver_multiply_arrays(ctx, x, invert_share_array(ctx, y))


def double_sharing_multiply_arrays(ctx: "MpcContext", x: ShareArray,
                                   y: ShareArray):
    """share_arithmetic.py:71 DoubleSharingMultiplyArrays: local degree-2t
    product, masked with a preprocessed double sharing (r_t, r_2t), ONE
    open at degree 2t, unmask:

        d = open(x*y - r_2t);   xy_t = r_t + d

    Select it with ``mixins={MixinConstants.MultiplyShareArray:
    double_sharing_multiply_arrays}``."""
    xf, shape = _flatten_elements(ctx, x)
    yf, _ = _flatten_elements(ctx, y)
    k = xf.v.shape[-1]
    r_t, r_2t = ctx.preproc_double_shares(k, xf)
    z = xf.local_mul(yf)                            # degree-2t share of xy
    d = ctx.open_double_share_array(
        ShareArray(ctx, z.v - r_2t.v, 2 * ctx.t))
    out = ShareArray(ctx, r_t.v + d, x.t)
    return _unflatten_elements(ctx, out, shape)


def _flatten_elements(ctx, x: ShareArray):
    """[party, *S] -> ([party, prod(S)], S)."""
    lead = x.v.shape[:ctx.lead]
    shape = x.v.shape[ctx.lead:]
    if len(shape) == 1:
        return x, shape
    return ShareArray(ctx, x.v.reshape(lead + (int(np.prod(shape)),)),
                      x.t), shape


def _unflatten_elements(ctx, x: ShareArray, shape):
    if len(shape) == 1:
        return x
    lead = x.v.shape[:ctx.lead]
    return ShareArray(ctx, x.v.reshape(lead + tuple(shape)), x.t)


def x_last_axis(ctx, x: ShareArray):
    return x.v.ndim - 1 - ctx.lead


def _split2(ctx, opened: FpArray, k: int):
    return opened.limbs[..., :k], opened.limbs[..., k:]


DEFAULT_MIXINS = {
    MixinConstants.MultiplyShareArray: beaver_multiply_arrays,
    MixinConstants.InvertShareArray: invert_share_array,
    MixinConstants.DivideShareArrays: divide_share_arrays,
}


def _assert_party_agreement(secrets: FpArray):
    """Every simulated party decodes an open on its own, so a per-party
    decode divergence would be invisible to a program that reads party 0's
    view: check that all parties agree (one host read per open). Eager
    opens only: skipped inside a program, as the reference skips it under
    trace, and off with the reference's switch
    HBMPC_NO_AGREEMENT_CHECK."""
    if os.environ.get("HBMPC_NO_AGREEMENT_CHECK"):
        return
    lim = secrets.limbs                      # [L, n, ...]
    assert torch.equal(lim, lim[:, :1].expand_as(lim)), \
        "sim open: per-party decoded values diverged"


class MpcContext:
    """n-party MPC context over the SimBackend (mpc.py:26 Mpc): share
    tensors carry a leading party axis and this one context computes all
    parties at once (the TaskProgramRunner model, mpc.py:280)."""

    field_modulus = P

    def __init__(self, n: int, t: int, backend=None,
                 preproc: PreProcessedElements | None = None,
                 use_omega_powers: bool = False, mixins=None,
                 robust: bool = True, device=torch.device("cuda")):
        self.n, self.t = n, t
        self.backend = backend or SimBackend(n)
        # layout classification looks through fault-injection wrappers
        base = getattr(self.backend, "inner", self.backend)
        if not isinstance(base, SimBackend):
            raise NotImplementedError(
                f"{type(base).__name__}: only SimBackend is ported; the "
                f"mesh and hybrid backends are ROADMAP Queue A 6")
        self.sim = True
        self.lead = 1
        self.device = torch.device(device)
        if preproc is not None and preproc.device != self.device:
            raise ValueError(f"dealer on {preproc.device}, context on "
                             f"{self.device}")
        self.preproc = preproc
        self.use_omega_powers = use_omega_powers
        self.robust = robust
        self.config = dict(DEFAULT_MIXINS)
        if mixins:
            self.config.update(mixins)
        self.opened_count = 0
        # per-party corrected-error tally, summed over every open
        self.nerr_total = torch.zeros(n, dtype=torch.int32,
                                      device=self.device)
        # None in an eager context. Inside a program (a fused replay,
        # runtime/fused.py): an int32 [1] device tensor; every robust open
        # is then detect-only, adds its mismatch count into it and reads
        # nothing on the host, and the runner redoes the call robustly
        # when it is nonzero
        self.tally = None

    @property
    def local_parties(self) -> int:
        """Size of the leading local party axis (sim: n)."""
        return self.n

    def lift_public(self, pub: FpArray) -> FpArray:
        """Public values -> every party's constant view (adds the leading
        party axis)."""
        limbs = pub.limbs[:, None]
        return FpArray(limbs.expand(
            (limbs.shape[0], self.n) + tuple(limbs.shape[2:])))

    # -- construction ------------------------------------------------------
    def ShareArray(self, v: FpArray, t: int | None = None) -> ShareArray:
        return ShareArray(self, v, t)

    def Share(self, v, t: int | None = None) -> Share:
        """Scalar share (mpc.py:69-74 per-context Share type). v: a
        one-element ShareArray, or a dealt [n, 1] FpArray."""
        if isinstance(v, ShareArray):
            return Share(v)
        return Share(ShareArray(self, v, t))

    def from_preproc(self, fp: FpArray, t: int | None = None) -> ShareArray:
        """Wrap a dealt [n, k] share tensor as a ShareArray."""
        return ShareArray(self, fp, t)

    def preproc_triples(self, k: int, like: ShareArray):
        a, b, ab = self.preproc.get_triples(k)
        return (self.from_preproc(a), self.from_preproc(b),
                self.from_preproc(ab))

    def preproc_rands(self, k: int, like: ShareArray):
        return self.from_preproc(self.preproc.get_rands(k))

    def preproc_double_shares(self, k: int, like: ShareArray):
        r_t, r_2t = self.preproc.get_double_shares(k)
        return (self.from_preproc(r_t),
                self.from_preproc(r_2t, t=2 * self.t))

    def call_mixin(self, name: str, *args):
        assert name in self.config, f"missing mixin {name}"
        return self.config[name](self, *args)

    # -- opening -----------------------------------------------------------
    def open_share_array(self, sa: ShareArray) -> FpArray:
        """Open with degree-aware chunking; pads B to a multiple of
        degree+1 with zero shares (always valid sharings of 0)."""
        d = sa.t
        B = sa.v.shape[-1]
        pad = (-B) % (d + 1)
        v = sa.v
        if pad:
            v = FpArray.concatenate(
                [v, FpArray.zeros(v.shape[:-1] + (pad,), v.device)],
                axis=v.ndim - 1)
        secrets, nerr = sim_batch_reconstruct(
            v, self.n, d, self.use_omega_powers, self.robust, self.tally)
        if self.tally is None:
            _assert_party_agreement(secrets)
        self.opened_count += B
        self.nerr_total = self.nerr_total + \
            nerr.reshape(self.n, -1).sum(-1).to(torch.int32)
        if pad:
            secrets = FpArray(secrets.limbs[..., :B])
        return secrets

    def open_double_share_array(self, sa: ShareArray) -> FpArray:
        assert sa.t == 2 * self.t
        return self.open_share_array(sa)

    def open_share_arrays(self, sas) -> list:
        """Open several independent ShareArrays in ONE reconstruction:
        same-degree arrays are flattened and concatenated on the element
        axis, opened with a single open, and split back (the per-open cost
        is paid once instead of len(sas) times)."""
        sas = list(sas)
        if not sas:
            return []
        d = sas[0].t
        assert all(s.t == d for s in sas), [s.t for s in sas]
        lead = sas[0].v.shape[:self.lead]
        shapes = [s.v.shape[self.lead:] for s in sas]
        flats = [s.v.reshape(lead + (int(np.prod(shape)),))
                 for s, shape in zip(sas, shapes)]
        cat = FpArray.concatenate(flats, axis=len(lead))
        opened = self.open_share_array(ShareArray(self, cat, d))
        outs = []
        off = 0
        olead = opened.shape[:-1]
        for shape in shapes:
            total = int(np.prod(shape))
            outs.append(FpArray(
                opened.limbs[..., off:off + total]).reshape(olead + shape))
            off += total
        return outs
