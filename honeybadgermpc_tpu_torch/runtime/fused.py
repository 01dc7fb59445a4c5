"""Fused MPC programs: a whole data-oblivious MPC program replayed as ONE
CUDA graph on the card (SimBackend), with its preprocessing
functionalized.

Counterpart of ``honeybadgermpc_tpu/runtime/fused.py``. An MPC program is
hundreds of small operations, and on the card each is one or more kernel
launches from the host (a Beaver multiply is about 800): the program is
held by its launches, not by its kernels. The reference answers this by
tracing the whole program into one XLA program; on the card the
counterpart is a CUDA graph, captured once and replayed per call.

Contract: the program must be DATA-OBLIVIOUS (its Python control flow may
depend on shapes, never on opened values), which is the MPC security
model, so every honest protocol qualifies. Reading an opened value on the
host inside a fused program raises on the card (a capture allows no host
read).

Mechanics (both cached per (program, shapes, context params, device)):
  1. counting pass: the program runs once, eagerly, on an inner context
     whose dealer (``_CountingPreproc``) hands out zero sharings on the
     context's device and records how many elements of each kind it
     consumed. Zero placeholders are safe: inv(0) = 0, so a division does
     not raise, and a zero sharing opens to zero. On the card this run is
     also the warm-up a capture needs: it builds the kernels, sets their
     launch attributes and fills the constant caches, so the capture
     issues no host copy. It consumes nothing from ``ctx.preproc``.
  2. replay: the pool elements are taken from ``ctx.preproc`` once per
     call as whole tensors, and a tape dealer (``_TapePreproc``) deals
     static slices of them in program order. On the card the replay is
     captured once per cache key in a ``torch.cuda.CUDAGraph`` (all
     entries share one graph memory pool); a call copies the argument
     limbs and the pool takes into the graph's static inputs, replays it
     and clones the outputs (the next replay overwrites them). On the CPU
     the same replay function runs eagerly. A capture that fails raises:
     nothing carries on eagerly in its place. The public constants the
     graph reads (``scalar_const``'s bounded cache) stay pinned on its
     cache entry for as long as the graph lives.

Opens inside a replay. A graph cannot read the host, so the replay's
robust opens run detect-only and add their mismatch counts into a device
tally (the inner context's ``tally``). After the replay the runner reads
the tally once; when it is nonzero it runs the whole call again, eagerly,
from the same tape with robust opens (the Gao redo where an open needs
it), returns that result and counts one redo (``fused_redos``). The
reference keeps an in-graph Gao fallback instead; the words are the
same either way. The replay runs on an inner context, as the reference's
does, so the outer context's ``opened_count`` and ``nerr_total`` do not
move.

Counters (module globals, for tests and the card's smoke run):
``captures`` (graphs captured), ``graph_replays`` (replays of a captured
graph; a scan call replays its step graph once per step), ``fused_redos``
(whole calls redone eagerly after a nonzero tally), and
``launches_per_replay`` (per cache key: the hand-written kernel launches
counted while its graph was captured, which is what one replay runs).
"""

from __future__ import annotations

import torch

from ..ops import field_kernels as _fk
from ..ops import fused_open as _fo
from ..ops import fused_open_direct as _fod
from ..ops.fparray import FpArray, pin_constants
from .context import MpcContext, ShareArray

# kind -> (getter name, number of component arrays)
_KINDS = {
    "triples": ("get_triples", 3),
    "cubes": ("get_cubes", 3),
    "rands": ("get_rands", 1),
    "zeros": ("get_zeros", 1),
    "bits": ("get_bits", 1),
    "one_minus_ones": ("get_one_minus_ones", 1),
    "double_shares": ("get_double_shares", 2),
    "share_bits": ("get_share_bits", 2),
}

captures = 0
graph_replays = 0
fused_redos = 0
launches_per_replay: dict = {}


class _CountingPreproc:
    """Records per-kind totals; hands back zero sharings on `device` (the
    counting pass runs the program once, eagerly, on them)."""

    def __init__(self, n: int, device):
        self.n = n
        self.device = device
        self.counts: dict[str, int] = {}

    def _rec(self, kind: str, k: int, parts: int, extra=()):  # -> FpArrays
        self.counts[kind] = self.counts.get(kind, 0) + k
        outs = tuple(FpArray.zeros((self.n, k) + e, self.device)
                     for e in ([()] * parts if not extra else extra))
        return outs if len(outs) > 1 else outs[0]

    def get_triples(self, k):
        return self._rec("triples", k, 3)

    def get_cubes(self, k):
        return self._rec("cubes", k, 3)

    def get_rands(self, k):
        return self._rec("rands", k, 1)

    def get_zeros(self, k):
        return self._rec("zeros", k, 1)

    def get_bits(self, k):
        return self._rec("bits", k, 1)

    def get_one_minus_ones(self, k):
        return self._rec("one_minus_ones", k, 1)

    def get_double_shares(self, k):
        return self._rec("double_shares", k, 2)

    def get_share_bits(self, k):
        # (r [n,k], bits [n,k,bl]); bit length fixed by the dealer (255)
        return self._rec("share_bits", k, 2, extra=[(), (255,)])


class _TapePreproc:
    """Deals prefetched pool tensors out in program order. ``arrays`` maps
    kind -> tuple of limb tensors [L, n, total, ...]; the slices are static
    (host cursors), so a captured replay reads the same addresses every
    time."""

    def __init__(self, arrays: dict, device):
        self._arrays = arrays
        self._cursor = {k: 0 for k in arrays}
        self.device = device

    def _slice(self, kind: str, k: int):
        c = self._cursor[kind]
        self._cursor[kind] = c + k
        outs = tuple(FpArray(a[:, :, c:c + k]) for a in self._arrays[kind])
        return outs if len(outs) > 1 else outs[0]

    def __getattr__(self, name):
        if name.startswith("get_"):
            kind = name[4:]
            if kind in _KINDS:
                return lambda k: self._slice(kind, k)
        raise AttributeError(name)


def _flatten_result(out):
    """Program result -> (leaves: list of limb tensors, spec to rebuild)."""
    if isinstance(out, ShareArray):
        return [out.v.limbs], ("sh", out.t)
    if isinstance(out, FpArray):
        return [out.limbs], ("fp",)
    if isinstance(out, (tuple, list)):
        leaves, specs = [], []
        for o in out:
            lv, sp = _flatten_result(o)
            leaves.extend(lv)
            specs.append((sp, len(lv)))
        return leaves, ("seq", type(out) is tuple, tuple(specs))
    if isinstance(out, dict):
        leaves, specs = [], []
        for key in sorted(out):
            lv, sp = _flatten_result(out[key])
            leaves.extend(lv)
            specs.append((key, sp, len(lv)))
        return leaves, ("dict", tuple(specs))
    raise TypeError(
        f"fused program returned {type(out)}; supported: ShareArray, "
        "FpArray, tuple/list/dict thereof")


def _rebuild_result(ctx, leaves, spec):
    kind = spec[0]
    if kind == "sh":
        return ctx.ShareArray(FpArray(leaves[0]), spec[1])
    if kind == "fp":
        return FpArray(leaves[0])
    if kind == "seq":
        _, is_tuple, specs = spec
        out, i = [], 0
        for sp, ln in specs:
            out.append(_rebuild_result(ctx, leaves[i:i + ln], sp))
            i += ln
        return tuple(out) if is_tuple else out
    if kind == "dict":
        out, i = {}, 0
        for key, sp, ln in spec[1]:
            out[key] = _rebuild_result(ctx, leaves[i:i + ln], sp)
            i += ln
        return out
    raise AssertionError(spec)


def fused_demand(ctx: MpcContext, prog, *args) -> dict:
    """Per-call preprocessing demand (kind -> count) of a fused program,
    for pre-dealing pools outside a measured region. Builds (and caches)
    the program if needed."""
    shares = [_as_share(ctx, a) for a in args]
    return dict(_program(ctx, prog, shares).counts)


def _deal_deficit(ctx, kind: str, total: int):
    """Generate the pool deficit, rounded UP to a power of two (the
    reference's rule: its dealer compiles per batch size, so padded
    generation keeps one cached compile per power of two)."""
    have = ctx.preproc._pool(kind).remaining()
    if have >= total:
        return
    need = total - have
    chunk = 1 << max(need - 1, 1).bit_length()
    getattr(ctx.preproc, "generate_" + kind)(chunk)


def _as_share(ctx, a):
    if isinstance(a, ShareArray):
        return a
    if isinstance(a, FpArray):
        return ctx.ShareArray(a)
    raise TypeError(f"fused program arg must be ShareArray/FpArray, got "
                    f"{type(a)}")


_CACHE: dict = {}
_CACHE_CAP = 128
_POOL = None


def _cache_put(key, val):
    """Bounded insert (FIFO eviction): keys hold the program FUNCTION
    OBJECT, so accidental fresh-lambda callers would otherwise keep a
    captured graph per call; with the cap they degrade to recounting and
    recapturing instead of unbounded growth. Evicting an entry releases
    its graph."""
    if len(_CACHE) >= _CACHE_CAP:
        old = _CACHE.pop(next(iter(_CACHE)))
        old.release()
        launches_per_replay.pop(old.key, None)
    _CACHE[key] = val


def _graph_pool():
    """The one graph memory pool every cached graph allocates from."""
    global _POOL
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    return _POOL


def _wrapper_launches() -> int:
    """Sum of the hand-written kernels' launch counters on the paths a
    program reaches: the direct open (both routes), the three-kernel open,
    mont_mul, the sampler and the field matmul, the band encode."""
    from ..ops import band_matmul as _bm
    from ..ops import mxu_matmul as _mxu
    return (_fod.launches + _fod.launches_mma + _fo.launches_k1
            + _fo.launches_k2 + _fo.launches_k3 + _fk.launches
            + _fk.launches_mont_mul + _fk.launches_matmul + _bm.launches
            + _mxu.launches_fused2 + _mxu.launches_fused
            + _mxu.launches_redc)


def _inner_ctx(ctx, preproc, tally):
    c = MpcContext(ctx.n, ctx.t, preproc=preproc,
                   use_omega_powers=ctx.use_omega_powers, robust=ctx.robust,
                   device=ctx.device)
    c.tally = tally
    return c


class _Program:
    """One cached fused program: its counts and output spec and, on the
    card, its captured graph with the static inputs and outputs and the
    public constants the graph reads. A call runs ``steps`` steps of it
    (1 for ``run_fused``), each on its own pool slices and ``rows`` row,
    the outputs of one step carried into the inputs of the next."""

    def __init__(self, ctx, fn, shares, key, rows=()):
        self.key = key
        self.fn = fn
        self.arg_ts = tuple(s.t for s in shares)
        counter = _CountingPreproc(ctx.n, ctx.device)
        zeros = [torch.zeros_like(s.v.limbs) for s in shares]
        tally = torch.zeros(1, dtype=torch.int32, device=ctx.device)
        leaves, self.spec = self._body(_inner_ctx(ctx, counter, tally),
                                       zeros, [r[0] for r in rows])
        self.counts = dict(counter.counts)
        self._check(shares, leaves)
        self.graph = None
        if ctx.device.type == "cuda":
            self._capture(ctx, shares, rows)

    def _call(self, c, args, x):
        return self.fn(c, *args)

    def _check(self, shares, leaves):
        pass

    def _body(self, c, arg_limbs, x):
        args = [c.ShareArray(FpArray(l), tt)
                for l, tt in zip(arg_limbs, self.arg_ts)]
        return _flatten_result(self._call(c, args, x))

    def _pool_shapes(self, n):
        shapes = {}
        for kind, total in self.counts.items():
            shapes[kind] = ([(n, total)] * _KINDS[kind][1]
                            if kind != "share_bits"
                            else [(n, total), (n, total, 255)])
        return shapes

    def _capture(self, ctx, shares, rows):
        """Capture one step in a CUDA graph on the shared pool; a failure
        raises. The public constants the capture reads stay pinned on the
        entry (``self.consts``) for as long as its graph lives."""
        global captures
        from ..ops.limbs import L
        dev = ctx.device
        self.s_args = [torch.zeros_like(s.v.limbs,
                                        memory_format=torch.contiguous_format)
                       for s in shares]
        self.s_pools = {k: tuple(torch.zeros((L,) + sh, dtype=torch.int32,
                                             device=dev) for sh in shapes)
                        for k, shapes in self._pool_shapes(ctx.n).items()}
        self.s_rows = [torch.zeros_like(r[0]) for r in rows]
        self.s_tally = torch.zeros(1, dtype=torch.int32, device=dev)
        inputs = {a.untyped_storage().data_ptr() for a in self.s_args}
        graph = torch.cuda.CUDAGraph()
        before = _wrapper_launches()
        with pin_constants() as self.consts, \
                torch.cuda.graph(graph, pool=_graph_pool()):
            tape = _TapePreproc(self.s_pools, dev)
            leaves, _ = self._body(_inner_ctx(ctx, tape, self.s_tally),
                                   self.s_args, self.s_rows)
            # an output that is an input (a pass-through, a scan's swap)
            # gets its own buffer, so a carry-back cannot clobber it
            self.s_out = [o.clone() if o.untyped_storage().data_ptr()
                          in inputs else o for o in leaves]
        self.graph = graph
        captures += 1
        launches_per_replay[self.key] = _wrapper_launches() - before

    def release(self):
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
            self.consts = None

    def eager(self, ctx, arg_limbs, pools, rows, steps, tally):
        leaves = list(arg_limbs)
        for i in range(steps):
            tape = _TapePreproc({k: tuple(a[i] for a in parts)
                                 for k, parts in pools.items()}, ctx.device)
            leaves, _ = self._body(_inner_ctx(ctx, tape, tally), leaves,
                                   [r[i] for r in rows])
        return leaves

    def run(self, ctx, arg_limbs, pools, rows=(), steps=1):
        """One call (pools: kind -> tuple of [steps, L, n, c, ...]): the
        replays (the graph on the card, the step eagerly on the CPU), then
        the robust eager redo if an open saw a mismatch."""
        global graph_replays, fused_redos
        if self.graph is not None:
            for s, a in zip(self.s_args, arg_limbs):
                s.copy_(a)
            self.s_tally.zero_()
            for i in range(steps):
                if i:                                   # carry back
                    for s, o in zip(self.s_args, self.s_out):
                        s.copy_(o)
                for kind, parts in pools.items():
                    for s, a in zip(self.s_pools[kind], parts):
                        s.copy_(a[i])
                for s, r in zip(self.s_rows, rows):
                    s.copy_(r[i])
                self.graph.replay()
                graph_replays += 1
            tally = self.s_tally
            leaves = [o.clone() for o in self.s_out]
        else:
            tally = torch.zeros(1, dtype=torch.int32, device=ctx.device)
            leaves = self.eager(ctx, arg_limbs, pools, rows, steps, tally)
        if ctx.robust and int(tally.item()) != 0:
            fused_redos += 1
            leaves = self.eager(ctx, arg_limbs, pools, rows, steps, None)
        return leaves


def _program(ctx, prog, shares):
    key = (prog, ctx.n, ctx.t, ctx.robust, ctx.use_omega_powers, ctx.device,
           tuple((tuple(s.v.limbs.shape), s.t) for s in shares))
    hit = _CACHE.get(key)
    if hit is None:
        hit = _Program(ctx, prog, shares, key)
        _cache_put(key, hit)
    return hit


def _take(ctx, p, steps, auto_deal):
    """Program p's pools for `steps` steps, taken from ctx.preproc at
    once: kind -> tuple of [steps, L, n, c, ...] (step axis leading)."""
    pools = {}
    for kind, c in p.counts.items():
        if auto_deal:
            _deal_deficit(ctx, kind, c * steps)
        got = getattr(ctx.preproc, _KINDS[kind][0])(c * steps)
        pools[kind] = tuple(
            torch.movedim(a.limbs.reshape(a.limbs.shape[:2] + (steps, c)
                                          + a.limbs.shape[3:]), 2, 0)
            for a in (got if isinstance(got, tuple) else (got,)))
    return pools


def run_fused(ctx: MpcContext, prog, *args, auto_deal: bool = False):
    """Run ``prog(ctx2, *args)`` as one replayed program: a CUDA graph on
    the card, the same replay eagerly on the CPU.

    ctx must be a SimBackend context with a PreProcessedElements dealer;
    args are ShareArrays (or dealt [n, B] FpArrays). The needed
    preprocessing is consumed from ctx.preproc exactly once per call;
    with ``auto_deal`` the dealer generates any deficit first (test/bench
    convenience, as the reference's test fixture generates on demand).
    Caching is per (prog, arg shapes/degrees, context params, device):
    reuse the same function object across calls (avoid fresh lambdas)."""
    assert ctx.sim, "run_fused requires the SimBackend (sim) context"
    shares = [_as_share(ctx, a) for a in args]
    p = _program(ctx, prog, shares)
    leaves = p.run(ctx, [s.v.limbs for s in shares],
                   _take(ctx, p, 1, auto_deal))
    return _rebuild_result(ctx, leaves, p.spec)


# -- scans --------------------------------------------------------------------

def _per_step_rows(per_step, steps):
    """per_step (None, a tensor, or a tuple of tensors, leading axis
    `steps`) -> (tuple of tensors, whether the step gets a tuple)."""
    if per_step is None:
        return (), True
    many = isinstance(per_step, (tuple, list))
    rows = tuple(per_step) if many else (per_step,)
    assert all(r.shape[0] == steps for r in rows), \
        "per_step leading axis must equal steps"
    return rows, many


class _Scan(_Program):
    """One cached scan step: the step gets the carry as a tuple and its
    per_step row (a tuple of rows for a tuple), and returns a carry of
    the same shapes."""

    def __init__(self, ctx, step, carry, rows, many, key):
        self.many = many
        super().__init__(ctx, step, carry, key, rows)

    def _call(self, c, args, x):
        return tuple(self.fn(c, tuple(args),
                             tuple(x) if self.many else x[0]))

    def _check(self, carry, leaves):
        in_shapes = tuple(tuple(s.v.limbs.shape) for s in carry)
        out_shapes = tuple(tuple(l.shape) for l in leaves)
        assert out_shapes == in_shapes, \
            f"scan carry shape changed: {in_shapes} -> {out_shapes}"


def run_fused_scan(ctx: MpcContext, step, carry, steps: int, per_step=None,
                   auto_deal: bool = False):
    """Run ``steps`` iterations of ``step(ctx2, carry, x_i) -> carry`` with
    ONE captured step replayed ``steps`` times on the card (eagerly on the
    CPU), the counterpart of the reference's ``lax.scan``.

    The shape for round-structured protocols (MiMC's rounds, a Jubjub
    scalar ladder, butterfly rounds): the step is counted and captured
    once, whatever ``steps`` is; step i's pool slices and per_step row
    are copied into the graph's static inputs before its replay, then its
    outputs are carried back into the inputs, so the program stays
    O(step).

    carry: tuple of ShareArrays (or dealt FpArrays); shapes must be
    invariant under ``step``. per_step: optional tensor or tuple of
    tensors with leading axis ``steps`` on the context's device, delivered
    per iteration (public round constants, ladder bits, ...); the step
    gets row i (a tuple of rows for a tuple)."""
    assert ctx.sim, "run_fused_scan requires the SimBackend (sim) context"
    carry = tuple(_as_share(ctx, a) for a in carry)
    rows, many = _per_step_rows(per_step, steps)
    key = ("scan", step, ctx.n, ctx.t, ctx.robust, ctx.use_omega_powers,
           ctx.device, tuple((tuple(s.v.limbs.shape), s.t) for s in carry),
           tuple((tuple(r.shape[1:]), str(r.dtype)) for r in rows), many)
    hit = _CACHE.get(key)
    if hit is None:
        hit = _Scan(ctx, step, carry, rows, many, key)
        _cache_put(key, hit)
    leaves = hit.run(ctx, [s.v.limbs for s in carry],
                     _take(ctx, hit, steps, auto_deal), rows, steps)
    return _rebuild_result(ctx, leaves, hit.spec)
