"""Field kernels of the port — counterpart of ``ops/pallas_field.py``.

Every kernel of it: the field sampler ``rand_limbs`` (the reference's
``rand_limbs_pallas``), the packed 4D finish arithmetic
``mul_add_packed4`` / ``sub_bcast_packed4``, their flat counterparts
``mul_add_packed`` / ``sub_bcast_packed``, the elementwise Montgomery
multiply ``mont_mul_pallas`` and the CIOS matmul ``fp_matmul_pallas``.

Sampler: element e draws Threefry-2x32-20 with counters
(s, e), s = 0..5, taking the words of each call in the order
w0.lo, w0.hi, w1.lo, w1.hi — 24 halfwords = 384 bits — and sends them
through the 9-round ``redc384``; the canonical limbs are used directly as
the Montgomery representation. Threefry is a fixed function, so for the
same key data the output is bit-identical to the reference kernel's.

On a CUDA device the sampler is the hand-written kernel
``csrc/rand_limbs.cu``, which reduces the 12 Threefry words on 32-bit
words (``redc384_words``: the same quotient, so the same limbs);
``_rand_limbs_plain`` is its plain PyTorch version and
``_rand_limbs_words`` the plain twin of the kernel's word path.

Finish arithmetic: ``(a*b + c) mod p`` and ``(a - b) mod p`` on PACKED
words in the extraction's native layout ``[PL, n, R, S]``, the two
elementwise passes of the packed triple finish, and the same two on flat
packed words ``[PL, B]`` (the unpacked finish). On CUDA tensors they are
the kernels of ``csrc/packed_arith.cu``; the plain versions go through
``unpack_limbs`` and ``ops/montgomery.py``.

Elementwise multiply and CIOS matmul: ``mont_mul_pallas`` (the kernel
behind ``montgomery.mont_mul`` on a CUDA tensor, ``csrc/mont_mul.cu``) and
``fp_matmul_pallas`` (``csrc/fp_matmul_cios.cu``, the route of
``fpmatmul.fp_matmul`` for batches below 1024 elements). Their plain
versions are ``montgomery._mont_mul_plain`` and the scan
``fpmatmul._matmul_kernel`` over it; ``_cios_words_model`` is the plain
twin of the CIOS kernel's own arithmetic (the contraction split over
``_cios_plan``'s lanes, unreduced wide sums, one reduction per run).
"""

from __future__ import annotations

import torch

from . import montgomery as mont
from .band_gemm import _redc384_words
from .fused_open import PL, _launch_stream, pack_limbs, unpack_limbs
from .limbs import L, MASK, P, W

_TF_ROT_A = (13, 15, 26, 6)
_TF_ROT_B = (17, 29, 16, 24)
_M32 = 0xFFFFFFFF

# times each CUDA kernel was launched (counted there and nowhere else)
launches = 0                # rand_limbs
launches_mul_add4 = 0       # mul_add_packed4
launches_sub_bcast4 = 0     # sub_bcast_packed4
launches_mul_add = 0        # mul_add_packed
launches_sub_bcast = 0      # sub_bcast_packed
launches_mont_mul = 0       # mont_mul_pallas
launches_matmul = 0         # fp_matmul_pallas
# times sub_bcast_packed's plain version ran on a CUDA tensor: the card's
# paths must keep this at 0 (only a comparison against the kernel may move it)
plain_calls_on_cuda = 0


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, on Python ints or int64 tensors holding
    uint32 values (k0, k1 ints). The CUDA twin is field_core.cuh's."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for g in range(5):
        rots = _TF_ROT_A if g % 2 == 0 else _TF_ROT_B
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def split_key(key_data, num: int):
    """Derive `num` sub-keys from a Threefry key (two uint32): child i is
    the two output words of Threefry-2x32(key, counter = (0x5EED, i)).
    This is the port's own derivation (a fixed, documented function); it
    does not reproduce ``jax.random.split``. A parent key is only ever
    split, never drawn from, so children of different parents and the
    sampler's (s, e) counters never meet under one key."""
    k0, k1 = _key_ints(key_data)
    return [_threefry2x32(k0, k1, 0x5EED, i) for i in range(num)]


def _key_ints(key_data):
    """Key data (a pair of ints, numpy uint32[2] or a tensor) -> (k0, k1)."""
    if isinstance(key_data, torch.Tensor):
        key_data = key_data.tolist()
    k0, k1 = (int(x) & _M32 for x in key_data)
    return k0, k1


def _rand_limbs_plain(key_data, numel: int, device):
    """Plain PyTorch version of the sampler: int32 [L, numel] on `device`."""
    k0, k1 = _key_ints(key_data)
    e = torch.arange(numel, dtype=torch.int64, device=device)
    rows = []
    for s in range(6):                       # 6 calls x 64 bits = 384 bits
        w0, w1 = _threefry2x32(k0, k1, torch.full_like(e, s), e)
        for wrd in (w0, w1):
            rows.append(wrd & MASK)
            rows.append(wrd >> W)
    return mont._redc384_rows(rows).to(torch.int32)


def _threefry_redc384(key_data, c0_base, c1):
    """The sampler's draw at arbitrary counters: canonical limbs int64
    [L, ...] of the 384-bit Threefry draw with counters (c0_base + s, c1),
    s = 0..5, words in the sampler's order, through redc384. c0_base, c1:
    int64 tensors of one shape holding uint32 values. The dealer draws and
    the check-aggregation vector of ops/fused_randousha.py use it."""
    k0, k1 = _key_ints(key_data)
    rows = []
    for s in range(6):
        w0, w1 = _threefry2x32(k0, k1, (c0_base + s) & _M32, c1)
        for wrd in (w0, w1):
            rows.append(wrd & MASK)
            rows.append(wrd >> W)
    return mont._redc384_rows(rows)


def _rand_limbs_words(key_data, e):
    """Plain twin of csrc/rand_limbs.cu's word path: elements at counters
    e (int64 tensor of uint32 values) -> int32 [L, ...]. The 12 Threefry
    words at counters (s, e), s = 0..5, through the 32-bit REDC
    (band_gemm._redc384_words), each packed word split into its two
    16-bit limbs."""
    k0, k1 = _key_ints(key_data)
    x = []
    for s in range(6):
        x.extend(_threefry2x32(k0, k1, torch.full_like(e, s), e & _M32))
    return unpack_limbs(_redc384_words(x))


def rand_wave() -> int:
    """Elements one pass of csrc/rand_limbs.cu's resident grid draws on the
    current CUDA device (its blocks resident on every SM x threads x
    elements per thread); the launch is one pass of that grid at most."""
    from .._build import lib
    per_wave = lib().hb_rand_limbs_wave()
    if per_wave <= 0:
        raise RuntimeError(f"rand_limbs occupancy query failed: CUDA error "
                           f"{-per_wave}")
    return per_wave


def _rand_limbs_cuda(key_data, numel: int, device):
    """Launch csrc/rand_limbs.cu: int32 [L, numel] on the CUDA `device`."""
    global launches
    from .._build import lib
    k0, k1 = _key_ints(key_data)
    out = torch.empty((L, numel), dtype=torch.int32, device=device)
    rc = lib().hb_rand_limbs(k0, k1, out.data_ptr(), numel,
                             _launch_stream(out))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"rand_limbs kernel launch failed: CUDA error {rc}")
    return out


def rand_limbs(key_data, numel: int, device=torch.device("cuda")):
    """Threefry key (two uint32) -> int32 [L, numel] canonical limbs, each
    element uniform mod p (distance < 2^-129). Counter layout: element
    index e uses Threefry counters (s, e), s = 0..5."""
    device = torch.device(device)
    if not 0 < numel < (1 << 32):
        raise ValueError(f"numel must be in (0, 2^32), got {numel}")
    if device.type == "cuda":
        return _rand_limbs_cuda(key_data, numel, device)
    return _rand_limbs_plain(key_data, numel, device)


# ---------------------------------------------------------------------------
# Packed finish arithmetic on the 4D layout [PL, n, R, S]
# ---------------------------------------------------------------------------

def _check_packed4(x, name: str):
    if x.dtype != torch.int32 or x.dim() != 4 or x.shape[0] != PL:
        raise ValueError(f"{name} must be int32 [{PL}, n, R, S], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _mul_add_packed4_plain(a, b, c, chunk: int = 8):
    """Plain PyTorch version of mul_add_packed4: [PL, n, R, S] each ->
    [PL, n, R, S]. Works through the party axis `chunk` parties at a time
    (the int64 carry-save accumulator is 17 words per element)."""
    outs = []
    for j in range(0, a.shape[1], chunk):
        la, lb, lc = (unpack_limbs(x[:, j:j + chunk]) for x in (a, b, c))
        outs.append(pack_limbs(mont.add_mod(mont._mont_mul_plain(la, lb),
                                             lc)))
    return torch.cat(outs, dim=1)


def _mul_add_packed4_cuda(a, b, c, pad: int):
    """Launch csrc/packed_arith.cu::mul_add_packed4_kernel (grid: R*S
    elements along x, the n parties along y). The output buffer is
    [PL, n, R*S + pad]; only its tail is zeroed here, the kernel writes the
    rest."""
    global launches_mul_add4
    from .._build import lib
    _, n, R, S = a.shape
    if n > 65535:
        raise ValueError(f"{n} parties exceed the kernel's grid (65,535)")
    out = torch.empty((PL, n, R * S + pad), dtype=torch.int32,
                      device=a.device)
    if pad:
        out[:, :, R * S:] = 0
    if n * R * S == 0:
        return out
    rc = lib().hb_mul_add_packed4(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                  out.data_ptr(), n * R * S, R * S,
                                  R * S + pad, _launch_stream(a))
    launches_mul_add4 += 1
    if rc != 0:
        raise RuntimeError(
            f"mul_add_packed4 kernel launch failed: CUDA error {rc}")
    return out


def mul_add_packed4_flat(a, b, c, pad: int = 0):
    """mul_add_packed4 with the result FLAT, int32 [PL, n, R*S + pad]:
    `pad` zero columns (0 allowed) after each party's R*S values. The form
    the degree-2t open of the triple finish wants (its column count must be
    a multiple of 2t+1), produced without a concatenate pass over the
    tensor."""
    for x, name in ((a, "a"), (b, "b"), (c, "c")):
        _check_packed4(x, name)
    if not (a.shape == b.shape == c.shape) \
            or not (a.device == b.device == c.device):
        raise ValueError("a, b, c must share one shape and one device")
    if a.is_cuda:
        return _mul_add_packed4_cuda(a, b, c, pad)
    _, n, R, S = a.shape
    out = _mul_add_packed4_plain(a, b, c).reshape(PL, n, R * S)
    if pad:
        out = torch.cat([out, out.new_zeros((PL, n, pad))], dim=-1)
    return out


def mul_add_packed4(a, b, c):
    """(a*b + c) mod p elementwise (Montgomery product) on PACKED words in
    the extraction kernels' native layout int32 [PL, n, R, S] ->
    [PL, n, R, S]."""
    return mul_add_packed4_flat(a, b, c).reshape(a.shape)


def _sub_bcast_packed4_plain(a, b, chunk: int = 8):
    """Plain PyTorch version of sub_bcast_packed4: a [PL, R, S],
    b [PL, n, R, S] -> [PL, n, R, S]."""
    la = unpack_limbs(a)[:, None]
    outs = [pack_limbs(mont.sub_mod(la, unpack_limbs(b[:, j:j + chunk])))
            for j in range(0, b.shape[1], chunk)]
    return torch.cat(outs, dim=1)


def _sub_bcast_packed4_cuda(a, b):
    """Launch csrc/packed_arith.cu::sub_bcast_packed4_kernel."""
    global launches_sub_bcast4
    from .._build import lib
    _, n, R, S = b.shape
    out = torch.empty_like(b)
    rc = lib().hb_sub_bcast_packed4(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), n * R * S, R * S,
                                    a.stride(0), _launch_stream(b))
    launches_sub_bcast4 += 1
    if rc != 0:
        raise RuntimeError(
            f"sub_bcast_packed4 kernel launch failed: CUDA error {rc}")
    return out


def sub_bcast_packed4(a, b):
    """(a - b) mod p on PACKED words in the native 4D layout: the shared
    minuend `a` int32 [PL, R, S] (one copy of an opened value) against
    per-party `b` [PL, n, R, S] -> [PL, n, R, S]. The n-replicated minuend
    never exists in memory. `a` may be a view whose word planes lie apart
    (a prefix of a longer opened tensor): only its inner [R, S] block must
    be dense."""
    _check_packed4(b, "b")
    _, n, R, S = b.shape
    if a.dtype != torch.int32 or tuple(a.shape) != (PL, R, S) \
            or a.device != b.device:
        raise ValueError(f"a must be int32 [{PL}, {R}, {S}] on {b.device}, "
                         f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    if (S > 1 and a.stride(2) != 1) or (R > 1 and a.stride(1) != S):
        raise ValueError("the inner [R, S] block of a must be dense")
    if b.is_cuda:
        return _sub_bcast_packed4_cuda(a, b)
    return _sub_bcast_packed4_plain(a, b)


def _sub_bcast_packed_plain(a, b, chunk: int = 8):
    """Plain PyTorch version of sub_bcast_packed: a [PL, B], b [PL, n, B]
    -> [PL, n, B]. The broadcast subtract of the 4D one, on flat words."""
    global plain_calls_on_cuda
    if a.is_cuda:
        plain_calls_on_cuda += 1
    return _sub_bcast_packed4_plain(a, b, chunk)


def sub_bcast_packed(a, b):
    """(a - b) mod p on flat PACKED words: the shared minuend `a` int32
    [PL, B] (one copy of an opened value) against per-party `b`
    [PL, n, B] -> [PL, n, B] (dense), for any B (the reference pads B to
    its TPU tile; the kernel masks its edge). The n-replicated minuend
    never exists in memory. `a` and `b` may be views whose rows lie apart
    (a prefix of a longer opened tensor, a column slice of the padded keep
    tensor): only each row must be dense.
    csrc/packed_arith.cu::sub_bcast_packed_kernel on CUDA tensors, the
    plain version on CPU ones."""
    global launches_sub_bcast
    if b.dtype != torch.int32 or b.dim() != 3 or b.shape[0] != PL:
        raise ValueError(f"b must be int32 [{PL}, n, B], got "
                         f"{b.dtype} {tuple(b.shape)}")
    _, n, B = b.shape
    if a.dtype != torch.int32 or tuple(a.shape) != (PL, B) \
            or a.device != b.device:
        raise ValueError(f"a must be int32 [{PL}, {B}] on {b.device}, got "
                         f"{a.dtype} {tuple(a.shape)} on {a.device}")
    if B > 1 and (a.stride(1) != 1 or b.stride(2) != 1):
        raise ValueError("each word row of a and of b must be dense")
    if not b.is_cuda:
        return _sub_bcast_packed_plain(a, b)
    from .._build import lib
    out = torch.empty((PL, n, B), dtype=torch.int32, device=b.device)
    if b.numel() == 0:
        return out
    rc = lib().hb_sub_bcast_packed(a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), n * B, B, a.stride(0),
                                   b.stride(0), b.stride(1),
                                   _launch_stream(b))
    launches_sub_bcast += 1
    if rc != 0:
        raise RuntimeError(
            f"sub_bcast_packed kernel launch failed: CUDA error {rc}")
    return out


def _mul_add_packed_plain(a, b, c, chunk: int = 1 << 20):
    """Plain PyTorch version of mul_add_packed: [PL, B] each -> [PL, B],
    `chunk` elements at a time (the int64 carry-save accumulator is 17
    words per element)."""
    outs = []
    for j in range(0, a.shape[1], chunk):
        la, lb, lc = (unpack_limbs(x[:, j:j + chunk]) for x in (a, b, c))
        outs.append(pack_limbs(mont.add_mod(mont._mont_mul_plain(la, lb),
                                             lc)))
    return torch.cat(outs, dim=1)


def mul_add_packed(a, b, c):
    """(a*b + c) mod p elementwise (Montgomery product) on flat PACKED
    words int32 [PL, B] -> [PL, B]: csrc/packed_arith.cu::
    mul_add_packed_kernel on CUDA tensors, the plain version on CPU ones."""
    global launches_mul_add
    for x, name in ((a, "a"), (b, "b"), (c, "c")):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != PL:
            raise ValueError(f"{name} must be int32 [{PL}, B], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (a.shape == b.shape == c.shape) \
            or not (a.device == b.device == c.device):
        raise ValueError("a, b, c must share one shape and one device")
    if not a.is_cuda:
        return _mul_add_packed_plain(a, b, c)
    from .._build import lib
    out = torch.empty_like(a)
    B = a.shape[1]
    if B == 0:
        return out
    rc = lib().hb_mul_add_packed(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                 out.data_ptr(), B, _launch_stream(a))
    launches_mul_add += 1
    if rc != 0:
        raise RuntimeError(
            f"mul_add_packed kernel launch failed: CUDA error {rc}")
    return out


# ---------------------------------------------------------------------------
# Elementwise Montgomery multiply and the CIOS matmul
# ---------------------------------------------------------------------------

def _check_limbs(x, name: str):
    if x.dtype != torch.int32 or x.dim() < 1 or x.shape[0] != L:
        raise ValueError(f"{name} must be int32 [{L}, ...], got "
                         f"{x.dtype} {tuple(x.shape)}")


def mont_mul_pallas(a, b):
    """Elementwise a*b*R^-1 mod p of limb tensors int32 [L, *shape] of one
    shape (broadcasting is the caller's): csrc/mont_mul.cu on a CUDA
    tensor, the plain version on a CPU tensor."""
    global launches_mont_mul
    _check_limbs(a, "a")
    _check_limbs(b, "b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} and b "
                         f"{tuple(b.shape)} on {b.device} must match")
    if not a.is_cuda:
        return mont._mont_mul_plain(a, b)
    from .._build import lib
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    numel = a[0].numel()
    if numel == 0:
        return out
    rc = lib().hb_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), numel,
                           _launch_stream(a))
    launches_mont_mul += 1
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {rc}")
    return out


# csrc/fp_matmul_cios.cu's launch constants and the plan's fill target
CIOS_THREADS = 128          # threads per block
CIOS_CHUNK = 64             # terms a lane sums before one reduction
CIOS_WARPS_PER_SM = 4       # warps per SM the split aims for
_CIOS_MAX_OUTPUTS = 2 ** 31 - CIOS_THREADS


def _cios_plan(B: int, k: int, n: int, nsm: int = 132) -> int:
    """The split of csrc/fp_matmul_cios.cu for a[L, B, k] @ v[L, k, n]:
    lanes per output, the least power of two that puts CIOS_WARPS_PER_SM
    warps on each of `nsm` SMs, at most 32 (a warp) and at most k rounded
    up to a power of two (a lane without a term only adds 0). Any shape
    with 0 < B*n < 2^31 - 128 has one; the grid is ceil(B*n*split / 128)
    blocks."""
    outputs = B * n
    if not 0 < outputs < _CIOS_MAX_OUTPUTS or k < 0:
        raise ValueError(f"no CIOS plan for B={B} k={k} n={n}")
    split = 1
    while split < min(32, k) \
            and outputs * split < CIOS_WARPS_PER_SM * 32 * nsm:
        split *= 2
    return split


def _mul_lo_hi(x, y):
    """Low and high 32-bit halves of x*y for int64 tensors (or ints)
    holding uint32 values, without overflowing int64."""
    xl, xh = x & 0xFFFF, x >> 16
    yl, yh = y & 0xFFFF, y >> 16
    mid = xl * yh + xh * yl                   # < 2^33
    low = xl * yl + ((mid & 0xFFFF) << 16)    # < 2^33
    return low & _M32, xh * yh + (mid >> 16) + (low >> 32)


def _chain(t, at, c, halves):
    """t[at..at+7] += halves[0..7] as one carry chain (mad.lo/hi.cc,
    madc); returns c plus the chain's carry out (addc)."""
    cf = 0
    for j in range(8):
        s = t[at + j] + halves[j] + cf
        t[at + j] = s & _M32
        cf = s >> 32
    return c + cf


def _cond_sub9(x, d):
    """x (9 words) - d where x >= d, else x; and whether it subtracted.
    d: 9 ints."""
    r, borrow = [], 0
    for xi, di in zip(x, d):
        v = xi - di - borrow
        r.append(v & _M32)
        borrow = (v < 0).to(torch.int64)
    take = borrow == 0
    return [torch.where(take, ri, xi) for ri, xi in zip(r, x)], take


_P_WORDS = [(P >> (32 * j)) & _M32 for j in range(8)]


def _add_mod_words(a, b):
    """add_mod_w on lists of 8 word tensors: canonical (a + b) mod p."""
    out, c = [], 0
    for ai, bi in zip(a, b):
        s = ai + bi + c
        out.append(s & _M32)
        c = s >> 32
    return _cond_sub9(out + [c], _P_WORDS + [0])[0][:8]


def _redc_wide_words(acc, cc):
    """redc_wide's arithmetic: the wide sum (16 accumulator words, 9 carry
    words at words 8-16) of at most CIOS_CHUNK terms -> 8 canonical words
    of T * 2^-256 mod p. Checks the bounds the kernel relies on (the
    reduction's words 0-7 zero, the carry words below 2^32, the result
    below p after the five subtracts)."""
    acc, cc = list(acc), list(cc)
    for i in range(8):
        m = (-acc[i]) & _M32                  # acc[i] * (2^32 - 1)
        lo_hi = [_mul_lo_hi(m, pj) for pj in _P_WORDS]
        cc[i] = _chain(acc, i, cc[i], [h[0] for h in lo_hi])
        cc[i + 1] = _chain(acc, i + 1, cc[i + 1], [h[1] for h in lo_hi])
        assert not bool((acc[i] != 0).any())
    v, c = [], 0
    for j in range(8):
        s = acc[8 + j] + cc[j] + c
        v.append(s & _M32)
        c = s >> 32
    v.append(cc[8] + c)
    assert not any(bool((w >> 32).any()) for w in cc + [v[8]])
    for s in range(4, -1, -1):                # V < 32p -> V mod p
        v, _ = _cond_sub9(v, [((P << s) >> (32 * j)) & _M32
                              for j in range(9)])
    _, ge_p = _cond_sub9(v, _P_WORDS + [0])
    assert not bool(ge_p.any()), "reduced sum not below p"
    return v[:8]


def _cios_words_model(a, v, split: int):
    """Plain twin of csrc/fp_matmul_cios.cu's arithmetic on int64 words
    (CPU): a[L, B, k] @ v[L, k, n] int32 limbs -> [L, B, n]. Lane s of
    an output's `split` lanes takes the terms s, s + split, ...; it sums
    each run of CIOS_CHUNK of them unreduced in 30 columns of 16 bits
    (a's limb i times v's word j into column i + 2j, mac_cols), folds the
    columns into 17 words and reduces each run once (redc_cols,
    _redc_wide_words), adds the runs mod p; the lanes then combine in the
    xor butterfly. Lanes and runs are tensor axes here, the terms of a run
    a loop. Checks the bounds the kernel relies on."""
    _, B, k = a.shape
    n = v.shape[2]
    xa = a.to(torch.int64)                            # [16, B, k] limbs
    yv = pack_limbs(v).to(torch.int64) & _M32         # [8, k, n]
    per_lane = -(-k // split)
    runs = max(1, -(-per_lane // CIOS_CHUNK))
    lane = torch.arange(split).reshape(split, 1)
    run = torch.arange(runs).reshape(1, runs)
    cols = torch.zeros((30, B, n, split, runs), dtype=torch.int64)
    for t in range(CIOS_CHUNK):
        kk = lane + split * (run * CIOS_CHUNK + t)    # [split, runs]
        live = kk < k
        if not bool(live.any()):
            break
        kc = kk.clamp(max=max(k - 1, 0))
        x = torch.where(live, xa[:, :, kc], 0)[:, :, None]     # [16,B,1,s,r]
        for j in range(8):
            y = torch.where(live[..., None], yv[j][kc], 0).permute(2, 0, 1)
            cols[2 * j:2 * j + 16] += x * y[None, None]
    assert not bool((cols >> 57).any()), "a column passed 2^57"
    acc, carry = [], 0
    for w in range(16):                               # redc_cols' fold
        hi = cols[2 * w + 1] if 2 * w + 1 < 30 else 0
        lo = cols[2 * w] if 2 * w < 30 else 0
        s = lo + ((hi & 0xFFFF) << 16) + carry
        acc.append(s & _M32)
        carry = (s >> 32) + (hi >> 16)
    zero = torch.zeros_like(cols[0])
    part = _redc_wide_words(acc, [zero] * 8 + [zero + carry])
    total = [torch.zeros((B, n, split), dtype=torch.int64)] * 8
    for r in range(runs):
        total = _add_mod_words(total, [w[..., r] for w in part])
    off = split // 2
    while off:                                        # the butterfly
        idx = torch.arange(split) ^ off
        total = _add_mod_words(total, [w[..., idx] for w in total])
        off //= 2
    for w in total:
        assert bool((w == w[..., :1]).all()), "lanes disagree"
    words = torch.stack([w[..., 0] for w in total])   # [8, B, n]
    limbs = torch.stack([words & 0xFFFF, words >> 16], dim=1)
    return limbs.reshape(L, B, n).to(torch.int32)


def _fp_matmul_cios_cuda(a, v, split=None):
    """Launch csrc/fp_matmul_cios.cu at `split` lanes per output (default:
    _cios_plan's)."""
    global launches_matmul
    from .._build import lib
    _, B, k = a.shape
    n = v.shape[2]
    out = torch.empty((L, B, n), dtype=torch.int32, device=a.device)
    if B * n == 0:
        return out
    if split is None:
        split = _cios_plan(B, k, n, torch.cuda.get_device_properties(
            a.device).multi_processor_count)
    a, v = a.contiguous(), v.contiguous()
    rc = lib().hb_fp_matmul_cios(a.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 B, k, n, split, _launch_stream(a))
    launches_matmul += 1
    if rc != 0:
        raise RuntimeError(
            f"fp_matmul_cios kernel launch failed: CUDA error {rc}")
    return out


def fp_matmul_pallas(a, v):
    """a[L, B, k] @ v[L, k, n] -> [L, B, n] over GF(p), Montgomery form:
    csrc/fp_matmul_cios.cu on a CUDA tensor (the contraction split over
    _cios_plan's lanes per output), the plain scan of mont_mul and add_mod
    on a CPU tensor."""
    _check_limbs(a, "a")
    _check_limbs(v, "v")
    if a.dim() != 3 or v.dim() != 3 or a.shape[2] != v.shape[1] \
            or a.device != v.device:
        raise ValueError(f"need a [L, B, k] and v [L, k, n] on one device, "
                         f"got {tuple(a.shape)}, {tuple(v.shape)}")
    if not a.is_cuda:
        from .fpmatmul import _matmul_kernel
        return _matmul_kernel(a, v, mul=mont._mont_mul_plain)
    return _fp_matmul_cios_cuda(a, v)
