"""Berlekamp-Welch robust decoding (HoneyBadgerMPC reed_solomon_wb.py:47-273).

Counterpart of ``honeybadgermpc_tpu/ops/welch_berlekamp.py``, copied: host
linear algebra in Python ints; ``wb_robust_decode`` takes and returns
FpArrays on the caller's device.

The linear-system formulation: find E(x) (monic, degree e) and Q(x)
(degree < k + e) with Q(x_i) = y_i * E(x_i) for all i; then P = Q / E.
Kept as the host-side fallback algorithm (Algorithm.WELCH_BERLEKAMP in the
reconstruction config) and as an independent oracle for the Gao kernel —
the reference maintains both for the same reason (reed_solomon.py:189).
"""

from __future__ import annotations

from ..ops.limbs import P


def _rref_solve(rows, ncols):
    """Gaussian elimination over GF(p); returns one solution with free
    variables set to 1 (reed_solomon_wb.py:157-273) or None."""
    m = [r[:] for r in rows]
    nr = len(m)
    pivots = []
    r = 0
    for c in range(ncols):
        pr = None
        for rr in range(r, nr):
            if m[rr][c] % P:
                pr = rr
                break
        if pr is None:
            continue
        m[r], m[pr] = m[pr], m[r]
        inv = pow(m[r][c], P - 2, P)
        m[r] = [v * inv % P for v in m[r]]
        for rr in range(nr):
            if rr != r and m[rr][c] % P:
                f = m[rr][c]
                m[rr] = [(a - f * b) % P for a, b in zip(m[rr], m[r])]
        pivots.append(c)
        r += 1
        if r == nr:
            break
    # consistency
    for rr in range(r, nr):
        if any(v % P for v in m[rr][:ncols]) == 0 and m[rr][ncols] % P:
            return None
    sol = [0] * ncols
    free = set(range(ncols)) - set(pivots)
    for c in free:
        sol[c] = 1
    for i in range(len(pivots) - 1, -1, -1):
        c = pivots[i]
        acc = m[i][ncols]
        for c2 in range(c + 1, ncols):
            acc = (acc - m[i][c2] * sol[c2]) % P
        sol[c] = acc
    return sol


def _polydiv(num, den):
    num = [v % P for v in num]
    den = [v % P for v in den]
    while den and den[-1] == 0:
        den.pop()
    out = [0] * max(len(num) - len(den) + 1, 1)
    inv = pow(den[-1], P - 2, P)
    while len(num) >= len(den) and any(num):
        while num and num[-1] == 0:
            num.pop()
        if len(num) < len(den):
            break
        c = num[-1] * inv % P
        off = len(num) - len(den)
        out[off] = c
        for i in range(len(den)):
            num[off + i] = (num[off + i] - c * den[i]) % P
        num.pop()
    rem = [v for v in num]
    return out, rem


def wb_decode(xs, ys, k: int, e: int | None = None):
    """Decode a degree<k message from points (xs, ys) with up to e errors
    (default (len-k)//2). Returns coefficient list or None."""
    nn = len(xs)
    if e is None:
        e = (nn - k) // 2
    if e == 0:
        # no error budget: interpolate from the first k points, then REQUIRE
        # every point to lie on the curve (without this check a corrupt
        # point would silently decode to garbage — reference
        # reed_solomon_wb.py raises unless the system is consistent)
        out = _lagrange(xs[:k], ys[:k], k)
        if all(_horner(out, x) == y % P for x, y in zip(xs, ys)):
            return out
        return None
    # unknowns: Q coeffs (k+e), E coeffs (e) (E monic: x^e + ...)
    nq, ne = k + e, e
    rows = []
    for x, y in zip(xs, ys):
        row = []
        xp = 1
        for _ in range(nq):
            row.append(xp)
            xp = xp * x % P
        xp = 1
        for _ in range(ne):
            row.append((-y * xp) % P)
            xp = xp * x % P
        rhs = y * pow(x, e, P) % P
        rows.append(row + [rhs])
    sol = _rref_solve(rows, nq + ne)
    if sol is None:
        return None
    q = sol[:nq]
    e_poly = sol[nq:] + [1]
    p_coeffs, rem = _polydiv(q, e_poly)
    if any(rem):
        return None
    out = [v % P for v in p_coeffs[:k]]
    out += [0] * (k - len(out))
    # verify against a majority of points
    agree = sum(1 for x, y in zip(xs, ys) if _horner(out, x) == y % P)
    return out if agree >= nn - e else None


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def _lagrange(xs, ys, k):
    out = [0] * k
    for j, (xj, yj) in enumerate(zip(xs, ys)):
        num = [1]
        den = 1
        for m, xm in enumerate(xs):
            if m == j:
                continue
            nxt = [0] * (len(num) + 1)
            for i, c in enumerate(num):
                nxt[i] = (nxt[i] - c * xm) % P
                nxt[i + 1] = (nxt[i + 1] + c) % P
            num = nxt
            den = den * (xj - xm) % P
        f = yj * pow(den, P - 2, P) % P
        for i in range(min(len(num), k)):
            out[i] = (out[i] + f * num[i]) % P
    return out


def wb_robust_decode(enc, zs, ys, k: int):
    """Interface twin of gao_robust_decode (ops/gao.py): decode a
    degree<k message from shares ys[..., m] of parties zs, with up to
    (m-k)//2 wrong shares. Returns (coeffs[..., k], reenc[..., m], ok[...])
    with the FpArrays on ys's device and ok a numpy bool array.

    This is the ``Algorithm.WELCH_BERLEKAMP`` branch of the runtime's
    robust-decoder selection (reference RobustDecoderFactory,
    reed_solomon.py:545-558) — host linear algebra, like the reference's
    pure-Python reed_solomon_wb.py; the Gao kernel remains the fast path.
    """
    import numpy as np

    from .fparray import FpArray

    xs = [int(enc.points[z]) % P for z in zs]
    m = len(xs)
    arr = ys.to_ints()
    shape = arr.shape[:-1]
    flat = arr.reshape(-1, m)
    coeffs, reenc, ok = [], [], []
    for row in flat:
        got = wb_decode(xs, [int(v) for v in row], k)
        if got is None:
            coeffs.append([0] * k)
            reenc.append([0] * m)
            ok.append(False)
        else:
            coeffs.append(got)
            reenc.append([_horner(got, x) for x in xs])
            ok.append(True)
    dev = ys.device
    return (
        FpArray.from_ints(np.array(coeffs, dtype=object).reshape(shape + (k,)),
                          dev),
        FpArray.from_ints(np.array(reenc, dtype=object).reshape(shape + (m,)),
                          dev),
        np.array(ok, dtype=bool).reshape(shape),
    )


def make_wb_encoder_decoder(n, k, p, point=None):
    """API parity with reference reed_solomon_wb.py:47: returns
    (encode, decode, solve_system)."""
    assert p == P
    xs = [point(i) if point else i + 1 for i in range(n)]
    xs = [int(x) for x in xs]

    def encode(msg_coeffs):
        cs = [int(c) for c in msg_coeffs]
        return [_horner(cs, x) for x in xs]

    def decode(encoded, debug=False):
        pts = [(x, int(y)) for x, y in zip(xs, encoded) if y is not None]
        got = wb_decode([x for x, _ in pts], [y for _, y in pts], k)
        return got

    return encode, decode, _rref_solve
