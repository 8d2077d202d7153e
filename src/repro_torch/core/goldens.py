"""Pure-Python golden model for Posit<n,es> (scalar, arbitrary-precision).

A copy of the reference package's ``core/goldens.py``: exact rational
arithmetic with Python ints, structurally different from both the SRT
datapath twin (``kernels/posit_div.py``) and the CUDA kernels, so agreement
is meaningful.  ``chip_smoke.py`` holds the pattern-divide kernel (K11)
against :func:`div` on the card.  Handles any n (Posit8..Posit64) with es
parametric (default 2).
"""

from __future__ import annotations


def decode(p: int, n: int, es: int = 2):
    """-> ('zero',) | ('nar',) | ('num', sign, scale, sig) with sig in [2^F, 2^{F+1})."""
    mask = (1 << n) - 1
    p &= mask
    if p == 0:
        return ("zero",)
    if p == 1 << (n - 1):
        return ("nar",)
    sign = (p >> (n - 1)) & 1
    mag = ((~p + 1) & mask) if sign else p

    body = mag & ((1 << (n - 1)) - 1)  # n-1 bits
    bits = [(body >> i) & 1 for i in range(n - 2, -1, -1)]
    r0 = bits[0]
    run = 0
    for b in bits:
        if b == r0:
            run += 1
        else:
            break
    k = (run - 1) if r0 == 1 else -run
    rest = bits[run + 1 :]  # skip terminator (may be absent if run == n-1)

    e = 0
    for i in range(es):
        e <<= 1
        if i < len(rest):
            e |= rest[i]
    fbits = rest[es:]
    F = n - 3 - es
    f = 0
    for i in range(F):
        f <<= 1
        if i < len(fbits):
            f |= fbits[i]
    sig = (1 << F) | f
    scale = (k << es) + e
    return ("num", sign, scale, sig)


def body_value(body: int, n: int, es: int = 2):
    """Exact Fraction value of a positive posit body (1 <= body <= maxpos)."""
    from fractions import Fraction

    d = decode(body, n, es)
    assert d[0] == "num", (body, d)
    _, s, T, sig = d
    F = n - 3 - es
    assert s == 0
    return Fraction(sig, 1 << F) * (Fraction(2) ** T)


def encode_exact(
    sign: int, scale: int, num: int, den: int, n: int, es: int = 2
) -> int:
    """Encode (-1)^sign * 2^scale * (num/den), num/den in [1, 2).

    Round-to-nearest on the exact real value, ties to even body integer,
    saturating to minpos/maxpos (never 0/NaR) — 2022 Posit Standard rounding.
    """
    from fractions import Fraction

    assert den > 0 and den <= num < 2 * den, (num, den)
    F = n - 3 - es
    mask = (1 << n) - 1
    k = scale >> es
    e = scale & ((1 << es) - 1)
    maxpos = (1 << (n - 1)) - 1
    x = Fraction(num, den) * (Fraction(2) ** scale)

    if k > n - 2:
        body = maxpos
    elif k < -(n - 2):
        body = 1
    else:
        if k >= 0:
            l = k + 1
            rpat = ((1 << l) - 1) << 1
            rlen = l + 1
        else:
            l = -k
            rpat = 1
            rlen = l + 1
        m = (n - 1) - rlen  # may be -1 when rlen == n (k == n-2)
        egw = F + es
        m_pos = max(m, 0)
        discard = egw - m_pos
        # eg value (real) = e * 2^F + (num/den - 1) * 2^F, in [0, 2^egw).
        numer = (e << F) * den + (num - den) * (1 << F)  # eg * den
        denom = den << discard
        kept = numer // denom
        if m < 0:
            body_floor = rpat >> 1
        else:
            body_floor = (rpat << m_pos) | kept
        body_floor = min(max(body_floor, 1), maxpos)
        if body_floor >= maxpos:
            body = maxpos
        else:
            v_lo = body_value(body_floor, n, es)
            v_hi = body_value(body_floor + 1, n, es)
            assert v_lo <= x < v_hi, (body_floor, float(v_lo), float(x), float(v_hi))
            if x - v_lo < v_hi - x:
                body = body_floor
            elif x - v_lo > v_hi - x:
                body = body_floor + 1
            else:
                body = body_floor if body_floor % 2 == 0 else body_floor + 1

    p = ((~body + 1) & mask) if sign else body
    return p


def div(px: int, pd: int, n: int, es: int = 2) -> int:
    """Correctly-rounded posit division (golden)."""
    dx = decode(px, n, es)
    dd = decode(pd, n, es)
    if dx[0] == "nar" or dd[0] == "nar" or dd[0] == "zero":
        return 1 << (n - 1)
    if dx[0] == "zero":
        return 0
    _, sx, Tx, sigx = dx
    _, sd, Td, sigd = dd
    sign = sx ^ sd
    scale = Tx - Td
    num, den = sigx, sigd  # ratio in (1/2, 2)
    if num < den:
        num <<= 1
        scale -= 1
    return encode_exact(sign, scale, num, den, n, es)


def to_float(p: int, n: int, es: int = 2) -> float:
    d = decode(p, n, es)
    if d[0] == "zero":
        return 0.0
    if d[0] == "nar":
        return float("nan")
    _, s, T, sig = d
    F = n - 3 - es
    v = sig * (2.0 ** (T - F))
    return -v if s else v


def from_float(x: float, n: int, es: int = 2) -> int:
    """Exact RNE float -> posit (via the float's exact binary expansion)."""
    import math

    if x == 0.0:
        return 0
    if math.isnan(x) or math.isinf(x):
        return 1 << (n - 1)
    sign = 1 if x < 0 else 0
    ax = abs(x)
    m, ex = math.frexp(ax)          # ax = m * 2^ex, m in [0.5, 1)
    num = int(m * (1 << 53))        # exact: doubles have 53-bit mantissa
    den = 1 << 52                   # num/den in [1, 2)
    scale = ex - 1
    return encode_exact(sign, scale, num, den, n, es)


def iter_all(n: int):
    return range(1 << n)
