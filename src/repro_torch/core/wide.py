"""Multi-word registers and the posit64 codec in PyTorch (the CPU twin of
the kernels' wide codec).

Port of the reference package's ``core/wide.py`` (``decode_wide``,
``encode_wide``, ``float_to_posit_wide``, ``posit_wide_to_float``) for
n > 32.  A wide value is a **tuple of 32-bit words, little-endian, each in
an int64 lane holding the unsigned value**, as :mod:`repro_torch.core.posit`
keeps its one-word patterns: CPU torch has no ``uint32``/``uint64`` shifts
and ``>>`` on int64 is arithmetic, while every operation here on values
below 2**33 is exact in int64.  A posit64 pattern is the pair ``(lo, hi)``.

The word helpers (``w_*``) are the ones the SRT datapath twin
(:mod:`repro_torch.kernels.posit_div`) runs its W-word residual on; the
reference keeps its posit64 patterns in its ``BitVec`` (``core/bitvec.py``),
which is not ported (its ``emulate`` backend is ``ROADMAP.md`` work).  The
rounding is the one-word codec's: value-nearest in the deep regime tails,
saturating; f32 inputs are classified by their bit fields; ``2**e`` is
built from two normal factors.
"""

from __future__ import annotations

import torch

from .posit import (
    M32,
    PositFormat,
    _safe_shl,
    _safe_shr,
    clz32,
    float_decompose,
    ldexp_f32,
)


# =====================================================================
# W-word helpers (little-endian tuples of 32-bit words in int64 lanes)
# =====================================================================


def w_const(value: int, words: int, like):
    """The constant ``value`` as a W-word register shaped like ``like``."""
    return tuple(torch.full_like(like, (value >> (32 * i)) & M32) for i in range(words))


def w_shl(w, k: int):
    """Static left shift; bits cross words upward, the top ones fall off."""
    ls, bs = divmod(k, 32)
    out = []
    for i in range(len(w)):
        j = i - ls
        if j < 0:
            out.append(torch.zeros_like(w[0]))
            continue
        cur = ((w[j] << bs) & M32) if bs else w[j]
        if bs and j >= 1:
            cur = cur | (w[j - 1] >> (32 - bs))
        out.append(cur)
    return tuple(out)


def w_shr(w, k: int):
    """Static logical right shift; bits cross words downward."""
    ls, bs = divmod(k, 32)
    out = []
    for i in range(len(w)):
        j = i + ls
        if j >= len(w):
            out.append(torch.zeros_like(w[0]))
            continue
        cur = w[j] >> bs
        if bs and j + 1 < len(w):
            cur = cur | ((w[j + 1] << (32 - bs)) & M32)
        out.append(cur)
    return tuple(out)


def w_add(a, b, cin=None):
    """Full W-word add modulo 2**(32W) (ripple carry); ``cin`` is 0/1."""
    out = []
    carry = cin
    for x, y in zip(a, b):
        s = x + y if carry is None else x + y + carry
        out.append(s & M32)
        carry = s >> 32
    return tuple(out)


def w_not(w):
    return tuple(x ^ M32 for x in w)


def w_sel(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def w_bit(w, pos: int):
    """Bit ``pos`` (static) as 0/1."""
    return (w[pos // 32] >> (pos % 32)) & 1


def w_nonzero(w):
    acc = w[0]
    for x in w[1:]:
        acc = acc | x
    return acc != 0


def w_low_nonzero(w, nbits: int):
    """``(w mod 2**nbits) != 0`` for a static ``nbits``."""
    acc = None
    for i, x in enumerate(w):
        lo = 32 * i
        if nbits <= lo:
            break
        word = x if nbits >= lo + 32 else x & ((1 << (nbits - lo)) - 1)
        acc = word if acc is None else acc | word
    if acc is None:
        return torch.zeros_like(w[0], dtype=torch.bool)
    return acc != 0


def w_mask(w, nbits: int):
    """Keep the low ``nbits`` (static) bits."""
    out = []
    for i, x in enumerate(w):
        lo = 32 * i
        if nbits <= lo:
            out.append(torch.zeros_like(x))
        elif nbits >= lo + 32:
            out.append(x)
        else:
            out.append(x & ((1 << (nbits - lo)) - 1))
    return tuple(out)


def w_neg(w):
    """Two's-complement negation modulo 2**(32W)."""
    return w_add(w_not(w), tuple(torch.zeros_like(x) for x in w), torch.ones_like(w[0]))


def w_ult(a, b):
    """Unsigned ``a < b``."""
    lt = a[0] < b[0]
    for x, y in zip(a[1:], b[1:]):
        lt = torch.where(x == y, lt, x < y)
    return lt


def w_eq(a, b):
    eq = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        eq = eq & (x == y)
    return eq


def w_shl_dyn(w, s):
    """Left shift by a per-element amount; one outside [0, 32W) gives 0."""
    s = torch.as_tensor(s, device=w[0].device)
    out = [torch.zeros_like(w[0]) for _ in w]
    for ls in range(len(w)):
        bs = s - 32 * ls
        here = (bs >= 0) & (bs < 32)
        for i in range(ls, len(w)):
            j = i - ls
            part = _safe_shl(w[j], bs)
            if j >= 1:
                part = part | _safe_shr(w[j - 1], 32 - bs)
            out[i] = out[i] | torch.where(here, part, 0)
    return tuple(out)


def w_shr_dyn(w, s):
    """Logical right shift by a per-element amount; one outside [0, 32W)
    gives 0."""
    s = torch.as_tensor(s, device=w[0].device)
    out = [torch.zeros_like(w[0]) for _ in w]
    for ls in range(len(w)):
        bs = s - 32 * ls
        here = (bs >= 0) & (bs < 32)
        for i in range(len(w) - ls):
            j = i + ls
            part = _safe_shr(w[j], bs)
            if j + 1 < len(w):
                part = part | _safe_shl(w[j + 1], 32 - bs)
            out[i] = out[i] | torch.where(here, part, 0)
    return tuple(out)


def w_clz(w):
    """Leading zeros of the whole register (32W for 0)."""
    acc = torch.zeros_like(w[0])
    seen = torch.zeros_like(w[0], dtype=torch.bool)
    for x in reversed(w):
        acc = torch.where(seen, acc, acc + clz32(x))
        seen = seen | (x != 0)
    return acc


F32_MIN_NORMAL = 2.0 ** -126


def _check(fmt: PositFormat):
    if fmt.n != 64:
        raise ValueError(f"the wide codec takes posit64 (two-word patterns), not {fmt}")


# =====================================================================
# decode / encode (reference core/wide.py :65 / :98)
# =====================================================================


def decode_wide(fmt: PositFormat, p):
    """Decode posit64 patterns ``(lo, hi)``.

    Returns ``(sign, scale, sig, is_zero, is_nar)`` with ``sig`` the
    (F+1)-bit significand as two words, hidden bit included."""
    _check(fmt)
    n, es, F = fmt.n, fmt.es, fmt.F
    p = tuple(x.long() & M32 for x in p)
    like = p[0]
    is_zero = ~w_nonzero(p)
    is_nar = w_eq(p, w_const(fmt.nar_pattern, 2, like))
    sign = w_bit(p, n - 1).bool()
    mag = w_sel(sign, w_neg(p), p)

    body = w_shl(mag, 1)                     # n-1 bits left-aligned at bit n-1
    r0 = w_bit(body, n - 1).bool()
    inv = w_sel(r0, w_not(body), body)
    run = torch.clamp(w_clz(inv), max=n - 1)
    k = torch.where(r0, run - 1, -run)

    tail = w_shl_dyn(body, run + 1)
    e = w_shr(tail, n - es)[0]
    sig = w_shr(w_shl(tail, es), n - F)      # F bits, the fraction
    sig = (sig[0], sig[1] | (1 << (F - 32)))  # hidden bit
    scale = k * (1 << es) + e
    return sign, scale, sig, is_zero, is_nar


def encode_wide(fmt: PositFormat, sign, scale, frac, round_bit, sticky, is_zero, is_nar):
    """Assemble and round a posit64 (value-nearest, saturating) from sign,
    scale, the F-bit fraction ``frac`` (two words) and the G/R/S bits."""
    _check(fmt)
    n, es, F = fmt.n, fmt.es, fmt.F
    like = frac[0]
    scale = scale.long()
    round_bit = round_bit.long() & 1
    sticky = sticky.bool()

    k = scale >> es
    e = scale & ((1 << es) - 1)
    over = k > (n - 2)
    under = k < -(n - 2)
    kc = torch.clamp(k, -(n - 2), n - 2)

    pos = kc >= 0
    l = torch.where(pos, kc + 1, -kc)
    rlen = l + 1
    ones = w_const(1, 2, like)
    two = w_const(2, 2, like)
    rpat_pos = w_add(w_shl_dyn(ones, l + 1), w_neg(two))
    rpat = w_sel(pos, rpat_pos, ones)

    egw = F + es
    eg = (frac[0], frac[1] | (e << (F - 32)))  # exponent || fraction
    m = (n - 1) - rlen
    m_pos = torch.clamp(m, min=0)
    discard = egw - m_pos

    kept = w_shr_dyn(eg, discard)
    g_from_eg = w_shr_dyn(eg, torch.clamp(discard - 1, min=0))[0] & 1
    guard = torch.where(discard > 0, g_from_eg, round_bit)
    below = w_add(w_shl_dyn(ones, torch.clamp(discard - 1, min=0)), w_neg(ones))
    st_eg = w_nonzero(tuple(x & y for x, y in zip(eg, below)))
    sticky_full = torch.where(discard > 0, st_eg | (round_bit != 0) | sticky, sticky)

    trunc_regime = m < 0
    body_base = w_sel(trunc_regime, w_shr(rpat, 1),
                      tuple(x | y for x, y in zip(w_shl_dyn(rpat, m_pos), kept)))
    lsb = body_base[0] & 1
    inc_linear = guard & (sticky_full.long() | lsb)

    # value-nearest deep-regime rounding (c discarded exponent bits)
    c = discard - F
    f_ext = w_shl(frac, 2)
    f_ext = (f_ext[0] | (round_bit << 1) | sticky.long(), f_ext[1])
    thr = w_sel(c == 1, w_const(1 << F, 2, like), w_const(1 << (F - 2), 2, like))
    e_cond = torch.where(c == 1, (e & 1) == 1, (e & 3) == 3)
    deep_up = e_cond & (w_ult(thr, f_ext) | (w_eq(f_ext, thr) & (lsb == 1)))
    deep = (c >= 1) & (m >= 0)
    inc = torch.where(deep, deep_up.long(), inc_linear)
    inc = torch.where(trunc_regime, 0, inc)

    zero2 = (torch.zeros_like(like), torch.zeros_like(like))
    body = w_add(body_base, zero2, inc)
    maxpos = w_const(fmt.maxpos_body, 2, like)
    body = w_sel(over | w_ult(maxpos, body), maxpos, body)
    body = w_sel(under | ~w_nonzero(body), ones, body)

    out = w_sel(sign.bool(), w_neg(body), body)
    out = w_sel(is_zero.bool(), zero2, out)
    return w_sel(is_nar.bool(), w_const(fmt.nar_pattern, 2, like), out)


# =====================================================================
# float32 <-> posit64 (reference core/wide.py :176 / :197)
# =====================================================================


def float_to_posit_wide(fmt: PositFormat, x):
    """float32 -> posit64 patterns ``(lo, hi)``: exact for every finite
    f32 but deep in the regime tails, where the value-nearest rounding of
    :func:`encode_wide` applies; subnormals are nonzero reals."""
    _check(fmt)
    F = fmt.F
    sign, scale, ti, is_zero, is_nar = float_decompose(x)
    frac = w_shl((ti & ((1 << 24) - 1), torch.zeros_like(ti)), F - 24)
    zero = torch.zeros_like(ti)
    return encode_wide(fmt, sign, scale, frac, zero, zero.bool(), is_zero, is_nar)


def posit_wide_to_float(fmt: PositFormat, p):
    """posit64 patterns -> float32, the significand rounded to 24 bits by
    its guard, round and sticky bits (NaR -> NaN).

    A value below the f32 normal range comes out as a signed zero: the
    reference's backends (XLA on the CPU and the TPU) flush the subnormal
    results of its ``ldexp_f32``, so the port flushes them explicitly (the
    kernels are built without ``-ftz``, and the casts of every n <= 32 never
    reach that range)."""
    F = fmt.F
    sign, scale, sig, is_zero, is_nar = decode_wide(fmt, p)
    sh = F + 1 - 24                       # discarded low bits of the significand
    m24 = w_shr(sig, sh)[0]
    guard = w_bit(sig, sh - 1)
    sticky = w_low_nonzero(sig, sh - 1).long()
    m24 = m24 + (guard & (sticky | (m24 & 1)))
    val = ldexp_f32(m24.to(torch.float32), scale - 23)
    val = torch.where(val < F32_MIN_NORMAL, torch.zeros_like(val), val)
    val = torch.where(sign, -val, val)
    val = torch.where(is_zero, torch.zeros_like(val), val)
    return torch.where(is_nar, torch.full_like(val, float("nan")), val)


def to_words(values, like=None):
    """Python ints (or an int/uint64 numpy array) -> posit64 word pair."""
    import numpy as np

    v = np.asarray(values, dtype=object).astype(np.uint64)
    lo = torch.from_numpy((v & np.uint64(M32)).astype(np.int64))
    hi = torch.from_numpy((v >> np.uint64(32)).astype(np.int64))
    if like is not None:
        lo, hi = lo.to(like.device), hi.to(like.device)
    return lo, hi


def from_words(p):
    """posit64 word pair -> a uint64 numpy array (on the host)."""
    import numpy as np

    lo = p[0].cpu().numpy().astype(np.uint64)
    hi = p[1].cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo
