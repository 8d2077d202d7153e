"""Bit-exact Posit<n,es> codec in PyTorch (the CPU twin of the kernels' codec).

Mirrors the reference package's ``core/posit.py``: 2022 Posit Standard
encoding (es = 2, kept parametric), two's-complement negatives, one NaR,
round-to-nearest-even on the integer body with saturation to minpos/maxpos.

Patterns and 32-bit datapath words live in **int64 lanes holding the
unsigned 32-bit value** (``0 <= x < 2**32``): PyTorch has no logical right
shift for ``uint32`` on the CPU, and int64 gives every shift, add and
compare a defined result on both the CPU and the card.  Every result is
masked back to 32 bits, so the bits equal the reference's uint32 ones.

Two subnormal-safe choices of the reference are kept: f32 inputs are
classified by their integer bit fields (never by float compares), and
``2**e`` is built from two normal factors (:func:`ldexp_f32`).
"""

from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PositFormat:
    """Posit<n, es> format descriptor (standard posits have es=2)."""

    n: int
    es: int = 2

    def __post_init__(self):
        if not (3 <= self.n <= 32 or self.n == 64) or not 0 <= self.es <= 4:
            raise ValueError(f"unsupported posit format n={self.n} es={self.es}")

    @property
    def F(self) -> int:
        """Maximum number of fraction bits (n - 3 - es; n-5 for es=2)."""
        return self.n - 3 - self.es

    @property
    def mask(self) -> int:
        return (1 << self.n) - 1

    @property
    def nar_pattern(self) -> int:
        return 1 << (self.n - 1)

    @property
    def maxpos_body(self) -> int:
        return (1 << (self.n - 1)) - 1

    @property
    def max_scale(self) -> int:
        """Scale of maxpos: (n-2) * 2**es."""
        return (self.n - 2) << self.es

    def __str__(self):
        return f"Posit{self.n}" if self.es == 2 else f"Posit<{self.n},{self.es}>"


POSIT8 = PositFormat(8)
POSIT16 = PositFormat(16)
POSIT32 = PositFormat(32)
POSIT64 = PositFormat(64)


# =====================================================================
# 32-bit word helpers on int64 lanes
# =====================================================================


def clz32(x):
    """Count leading zeros of 32-bit words (clz(0) == 32), branch-free."""
    n = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        z = (y >> (32 - s)) == 0
        n = n + z.long() * s
        y = torch.where(z, (y << s) & M32, y)
    return n + ((y >> 31) == 0).long()


def _safe_shl(x, s):
    """``x << s`` on 32-bit words; a shift outside [0, 32) gives 0."""
    s = torch.as_tensor(s, device=x.device)
    big = (s >= 32) | (s < 0)
    return torch.where(big, torch.zeros_like(x),
                       (x << torch.where(big, 0, s)) & M32)


def _safe_shr(x, s):
    """Logical ``x >> s`` on 32-bit words; a shift outside [0, 32) gives 0."""
    s = torch.as_tensor(s, device=x.device)
    big = (s >= 32) | (s < 0)
    return torch.where(big, torch.zeros_like(x), x >> torch.where(big, 0, s))


def _pow2_f32(e):
    """Exact 2^e for integer e in [-126, 127], built from exponent bits."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def ldexp_f32(m, e):
    """``m * 2^e`` in float32 via two exact power-of-two factors.

    A single ``2^e`` factor is subnormal for e < -126 and is flushed on
    flush-to-zero backends; two in-range factors keep every intermediate
    normal whenever the result is.
    """
    e = torch.clamp(e.long(), -252, 254)
    e1 = e >> 1            # arithmetic shift == floor(e / 2)
    return m.to(torch.float32) * _pow2_f32(e1) * _pow2_f32(e - e1)


# =====================================================================
# decode
# =====================================================================


@dataclasses.dataclass
class PositFields:
    """Decoded posit: value = (-1)^sign * 2^scale * sig / 2^F."""

    sign: torch.Tensor      # bool
    scale: torch.Tensor     # int64, T = (k << es) + e
    sig: torch.Tensor       # int64, (1 << F) | frac
    is_zero: torch.Tensor   # bool
    is_nar: torch.Tensor    # bool


def posit_decode(fmt: PositFormat, p) -> PositFields:
    """Decode n-bit posit patterns (int64 lanes, n <= 32)."""
    n, es, F = fmt.n, fmt.es, fmt.F
    p = p.long() & fmt.mask
    is_zero = p == 0
    is_nar = p == fmt.nar_pattern
    sign = ((p >> (n - 1)) & 1).bool()
    mag = torch.where(sign, ((p ^ M32) + 1) & fmt.mask, p)

    body = (mag << (32 - (n - 1))) & M32          # body left-aligned at bit 31
    r0 = ((body >> 31) & 1).bool()
    inv = torch.where(r0, body ^ M32, body)
    run = torch.clamp(clz32(inv), max=n - 1)      # regime may run to the end
    k = torch.where(r0, run - 1, -run)

    tail = _safe_shl(body, run + 1)               # bits past the terminator
    e = (tail >> (32 - es)) if es > 0 else torch.zeros_like(run)
    frac_tail = ((tail << es) & M32) if es > 0 else tail
    frac = (frac_tail >> (32 - F)) if F > 0 else torch.zeros_like(p)

    scale = k * (1 << es) + e
    sig = ((1 << F) | frac) if F > 0 else torch.ones_like(p)
    return PositFields(sign=sign, scale=scale, sig=sig, is_zero=is_zero,
                       is_nar=is_nar)


# =====================================================================
# encode
# =====================================================================


def posit_encode(fmt: PositFormat, sign, scale, frac, round_bit, sticky,
                 is_zero, is_nar):
    """Assemble + RNE-round a posit from sign/scale/fraction and G/R/S bits.

    ``frac`` is the F-bit fraction of a significand in [1, 2);
    ``round_bit``/``sticky`` describe the discarded tail.  Saturates to
    maxpos/minpos (rounding never gives 0 or NaR from a nonzero real).
    """
    n, es, F = fmt.n, fmt.es, fmt.F
    scale = scale.long()
    frac = frac.long()
    round_bit = round_bit.long() & 1
    sticky = sticky.bool()

    k = scale >> es
    e = (scale & ((1 << es) - 1)) if es > 0 else torch.zeros_like(frac)

    over = k > (n - 2)
    under = k < -(n - 2)
    kc = torch.clamp(k, -(n - 2), n - 2)

    pos = kc >= 0
    l = torch.where(pos, kc + 1, -kc)
    rlen = l + 1
    # regime pattern, width rlen: l ones then 0  /  l zeros then 1
    one = torch.ones_like(frac)
    rpat = torch.where(pos, (_safe_shl(one, l + 1) - 2) & M32, one)

    eg = (e << F) | frac                       # exponent || fraction
    egw = F + es

    m = (n - 1) - rlen                         # bits left for eg; may be -1
    m_pos = torch.clamp(m, min=0)
    discard = egw - m_pos

    kept = _safe_shr(eg, discard)
    g_from_eg = _safe_shr(eg, torch.clamp(discard - 1, min=0)) & 1
    guard = torch.where(discard > 0, g_from_eg, round_bit)
    below_mask = (_safe_shl(one, torch.clamp(discard - 1, min=0)) - 1) & M32
    st_eg = (eg & below_mask) != 0
    sticky_full = torch.where(discard > 0, st_eg | (round_bit != 0) | sticky,
                              sticky)

    trunc_regime = m < 0
    body_base = torch.where(trunc_regime, rpat >> 1,
                            _safe_shl(rpat, m_pos) | kept)

    lsb = body_base & 1
    inc_linear = guard & (sticky_full.long() | lsb)

    # Deep-regime (non-linear) rounding when exponent bits are cut: adjacent
    # posits differ by 2^(2^c) and nearest is judged on real values.
    if es == 2 and F >= 2:
        c = discard - F
        f_ext = (frac << 2) | (round_bit << 1) | sticky.long()
        e_disc1 = (e & 1) == 1
        e_disc2 = (e & 3) == 3
        thr = torch.where(c == 1, 1 << F, 1 << (F - 2))
        e_cond = torch.where(c == 1, e_disc1, e_disc2)
        deep_up = e_cond & ((f_ext > thr) | ((f_ext == thr) & (lsb == 1)))
        deep = (c >= 1) & (m >= 0)
        inc = torch.where(deep, deep_up.long(), inc_linear)
    else:
        inc = inc_linear
    inc = torch.where(trunc_regime, torch.zeros_like(inc), inc)
    body = (body_base + inc) & M32

    body = torch.where(over, torch.full_like(body, fmt.maxpos_body), body)
    body = torch.where(under, torch.ones_like(body), body)
    body = torch.clamp(body, 1, fmt.maxpos_body)

    p = torch.where(sign.bool(), ((body ^ M32) + 1) & fmt.mask, body)
    p = torch.where(is_zero.bool(), torch.zeros_like(p), p)
    p = torch.where(is_nar.bool(), torch.full_like(p, fmt.nar_pattern), p)
    return p


# =====================================================================
# float <-> posit casts
# =====================================================================


def posit_to_float(fmt: PositFormat, p):
    """Posit bits -> float32. Exact for n <= 16; Posit32 rounds to f32."""
    d = posit_decode(fmt, p)
    sigf = ldexp_f32(d.sig.to(torch.float32), d.scale - fmt.F)
    val = torch.where(d.sign, -sigf, sigf)
    val = torch.where(d.is_zero, torch.zeros_like(val), val)
    return torch.where(d.is_nar, torch.full_like(val, float("nan")), val)


def float_decompose(x):
    """Exact integer decomposition of float32: (sign, scale, ti, zero, nar).

    ``ti`` is the 25-bit significand with the hidden bit at bit 24, so the
    value is ``ti * 2^(scale - 24)``.  Classification runs on the bit
    fields; subnormals decompose exactly; NaN and Inf both map to NaR.
    """
    bits = x.to(torch.float32).contiguous().view(torch.int32).long() & M32
    exp_f = (bits >> 23) & 0xFF
    mant_f = bits & 0x7FFFFF
    is_sub = exp_f == 0
    is_zero = is_sub & (mant_f == 0)
    is_nar = exp_f == 255
    sign = ((bits >> 31) == 1) & ~is_zero
    blen = 32 - clz32(mant_f)
    scale = torch.where(is_sub, blen - 150, exp_f - 127)
    ti = torch.where(is_sub, (mant_f << (25 - blen)) & M32,
                     ((1 << 23) | mant_f) << 1)
    return sign, scale, ti, is_zero, is_nar


def float_to_posit(fmt: PositFormat, x):
    """float32 -> posit bits (int64 lanes) with correct RNE."""
    F = fmt.F
    sign, scale, ti, is_zero, is_nar = float_decompose(x)
    keep = F + 1                  # hidden bit + F fraction bits
    drop = 25 - keep
    if drop >= 1:
        frac = (ti >> drop) & ((1 << F) - 1)
        round_bit = (ti >> (drop - 1)) & 1
        sticky = (ti & ((1 << (drop - 1)) - 1)) != 0
    else:                         # F >= 24 (posit32 from f32): nothing cut
        frac = (ti << (keep - 25)) & ((1 << F) - 1)
        round_bit = torch.zeros_like(ti)
        sticky = torch.zeros_like(ti, dtype=torch.bool)
    return posit_encode(fmt, sign, scale, frac, round_bit, sticky, is_zero,
                        is_nar)
