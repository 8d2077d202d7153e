"""SRT digit-recurrence datapath: plan table and the plain PyTorch twin.

Port of the reference package's ``kernels/posit_div.py`` plan
(``DatapathPlan``, ``kernel_datapath_plan``, ``kernel_plan_error``,
``planned_pairs``) and of its datapath body (``_divide_fields``,
``_divide_block``, ``_divide_floats_wide``, ``divide_floats_block``) for
every planned (format, variant): the one-word plans (all nine Table IV rows
on posit8/16, the eight unscaled ones on posit32) and the two-word ones
(posit32 ``srt_r4_scaled``, the eight unscaled posit64 rows).  The same
arithmetic runs on the card as ``csrc/posit_srt.cuh`` (K1); this twin runs
on any device, its W-word registers tuples of unsigned 32-bit words in
int64 lanes (:mod:`repro_torch.core.wide`), and gives the reference's bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import seltables
from repro_torch.core.divider import VARIANTS as _TABLE4
from repro_torch.core.posit import (
    M32,
    POSIT8,
    POSIT16,
    POSIT32,
    POSIT64,
    PositFormat,
    float_to_posit,
    posit_decode,
    posit_encode,
    posit_to_float,
)
from repro_torch.core.wide import (
    decode_wide,
    encode_wide,
    float_to_posit_wide,
    posit_wide_to_float,
    w_add,
    w_bit,
    w_low_nonzero,
    w_mask,
    w_nonzero,
    w_not,
    w_sel,
    w_shl,
    w_shr,
)

_IB = 3         # residual integer bits (incl. sign) at the top of the frame
_WPOINT = 29    # fraction bits held by the top residual word (32 - _IB)
_MAX_WORDS = 2  # widest residual frame the plan admits

KERNEL_VARIANTS = tuple(_TABLE4)
DEFAULT_KERNEL_VARIANT = "srt_r4_cs_of_fr"
FORMATS = (POSIT8, POSIT16, POSIT32, POSIT64)


# =====================================================================
# datapath plan (pure Python; identical to the reference's table)
# =====================================================================


@dataclasses.dataclass(frozen=True)
class DatapathPlan:
    """Static lowering plan for one (format, variant) divider instance."""

    variant: str
    n: int
    words: int          # W: residual words (per carry-save register)
    radix: int
    redundant: bool     # carry-save residual pair (vs full two's-comp add)
    otf: bool           # on-the-fly conversion (vs plain accumulate + Q-1)
    nonrestoring: bool  # Algorithm 1: digit set {-1, 1}, sign-only select
    scaled: bool        # operand scaling (Table I / Eq 29)
    frac: int           # FRAC = F + 1 operand fraction bits
    shift: int          # left-align shift of the significand into the frame
    iterations: int     # after folding the first iteration into init
    fp: int             # quotient fraction bits
    qwords: int         # words per quotient register
    gbits: int          # estimate fraction bits (estimate is _IB + gbits)


@functools.lru_cache(maxsize=None)
def kernel_datapath_plan(fmt: PositFormat, variant: str) -> Optional[DatapathPlan]:
    """The W-word datapath plan for (fmt, variant), or None if unplannable.

    The narrowest W in {1, 2} whose ``32*W - 3`` fraction bits hold the
    operand fraction plus its shift headroom (3 bits for the scaled
    variant's Table I multiples, else 1) is chosen.
    """
    cfg = _TABLE4.get(variant)
    if cfg is None:
        return None
    frac = fmt.F + 1
    margin = 3 if cfg.scaling else 1
    words = next((w for w in range(1, _MAX_WORDS + 1)
                  if frac + margin <= 32 * w - _IB), None)
    if words is None:
        return None
    lr = cfg.log2r
    it = -(-(fmt.n - 1) // lr)  # Eq 31 with h = n - 1 quotient bits
    fp = it * lr - lr           # first iteration folded
    if cfg.radix == 2 or not cfg.redundant_residual:
        gbits = 1
    elif cfg.scaling:
        gbits = seltables.SCALED_G_FRAC
    else:
        gbits = seltables.G_FRAC
    return DatapathPlan(
        variant=variant, n=fmt.n, words=words, radix=cfg.radix,
        redundant=cfg.redundant_residual, otf=cfg.otf,
        nonrestoring=cfg.nonrestoring, scaled=cfg.scaling, frac=frac,
        shift=32 * words - _IB - frac, iterations=it, fp=fp,
        qwords=-(-(fp + 2) // 32), gbits=gbits)


def planned_pairs(formats=FORMATS):
    """Every ``(fmt, variant, plan)`` the datapath plan accepts."""
    for fmt in formats:
        for variant in KERNEL_VARIANTS:
            plan = kernel_datapath_plan(fmt, variant)
            if plan is not None:
                yield fmt, variant, plan


def one_word_pairs(formats=FORMATS):
    """The ``(fmt, variant, plan)`` triples with a one-word plan (W = 1)."""
    return [t for t in planned_pairs(formats) if t[2].words == 1]


def two_word_pairs(formats=FORMATS):
    """The ``(fmt, variant, plan)`` triples with a two-word plan (W = 2):
    posit32 ``srt_r4_scaled`` and the eight unscaled posit64 rows."""
    return [t for t in planned_pairs(formats) if t[2].words == 2]


def kernel_plan_error(fmt: PositFormat, variant: str) -> Optional[str]:
    """None if (fmt, variant) has a datapath plan, else the derived reason."""
    if variant not in _TABLE4:
        return (f"unknown divider variant {variant!r}; Table IV rows: "
                f"{KERNEL_VARIANTS}")
    if kernel_datapath_plan(fmt, variant) is not None:
        return None
    cfg = _TABLE4[variant]
    margin = 3 if cfg.scaling else 1
    max_n = (32 * _MAX_WORDS - _IB - margin) + 2 + fmt.es  # FRAC = n - 2 - es
    return (f"{fmt} / {variant!r} needs {fmt.F + 1 + margin} residual "
            f"fraction bits but the widest ({_MAX_WORDS}-word) frame holds "
            f"{32 * _MAX_WORDS - _IB}; {variant!r} supports n <= {max_n}"
            + (" (operand scaling carries 3 extra fraction bits)"
               if cfg.scaling else ""))


def datapath_plan(fmt: PositFormat, variant: str) -> DatapathPlan:
    """The plan for (fmt, variant), raising where the reference's
    ``kernel_plan_error`` names no datapath."""
    err = kernel_plan_error(fmt, variant)
    if err is not None:
        raise ValueError(f"no fused datapath: {err}")
    return kernel_datapath_plan(fmt, variant)


# =====================================================================
# quotient-digit selection (Section III-D): top residual word only
# =====================================================================


def _lut8(table, idx):
    return torch.tensor(table, dtype=torch.int64, device=idx.device)[idx]


def _signed(x):
    """The int32 value of a 32-bit word."""
    return x - ((x >> 31) << 32)


def _cs_est(rws, rwc, gbits: int):
    """Truncated estimate from the top words: 3 int + ``gbits`` frac bits."""
    tb = _IB + gbits
    sh = _WPOINT - gbits
    t = ((rws >> sh) + (rwc >> sh)) & ((1 << tb) - 1)
    return t - ((t >> (tb - 1)) << tb)            # sign-extend tb bits


def _select(plan: DatapathPlan, rws, rwc, didx):
    one = torch.ones_like(rws)
    if plan.nonrestoring:
        return torch.where(_signed(rws) < 0, -one, one)
    est = _cs_est(rws, rwc, plan.gbits)
    if not plan.redundant:
        return torch.where(est >= seltables.R2_EXACT_M1, one,
                           torch.where(est >= seltables.R2_EXACT_M0, 0 * one,
                                       -one))
    if plan.radix == 2:
        return torch.where(est >= seltables.R2_CS_M1, one,
                           torch.where(est == seltables.R2_CS_M0, 0 * one,
                                       -one))
    if plan.scaled:
        m2, m1 = seltables.SCALED_M2, seltables.SCALED_M1
        m0, mm1 = seltables.SCALED_M0, seltables.SCALED_MM1
    else:
        m2 = _lut8(seltables.RADIX4_M2, didx)
        m1 = _lut8(seltables.RADIX4_M1, didx)
        m0 = _lut8(seltables.RADIX4_M0, didx)
        mm1 = _lut8(seltables.RADIX4_MM1, didx)
    return torch.where(est >= m2, 2 * one,
                       torch.where(est >= m1, one,
                                   torch.where(est >= m0, 0 * one,
                                               torch.where(est >= mm1, -one,
                                                           -2 * one))))


_SCALE_S1 = tuple(s[0] for s in seltables.SCALING_SHIFTS)
_SCALE_S2 = tuple(0 if s[1] is None else s[1] for s in seltables.SCALING_SHIFTS)


def _scale_operand(v, didx):
    """Exact W-word M*v (Table I): v + (v >> s1) + (v >> s2)."""
    c1, c2, c3 = w_shr(v, 1), w_shr(v, 2), w_shr(v, 3)
    s1 = _lut8(_SCALE_S1, didx)
    s2 = _lut8(_SCALE_S2, didx)
    zero = tuple(torch.zeros_like(x) for x in c3)
    t1 = w_sel(s1 == 1, c1, w_sel(s1 == 2, c2, c3))
    t2 = w_sel(s2 == 1, c1, w_sel(s2 == 3, c3, zero))
    return w_add(w_add(v, t1), t2)


# =====================================================================
# quotient registers (on-the-fly conversion or plain accumulation)
# =====================================================================


def _otf(Q, QD, digit, r: int):
    """On-the-fly conversion step (Eqs 18-19), radix r in {2, 4}."""
    lr = 1 if r == 2 else 2
    neg, pos, mag = digit < 0, digit > 0, digit.abs()
    Qs, QDs = w_shl(Q, lr), w_shl(QD, lr)
    q_app = torch.where(neg, r - mag, mag)
    qd_app = torch.where(pos, mag - 1, (r - 1) - mag)
    Qn, QDn = w_sel(neg, QDs, Qs), w_sel(pos, Qs, QDs)
    return (Qn[0] | q_app,) + Qn[1:], (QDn[0] | qd_app,) + QDn[1:]


def _plain_q(Q, digit, r: int):
    """Non-OTF accumulation q <- r*q + digit (digit may be negative)."""
    lr = 1 if r == 2 else 2
    mag = digit.abs()
    magw = (mag,) + tuple(torch.zeros_like(mag) for _ in Q[1:])
    neg = digit < 0
    return w_add(w_shl(Q, lr), w_sel(neg, w_not(magw), magw), neg.long())


# =====================================================================
# the recurrence on decoded significands
# =====================================================================


def _divide_fields(plan: DatapathPlan, xsig, dsig):
    """The W-word digit recurrence on FRAC-bit significand word tuples.

    ``xsig``/``dsig`` are little-endian tuples of 32-bit words (int64
    lanes) holding significands in [2^(FRAC-1), 2^FRAC); ``dsig`` may
    broadcast against ``xsig`` (a per-row divisor), and every divisor-side
    quantity is then computed once per row.  Carries cross words only in
    the shifts and the full adds; selection reads the top word.  Returns
    ``(frac_words, t_adj, round_bit, sticky)`` as the reference does.
    """
    W, r = plan.words, plan.radix
    lr = 1 if r == 2 else 2
    FRAC, It, FP = plan.frac, plan.iterations, plan.fp
    F = FRAC - 1

    def extend(sig):
        return tuple(sig) + tuple(torch.zeros_like(sig[0]) for _ in range(W - len(sig)))

    x_al = w_shl(extend(xsig), plan.shift)
    d_al = w_shl(extend(dsig), plan.shift)
    if FRAC >= 4:
        didx = w_shr(tuple(dsig), FRAC - 4)[0] & 7
    else:
        didx = (dsig[0] << (4 - FRAC)) & 7
    if plan.scaled:
        # Both operands times the same M (Table I): the quotient is
        # unchanged and selection becomes divisor-independent; exact, as
        # the shift leaves >= 3 zero bits at the bottom.
        x_al = _scale_operand(x_al, didx)
        d_al = _scale_operand(d_al, didx)
    nd_al = w_not(d_al)
    d2 = w_shl(d_al, 1) if r == 4 else None
    nd2 = w_not(d2) if r == 4 else None

    def addend_for(digit):
        zero = torch.zeros_like(digit)
        add = []
        for i in range(W):
            a = torch.where(digit == 1, nd_al[i], torch.where(digit == -1, d_al[i], zero))
            if r == 4:
                a = torch.where(digit == 2, nd2[i], torch.where(digit == -2, d2[i], a))
            add.append(a)
        return tuple(add), (digit > 0).long()

    # Iteration 1 folded: y_1 = r*w(0) = x exactly (w(0) = x/r).
    ztop = torch.zeros_like(x_al[-1])
    digit = _select(plan, x_al[-1], ztop, didx)
    add, cin = addend_for(digit)
    if plan.redundant:
        wc = w_shl(tuple(x & a for x, a in zip(x_al, add)), 1)
        wc = (wc[0] | cin,) + wc[1:]
        ws = tuple(x ^ a for x, a in zip(x_al, add))
    else:
        ws = w_add(x_al, add, cin)
        wc = None
    qz = tuple(torch.zeros_like(digit) for _ in range(plan.qwords))
    if plan.otf:
        Q, QD = _otf(qz, qz, digit, r)
    else:
        Q, QD = _plain_q(qz, digit, r), qz

    for _ in range(It - 1):
        rws = w_shl(ws, lr)
        if plan.redundant:
            rwc = w_shl(wc, lr)
            digit = _select(plan, rws[-1], rwc[-1], didx)
            add, cin = addend_for(digit)
            ws = tuple(x ^ y ^ z for x, y, z in zip(rws, rwc, add))
            maj = tuple((x & y) | (x & z) | (y & z) for x, y, z in zip(rws, rwc, add))
            wc = w_shl(maj, 1)
            wc = (wc[0] | cin,) + wc[1:]
        else:
            digit = _select(plan, rws[-1], ztop, didx)
            add, cin = addend_for(digit)
            ws = w_add(rws, add, cin)
        if plan.otf:
            Q, QD = _otf(Q, QD, digit, r)
        else:
            Q = _plain_q(Q, digit, r)

    # Termination: sign/zero of the final residual.
    wfull = w_add(ws, wc) if plan.redundant else ws
    neg = (wfull[-1] >> 31) == 1
    if not plan.otf:
        QD = w_add(Q, tuple(torch.full_like(x, M32) for x in Q))
    qf = w_sel(neg, QD, Q)
    rem_nz = w_nonzero(w_sel(neg, w_add(wfull, d_al), wfull))

    # q = qf * 2^-FP in (1/2, 2); normalize and extract F + G/R/S bits.
    intbit = w_bit(qf, FP).bool()
    qn = w_sel(intbit, qf, w_shl(qf, 1))
    t_adj = torch.where(intbit, 0, -1)
    frac = w_mask(w_shr(qn, FP - F), F)
    round_bit = w_bit(qn, FP - F - 1)
    sticky = w_low_nonzero(qn, FP - F - 1) | rem_nz
    return frac, t_adj, round_bit, sticky


# =====================================================================
# block-level dividers
# =====================================================================


def _divide_block(fmt: PositFormat, px, pd, variant: str = DEFAULT_KERNEL_VARIANT):
    """The datapath on posit bit patterns (int64 lanes, n <= 32), for every
    planned variant: one-word, and posit31/32 ``srt_r4_scaled``'s two-word
    residual.  ``pd`` may broadcast against ``px`` (a ``(rows, 1)`` column).
    """
    plan = datapath_plan(fmt, variant)
    if fmt.n > 32:
        raise ValueError(f"{fmt} patterns do not fit one word; divide_floats_block "
                         "takes the wide formats")
    dx = posit_decode(fmt, px)
    dd = posit_decode(fmt, pd)
    frac, t_adj, round_bit, sticky = _divide_fields(plan, (dx.sig,), (dd.sig,))
    sign = dx.sign ^ dd.sign
    scale = dx.scale - dd.scale + t_adj
    out_nar = dx.is_nar | dd.is_nar | dd.is_zero
    out_zero = dx.is_zero & ~out_nar
    return posit_encode(fmt, sign, scale, frac[0], round_bit, sticky, out_zero,
                        out_nar)


def _divide_floats_wide(fmt: PositFormat, a, b, variant: str):
    """Fused float32 division for posit64: quantize to word pairs, the
    two-word recurrence, posit64 rounding, float32 dequantize."""
    plan = datapath_plan(fmt, variant)
    sx, Tx, sigx, zx, nx = decode_wide(fmt, float_to_posit_wide(fmt, a))
    sd, Td, sigd, zd, nd = decode_wide(fmt, float_to_posit_wide(fmt, b))
    frac, t_adj, round_bit, sticky = _divide_fields(plan, sigx, sigd)
    out_nar = nx | nd | zd
    out_zero = zx & ~out_nar
    q = encode_wide(fmt, sx ^ sd, Tx - Td + t_adj, w_mask(frac, fmt.F), round_bit,
                    sticky, out_zero, out_nar)
    return posit_wide_to_float(fmt, q)


def divide_floats_block(fmt: PositFormat, a, b,
                        variant: str = DEFAULT_KERNEL_VARIANT):
    """Quantize -> SRT divide -> dequantize on float32 tensors (any device).

    ``b`` may broadcast against ``a``.  Bit-identical to the reference's
    ``divide_floats_block`` for every planned (format, variant): the
    one-word pattern path for n <= 32, the word-pair path for posit64.
    """
    datapath_plan(fmt, variant)
    if fmt.n > 32:
        return _divide_floats_wide(fmt, a, b, variant)
    pa = float_to_posit(fmt, a)
    pb = float_to_posit(fmt, b)
    return posit_to_float(fmt, _divide_block(fmt, pa, pb, variant))
