"""SRT digit-recurrence datapath: plan table and the plain PyTorch twin.

Port of the reference package's ``kernels/posit_div.py`` plan
(``DatapathPlan``, ``kernel_datapath_plan``, ``kernel_plan_error``,
``planned_pairs``) and of its datapath body (``_divide_fields``,
``_divide_block``, ``divide_floats_block``) for every **one-word** plan:
all nine Table IV rows on posit8/16 and the eight unscaled rows on posit32.
The same arithmetic runs on the card as ``csrc/posit_srt.cuh`` (K1); this
twin runs on any device, on int64 lanes holding unsigned 32-bit words (see
:mod:`repro_torch.core.posit`), and gives the reference's bits.

Two-word plans (posit32 with ``srt_r4_scaled``, posit64) keep their plan
here but their datapath is not ported yet: :func:`divide_floats_block`
raises ``NotImplementedError`` for them (``ROADMAP.md`` lists the work).
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
    """The ``(fmt, variant, plan)`` triples this port's datapath runs."""
    return [t for t in planned_pairs(formats) if t[2].words == 1]


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


def one_word_plan(fmt: PositFormat, variant: str) -> DatapathPlan:
    """The plan for (fmt, variant), raising unless the port runs it."""
    err = kernel_plan_error(fmt, variant)
    if err is not None:
        raise ValueError(f"no fused datapath: {err}")
    plan = kernel_datapath_plan(fmt, variant)
    if plan.words != 1:
        raise NotImplementedError(
            f"{fmt} / {variant!r} needs the {plan.words}-word datapath, which "
            "the port does not have yet (ROADMAP.md: two-word / posit64)")
    return plan


# =====================================================================
# one-word helpers (int64 lanes holding unsigned 32-bit words)
# =====================================================================


def _shl(x, k: int):
    return (x << k) & M32 if k < 32 else torch.zeros_like(x)


def _lsr(x, k: int):
    return x >> k if k < 32 else torch.zeros_like(x)


def _signed(x):
    """The int32 value of a 32-bit word."""
    return x - ((x >> 31) << 32)


def _add(a, b, cin=None):
    s = a + b
    if cin is not None:
        s = s + cin
    return s & M32


def _lut8(table, idx):
    return torch.tensor(table, dtype=torch.int64, device=idx.device)[idx]


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
    """Exact M*v (Table I): v + (v >> s1) + (v >> s2)."""
    c1, c2, c3 = v >> 1, v >> 2, v >> 3
    s1 = _lut8(_SCALE_S1, didx)
    s2 = _lut8(_SCALE_S2, didx)
    t1 = torch.where(s1 == 1, c1, torch.where(s1 == 2, c2, c3))
    t2 = torch.where(s2 == 1, c1, torch.where(s2 == 3, c3, torch.zeros_like(c3)))
    return _add(_add(v, t1), t2)


def _otf(Q, QD, digit, r: int):
    """On-the-fly conversion step (Eqs 18-19), radix r in {2, 4}."""
    lr = 1 if r == 2 else 2
    neg, pos, mag = digit < 0, digit > 0, digit.abs()
    Qs, QDs = _shl(Q, lr), _shl(QD, lr)
    q_app = torch.where(neg, r - mag, mag)
    qd_app = torch.where(pos, mag - 1, (r - 1) - mag)
    return (torch.where(neg, QDs, Qs) | q_app,
            torch.where(pos, Qs, QDs) | qd_app)


def _plain_q(Q, digit, r: int):
    """Non-OTF accumulation q <- r*q + digit (digit may be negative)."""
    lr = 1 if r == 2 else 2
    mag = digit.abs()
    neg = digit < 0
    return _add(_shl(Q, lr), torch.where(neg, mag ^ M32, mag), neg.long())


# =====================================================================
# the recurrence on decoded significands
# =====================================================================


def _divide_fields(plan: DatapathPlan, xsig, dsig):
    """One-word digit recurrence on FRAC-bit significands.

    ``dsig`` may broadcast against ``xsig`` (a per-row divisor); every
    divisor-side quantity is then computed once per row.  Returns
    ``(frac, t_adj, round_bit, sticky)`` as the reference does.
    """
    if plan.words != 1:
        raise NotImplementedError("two-word datapath (ROADMAP.md)")
    r = plan.radix
    lr = 1 if r == 2 else 2
    FRAC, It, FP = plan.frac, plan.iterations, plan.fp
    F = FRAC - 1

    x_al = _shl(xsig, plan.shift)
    d_al = _shl(dsig, plan.shift)
    if FRAC >= 4:
        didx = _lsr(dsig, FRAC - 4) & 7
    else:
        didx = (dsig << (4 - FRAC)) & 7
    if plan.scaled:
        x_al = _scale_operand(x_al, didx)
        d_al = _scale_operand(d_al, didx)
    nd_al = d_al ^ M32
    d2 = _shl(d_al, 1) if r == 4 else None
    nd2 = d2 ^ M32 if r == 4 else None

    def addend_for(digit):
        zero = torch.zeros_like(digit)
        a = torch.where(digit == 1, nd_al, torch.where(digit == -1, d_al, zero))
        if r == 4:
            a = torch.where(digit == 2, nd2, torch.where(digit == -2, d2, a))
        return a, (digit > 0).long()

    # Iteration 1 folded: y_1 = r*w(0) = x exactly (w(0) = x/r).
    ztop = torch.zeros_like(x_al)
    digit = _select(plan, x_al, ztop, didx)
    add, cin = addend_for(digit)
    if plan.redundant:
        wc = _shl(x_al & add, 1) | cin
        ws = x_al ^ add
    else:
        ws = _add(x_al, add, cin)
        wc = torch.zeros_like(ws)
    qz = torch.zeros_like(digit)
    if plan.otf:
        Q, QD = _otf(qz, qz, digit, r)
    else:
        Q, QD = _plain_q(qz, digit, r), qz

    for _ in range(It - 1):
        rws = _shl(ws, lr)
        if plan.redundant:
            rwc = _shl(wc, lr)
            digit = _select(plan, rws, rwc, didx)
            add, cin = addend_for(digit)
            ws = rws ^ rwc ^ add
            wc = _shl((rws & rwc) | (rws & add) | (rwc & add), 1) | cin
        else:
            digit = _select(plan, rws, ztop, didx)
            add, cin = addend_for(digit)
            ws = _add(rws, add, cin)
        if plan.otf:
            Q, QD = _otf(Q, QD, digit, r)
        else:
            Q = _plain_q(Q, digit, r)

    # Termination: sign/zero of the final residual.
    wfull = _add(ws, wc) if plan.redundant else ws
    neg = _signed(wfull) < 0
    if not plan.otf:
        QD = _add(Q, torch.full_like(Q, M32))
    qf = torch.where(neg, QD, Q)
    rem = torch.where(neg, _add(wfull, d_al), wfull)
    rem_nz = rem != 0

    intbit = (_lsr(qf, FP) & 1).bool()
    qn = torch.where(intbit, qf, _shl(qf, 1))
    t_adj = torch.where(intbit, 0, -1)
    frac = _lsr(qn, FP - F) & ((1 << F) - 1)
    round_bit = _lsr(qn, FP - F - 1) & 1
    low = FP - F - 1
    low_nz = ((qn & ((1 << low) - 1)) != 0) if low > 0 else torch.zeros_like(rem_nz)
    return frac, t_adj, round_bit, low_nz | rem_nz


# =====================================================================
# block-level dividers
# =====================================================================


def _divide_block(fmt: PositFormat, px, pd, variant: str = DEFAULT_KERNEL_VARIANT):
    """The datapath on posit bit patterns (int64 lanes, n <= 32).

    ``pd`` may broadcast against ``px`` (a ``(rows, 1)`` divisor column).
    """
    plan = one_word_plan(fmt, variant)
    dx = posit_decode(fmt, px)
    dd = posit_decode(fmt, pd)
    frac, t_adj, round_bit, sticky = _divide_fields(plan, dx.sig, dd.sig)
    sign = dx.sign ^ dd.sign
    scale = dx.scale - dd.scale + t_adj
    out_nar = dx.is_nar | dd.is_nar | dd.is_zero
    out_zero = dx.is_zero & ~out_nar
    return posit_encode(fmt, sign, scale, frac, round_bit, sticky, out_zero,
                        out_nar)


def divide_floats_block(fmt: PositFormat, a, b,
                        variant: str = DEFAULT_KERNEL_VARIANT):
    """Quantize -> SRT divide -> dequantize on float32 tensors (any device).

    ``b`` may broadcast against ``a``.  Bit-identical to the reference's
    ``divide_floats_block`` for every one-word plan.
    """
    one_word_plan(fmt, variant)
    pa = float_to_posit(fmt, a)
    pb = float_to_posit(fmt, b)
    return posit_to_float(fmt, _divide_block(fmt, pa, pb, variant))
