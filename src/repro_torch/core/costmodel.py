"""Analytic hardware cost model for the posit divider variants (Section IV).

We cannot run Synopsys DC in this environment, so the paper's synthesis
evaluation (Figs. 4-9, Table II) is reproduced with a gate-level component
model in technology-neutral units:

  * area   in NAND2 gate equivalents (GE)
  * delay  in FO4 inverter delays
  * power  proportional to switched area (activity factor folded in)
  * energy = power * delay (combinational) or power * cycles * T_clk
    (pipelined, T_clk from the 1.5 GHz target of Section IV)

Component constants follow standard-cell folklore (full adder ~ 6 GE / 2 FO4,
flip-flop ~ 5 GE, 2:1 mux ~ 2 GE); absolute numbers are NOT claimed to match
the 28 nm TSMC library — the deliverable is the *relative* deltas across
Table IV variants, radices and widths, which EXPERIMENTS.md compares against
the percentages the paper reports.

Latency (cycles) reproduces Table II exactly:  It + 3 (+1 with scaling).

A copy of the reference package's ``core/costmodel.py`` (``estimate``,
``table2``, ``PAPER_TABLE2``), on the port's ``core/divider.py``; the
reference's beyond-paper ``radix16_overlap_estimate`` is not copied.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .divider import VARIANTS, DividerConfig
from .posit import PositFormat

# --- component constants (GE / FO4) ------------------------------------
GE_FA = 6.0      # full adder
GE_HA = 3.0
GE_FF = 5.0      # D flip-flop
GE_MUX = 2.0     # 2:1 mux per bit
GE_XOR = 2.0
GE_NAND = 1.0

D_FA = 2.0       # FO4 per full-adder (sum path)
D_MUX = 1.0
D_FF = 2.0       # clk->q + setup
D_GATE = 0.5

FO4_PS = 15.0            # ~28nm FO4 in picoseconds (for ns-style reporting)
TCLK_NS = 1.0 / 1.5      # 1.5 GHz pipeline target (Section IV)


def _cpa(width: int):
    """Carry-lookahead adder: area ~ 1.5*FA/bit, delay ~ log2(width)."""
    return 1.5 * GE_FA * width, D_FA * math.log2(max(width, 2))


def _lzc(width: int):
    """Leading-zero counter: ~2 GE/bit, log depth."""
    return 2.0 * width, D_GATE * 2 * math.log2(max(width, 2))


def _shifter(width: int):
    """Barrel shifter: mux level per log2(width)."""
    lev = math.ceil(math.log2(max(width, 2)))
    return GE_MUX * width * lev, D_MUX * lev


@dataclasses.dataclass
class CostReport:
    variant: str
    fmt: str
    radix: int
    iterations: int
    cycles: int
    area_ge: float
    delay_fo4: float          # combinational critical path
    cycle_fo4: float          # pipelined per-cycle critical path
    power_au: float
    energy_au: float          # combinational energy (power * delay)
    energy_pipe_au: float     # pipelined energy (power * cycles * Tclk)

    @property
    def delay_ns(self):
        return self.delay_fo4 * FO4_PS / 1000.0


def _stage_costs(fmt: PositFormat, cfg: DividerConfig):
    """(area, delay) of one recurrence iteration + per-design extras."""
    F = fmt.F
    frac = F + 1
    W = frac + cfg.p_shift + 3 + (3 if cfg.scaling else 0)  # residual width
    WQ = cfg.iterations(fmt) * cfg.log2r                     # quotient regs

    area = 0.0
    delay = 0.0

    # quotient-digit selection
    if cfg.nonrestoring:
        sel_a, sel_d = 2.0, D_GATE                      # sign bit only
    elif not cfg.redundant_residual:
        sel_a, sel_d = 10.0, 2 * D_GATE                 # Eq 26: 3-bit compare
    elif cfg.radix == 2:
        sel_a, sel_d = 16.0, D_FA + D_GATE              # Eq 27: 4-bit CS est
    elif cfg.scaling:
        sel_a, sel_d = 40.0, D_FA + 2 * D_GATE          # Eq 29: 6-bit est
    else:
        sel_a, sel_d = 120.0, D_FA + 4 * D_GATE         # Eq 28: 7-bit + m_k(d)
    area += sel_a

    # divisor-multiple formation (radix 4 needs +-2d mux)
    mult_mux = (2 if cfg.radix == 4 else 1) * GE_MUX * W
    area += mult_mux

    # residual update
    if cfg.redundant_residual:
        area += GE_FA * W                                # one CSA row
        upd_d = D_FA
    else:
        a_cpa, d_cpa = _cpa(W)
        area += a_cpa
        upd_d = d_cpa
    delay = sel_d + D_MUX + upd_d

    # on-the-fly conversion: Q/QD register pair + appenders (per iteration
    # in combinational designs this is mux+wiring per stage)
    otf_a = (2 * GE_MUX * WQ + 24.0) if cfg.otf else 0.0  # + digit appenders
    otf_d = 2 * D_MUX if cfg.otf else 0.0

    return area, delay, otf_a, otf_d, W, WQ


def estimate(fmt: PositFormat, variant: str, pipelined: bool) -> CostReport:
    cfg = VARIANTS[variant]
    n = fmt.n
    It = cfg.iterations(fmt)
    stage_a, stage_d, otf_a, otf_d, W, WQ = _stage_costs(fmt, cfg)

    # decode: sign inversion (CPA n) + LZC + shifter; encode: shifter + CPA.
    dec_a = sum(x[0] for x in (_cpa(n), _lzc(n), _shifter(n)))
    dec_d = sum(x[1] for x in (_cpa(n), _lzc(n), _shifter(n)))
    enc_a = sum(x[0] for x in (_shifter(n), _cpa(n))) + 4.0 * n
    enc_d = sum(x[1] for x in (_shifter(n), _cpa(n))) + 2 * D_GATE

    # termination: final sign/zero detection + correction
    if cfg.redundant_residual and not cfg.fast_remainder:
        term_a, term_d = _cpa(W)                      # slow CS -> 2's comp
        term_a += 2.0 * W
    elif cfg.redundant_residual:
        term_a = 3.0 * W                              # sign/zero lookahead [15]
        term_d = 2 * D_GATE * math.log2(max(W, 2))
        term_a += 2.0 * W
    else:
        term_a, term_d = 2.0 * W, D_GATE * math.log2(max(W, 2))
    if not cfg.otf:
        a_conv, d_conv = _cpa(WQ)                     # quotient -ulp correction
        term_a += a_conv
        term_d += d_conv

    # operand scaling stage: two CSA rows + CPA for x and d + selector
    if cfg.scaling:
        scale_a = 2 * (2 * GE_FA * W) + 2 * _cpa(W)[0] + 30.0
        scale_d = 2 * D_FA + _cpa(W)[1] + D_MUX
    else:
        scale_a, scale_d = 0.0, 0.0

    if pipelined:
        # one iteration of hardware, reused It times + pipeline registers
        regs = 2 * W * GE_FF if cfg.redundant_residual else W * GE_FF
        regs += (2 if cfg.otf else 1) * WQ * GE_FF
        regs += 4 * n * GE_FF                         # I/O + stage registers
        area = stage_a + otf_a + dec_a + enc_a + term_a + scale_a + regs
        cycle_d = max(stage_d + otf_d + D_FF, term_d + enc_d * 0.5 + D_FF,
                      scale_d + D_FF if cfg.scaling else 0.0)
        cycles = It + 3 + (1 if cfg.scaling else 0)   # Table II latency
        delay = cycle_d * cycles
        power = area * 1.0
        energy_pipe = power * cycles * TCLK_NS
        energy = power * delay
    else:
        # combinational: It unrolled stages
        area = It * (stage_a + otf_a) + dec_a + enc_a + term_a + scale_a
        delay = It * (stage_d + otf_d) + dec_d + enc_d + term_d + scale_d
        cycles = 1
        cycle_d = delay
        power = area * 0.35                           # lower activity, no clk
        energy = power * delay
        energy_pipe = energy

    return CostReport(
        variant=variant, fmt=str(fmt), radix=cfg.radix, iterations=It,
        cycles=(It + 3 + (1 if cfg.scaling else 0)) if pipelined else 1,
        area_ge=area, delay_fo4=delay, cycle_fo4=cycle_d, power_au=power,
        energy_au=energy, energy_pipe_au=energy_pipe,
    )


def table2() -> Dict[str, Dict[str, int]]:
    """Reproduce Table II (iterations + pipelined latency in cycles)."""
    out = {}
    for n in (16, 32, 64):
        fmt = PositFormat(n)
        r2 = VARIANTS["srt_r2_cs"]
        r4 = VARIANTS["srt_r4_cs"]
        out[f"Posit{n}"] = {
            "significand_bits": fmt.F + 1,
            "r2_iterations": r2.iterations(fmt),
            "r2_latency": r2.iterations(fmt) + 3,
            "r4_iterations": r4.iterations(fmt),
            "r4_latency": r4.iterations(fmt) + 3,
        }
    return out


PAPER_TABLE2 = {
    "Posit16": {"significand_bits": 12, "r2_iterations": 14, "r2_latency": 17,
                "r4_iterations": 8, "r4_latency": 11},
    "Posit32": {"significand_bits": 28, "r2_iterations": 30, "r2_latency": 33,
                "r4_iterations": 16, "r4_latency": 19},
    "Posit64": {"significand_bits": 60, "r2_iterations": 62, "r2_latency": 65,
                "r4_iterations": 32, "r4_latency": 35},
}
