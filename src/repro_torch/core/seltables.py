"""Quotient-digit selection tables for SRT division (paper Section III-D).

A copy of the reference package's ``core/seltables.py`` constants (the port
imports nothing of the JAX package); the derivation is kept so the frozen
radix-4 table stays verified by construction.

The radix-4, a=2 (rho = 2/3) selection constants ``m_k(d_hat)`` of Eq. (28)
are *derived* here from the containment conditions of the digit-recurrence
rather than copied from [15], then frozen as integer constants.  The
derivation is re-run at import (microseconds) and asserts feasibility, so the
table is verified-by-construction; the divider tests additionally verify the
residual bound |w(i)| <= rho*d on every iteration empirically.

Conventions (divisor normalized to [1/2, 1)):
  - digit k is valid for shifted residual y = 4*w(i) iff
        (k - rho) * d <= y <= (k + rho) * d
  - carry-save estimate: each word truncated to ``g`` fractional bits, so
        y_hat <= y < y_hat + 2^(1-g)
  - selection: digit = k  iff  m_k <= y_hat < m_{k+1}   (m_{-2} = -inf,
    m_3 = +inf), constants are multiples of 2^-g.
"""

from __future__ import annotations

from fractions import Fraction as Fr

RHO = Fr(2, 3)
G_FRAC = 4            # fractional bits of the carry-save estimate (paper: 4)
EST_INT_BITS = 3      # integer bits incl. sign (window [-4, 4))
DHAT_BITS = 3         # divisor truncated to 0.1xxx -> 8 intervals (paper: 4 bits)


def derive_radix4_table(g: int = G_FRAC, dbits: int = DHAT_BITS):
    """Derive m_k constants (units of 2^-g) for each divisor interval.

    Returns list over divisor intervals i (d in [(8+i)/16, (9+i)/16)) of
    dicts {k: m_k_int} for k in {-1, 0, 1, 2}.
    """
    ulp = Fr(1, 1 << g)
    err = 2 * ulp  # carry-save truncation: e in [0, 2^(1-g))
    ndiv = 1 << dbits
    tables = []
    for i in range(ndiv):
        dlo = Fr(ndiv + i, 2 * ndiv)
        dhi = Fr(ndiv + i + 1, 2 * ndiv)
        row = {}
        for k in (-1, 0, 1, 2):
            # Containment bottom for digit k: m_k >= max_d (k - rho) * d.
            lk = (k - RHO) * (dhi if k - RHO >= 0 else dlo)
            # Containment top for digit k-1: max true y for digit k-1 is
            # (m_k - ulp) + (err - eps) which must be <= min_d (k-1+rho)*d.
            uk1 = (k - 1 + RHO) * (dlo if k - 1 + RHO >= 0 else dhi)
            lo = lk / ulp                    # m_k >= lo
            hi = (uk1 - err + ulp) / ulp     # m_k <= hi  (strictness via ulp)
            m_lo = -(-lo.numerator // lo.denominator)   # ceil
            m_hi = hi.numerator // hi.denominator       # floor
            if m_lo > m_hi:
                raise ValueError(
                    f"infeasible selection constant: interval {i}, digit {k}: "
                    f"[{m_lo}, {m_hi}]"
                )
            row[k] = m_lo
        # sanity: thresholds must be increasing
        assert row[-1] < row[0] < row[1] < row[2], row
        tables.append(row)
    return tables


RADIX4_TABLE = derive_radix4_table()

# Flattened threshold arrays (index = divisor interval), for vectorized use.
RADIX4_M2 = tuple(r[2] for r in RADIX4_TABLE)
RADIX4_M1 = tuple(r[1] for r in RADIX4_TABLE)
RADIX4_M0 = tuple(r[0] for r in RADIX4_TABLE)
RADIX4_MM1 = tuple(r[-1] for r in RADIX4_TABLE)


# Radix-4 with operand scaling, Eq. (29): divisor-independent thresholds,
# estimate with 3 fractional bits (6 MSBs: 3 integer + 3 fraction).
# digit = +2 if y_hat >= 3/2 ; +1 if >= 1/2 ; 0 if >= -1/2 ; -1 if >= -13/8
# (units of 1/8)
SCALED_G_FRAC = 3
SCALED_M2 = 12    # 3/2
SCALED_M1 = 4     # 1/2
SCALED_M0 = -4    # -1/2
SCALED_MM1 = -13  # -13/8

# Scaled-divisor range (Table I): z = M*d lands in [63/64, 9/8] for every
# base interval; Eq 29's divisor-independent thresholds must contain the
# recurrence over this whole range (the reference's static prover checks
# both halves exactly).
SCALED_Z_LO = Fr(63, 64)
SCALED_Z_HI = Fr(9, 8)

# Radix-2 selection constants, units of 2^-1 (the estimate keeps one
# fraction bit; tb = 4 = 3 integer + 1 fraction bits).
#   Eq 26 (non-redundant residual):  q = 1 iff yh >= 1;  0 iff yh >= -1
R2_EXACT_M1 = 1
R2_EXACT_M0 = -1
#   Eq 27 (carry-save estimate):     q = 1 iff yh >= 0;  0 iff yh == -1
R2_CS_M1 = 0
R2_CS_M0 = -1


# Operand scaling factors, Table I: index = 3 fraction bits of d (0.1xxx).
# M*d = d + (d >> s1) + (d >> s2);  s = None means no term.
SCALING_SHIFTS = (
    (1, 1),    # 0.1000 -> M = 2      = 1 + 1/2 + 1/2
    (2, 1),    # 0.1001 -> M = 1.75   = 1 + 1/4 + 1/2
    (1, 3),    # 0.1010 -> M = 1.625  = 1 + 1/2 + 1/8
    (1, None),  # 0.1011 -> M = 1.5   = 1 + 1/2
    (2, 3),    # 0.1100 -> M = 1.375  = 1 + 1/4 + 1/8
    (2, None),  # 0.1101 -> M = 1.25  = 1 + 1/4
    (3, None),  # 0.1110 -> M = 1.125 = 1 + 1/8
    (3, None),  # 0.1111 -> M = 1.125 = 1 + 1/8
)
