"""Table IV divider micro-architectures (the rows the kernels are planned from).

A copy of ``DividerConfig`` / ``VARIANTS`` from the reference package's
``core/divider.py`` (with the Eq 30-31 iteration count the cost model
reads).  The BitVec emulation divider that file also holds is not ported:
the port's goldens are the reference itself, held against in the tests,
and ``core/goldens.py``.
"""

from __future__ import annotations

import dataclasses

from .posit import PositFormat


@dataclasses.dataclass(frozen=True)
class DividerConfig:
    """One divider micro-architecture (a row of the paper's Table IV)."""

    name: str
    radix: int = 4
    redundant_residual: bool = True
    otf: bool = True
    fast_remainder: bool = True
    scaling: bool = False
    nonrestoring: bool = False  # Algorithm 1 (digit set {-1, 1})

    @property
    def rho_is_one(self) -> bool:
        # radix-2 digit sets used here have rho = 1; radix-4 a=2 -> rho = 2/3.
        return self.radix == 2

    @property
    def p_shift(self) -> int:
        """Initialization shift (Section III-C): w(0) = x / p."""
        return 1 if self.rho_is_one else 2

    @property
    def log2r(self) -> int:
        return 1 if self.radix == 2 else 2

    def h(self, fmt: PositFormat) -> int:
        """Quotient bits required (Eq 30): n - 1 - floor(rho)."""
        return fmt.n - 1 - (1 if self.rho_is_one else 0)

    def iterations(self, fmt: PositFormat) -> int:
        """Eq 31."""
        return -(-self.h(fmt) // self.log2r)


VARIANTS = {
    "nrd": DividerConfig("nrd", radix=2, redundant_residual=False, otf=False,
                         fast_remainder=False, nonrestoring=True),
    "srt_r2": DividerConfig("srt_r2", radix=2, redundant_residual=False,
                            otf=False, fast_remainder=False),
    "srt_r2_cs": DividerConfig("srt_r2_cs", radix=2, otf=False,
                               fast_remainder=False),
    "srt_r2_cs_of": DividerConfig("srt_r2_cs_of", radix=2,
                                  fast_remainder=False),
    "srt_r2_cs_of_fr": DividerConfig("srt_r2_cs_of_fr", radix=2),
    "srt_r4_cs": DividerConfig("srt_r4_cs", otf=False, fast_remainder=False),
    "srt_r4_cs_of": DividerConfig("srt_r4_cs_of", fast_remainder=False),
    "srt_r4_cs_of_fr": DividerConfig("srt_r4_cs_of_fr"),
    "srt_r4_scaled": DividerConfig("srt_r4_scaled", scaling=True),
}

DEFAULT_VARIANT = "srt_r4_cs_of_fr"
