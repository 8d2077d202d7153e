"""Numeric format registry + per-model numerics configuration.

Port of the reference package's ``numerics/formats.py``, for the one
numerics the port runs: posit division on the fused kernels.  The
reference's switches for float division (``posit_division=False``) and for
its BitVec ``emulate`` backend come back with the slices that port them
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.posit import POSIT8, POSIT16, POSIT32, POSIT64, PositFormat

NUMERIC_FORMATS = {
    "posit8": POSIT8,
    "posit16": POSIT16,
    "posit32": POSIT32,
    "posit64": POSIT64,
}


def resolve_format(name: str) -> PositFormat:
    if name not in NUMERIC_FORMATS:
        raise KeyError(f"unknown posit format {name!r}; have {list(NUMERIC_FORMATS)}")
    return NUMERIC_FORMATS[name]


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Per-model posit numerics: norm denominators and attention's o / l
    run through the digit-recurrence divider on the fused kernels.

    div_format / div_algo: which posit format + Table IV variant to use.
    """

    div_format: str = "posit16"
    div_algo: str = "srt_r4_cs_of_fr"

    @property
    def div_fmt(self) -> PositFormat:
        return resolve_format(self.div_format)

    def validate(self) -> "NumericsConfig":
        """Fail fast on inconsistent switches (called at model build)."""
        from repro_torch.core.divider import VARIANTS
        from repro_torch.kernels.posit_div import one_word_plan

        if self.div_algo not in VARIANTS:
            raise ValueError(f"unknown div_algo {self.div_algo!r}; "
                             f"have {list(VARIANTS)}")
        # raises KeyError on an unknown format name, NotImplementedError on a
        # two-word plan
        one_word_plan(self.div_fmt, self.div_algo)
        return self
