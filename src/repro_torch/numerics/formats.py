"""Numeric format registry + per-model numerics configuration.

Port of the reference package's ``numerics/formats.py``, for the one
numerics the port runs: posit division on the fused kernels.  The
reference's switches for float division (``posit_division=False``) and for
its BitVec ``emulate`` backend come back with the slices that port them
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    grad_compress_format: posit format every gradient leaf is rounded to
        before the optimizer update (``optim.grad_compress``; None = the
        f32 gradients as they are).
    kv_cache_format: posit format the KV cache's rows are rounded to at
        insertion (None = the compute dtype's values, unrounded).
    """

    div_format: str = "posit16"
    div_algo: str = "srt_r4_cs_of_fr"
    grad_compress_format: Optional[str] = None
    kv_cache_format: Optional[str] = None

    @property
    def div_fmt(self) -> PositFormat:
        return resolve_format(self.div_format)

    def validate(self) -> "NumericsConfig":
        """Fail fast on inconsistent switches (called at model build)."""
        from repro_torch.core.divider import VARIANTS
        from repro_torch.kernels.posit_div import datapath_plan

        if self.div_algo not in VARIANTS:
            raise ValueError(f"unknown div_algo {self.div_algo!r}; "
                             f"have {list(VARIANTS)}")
        # raises KeyError on an unknown format name, ValueError where the
        # reference's kernel_plan_error names no datapath (posit64
        # srt_r4_scaled); every planned pair, two-word ones included, passes
        datapath_plan(self.div_fmt, self.div_algo)
        for field, name in (("grad_compress_format", self.grad_compress_format),
                            ("kv_cache_format", self.kv_cache_format)):
            if name and resolve_format(name).n > 32:
                raise ValueError(
                    f"{field}={name!r} is a storage/wire format and must fit "
                    "a uint32 word (n <= 32); posit64 is division-only")
        return self
