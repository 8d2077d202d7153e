"""Model ops whose divisions run through the digit-recurrence divider.

Port of the inference side of the reference package's
``numerics/posit_ops.py``: values are quantized to the configured posit
format, divided with the configured Table IV variant and dequantized, in
one launch of the rowwise kernel (K2).  Inference only: the straight-
through gradients come with the training path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import posit_div_fused_rowwise, rowwise_applicable
from .formats import NumericsConfig


def posit_div_values(a, b, cfg: NumericsConfig):
    """``a / b`` in posit arithmetic (float in, float32 out).

    A row-broadcast divisor (size-1 or absent last axis) runs on the rowwise
    kernel with no materialized broadcast.  Same-shape division needs the
    elementwise kernel, which is not ported yet (ROADMAP.md).
    """
    b = torch.as_tensor(b, device=a.device)
    if not rowwise_applicable(a.shape, b.shape):
        raise NotImplementedError(
            f"elementwise posit division ({tuple(a.shape)} / {tuple(b.shape)}) "
            "needs the elementwise fused kernel, not ported yet (ROADMAP.md)")
    bcol = b.broadcast_to(tuple(a.shape[:-1]) + (1,))
    return posit_div_fused_rowwise(cfg.div_fmt, a, bcol, cfg.div_algo)


def posit_rmsnorm_div(x, rms, cfg: NumericsConfig):
    """``x / rms`` via the posit divider (rms broadcast along the last axis):
    the per-row rms is quantized/decoded once per row."""
    return posit_div_values(x, rms, cfg)
