"""Model ops whose divisions run through the digit-recurrence divider.

Port of the reference package's ``numerics/posit_ops.py`` for the rowwise
division: values are quantized to the configured posit format, divided with
the configured Table IV variant and dequantized, in one launch of the
rowwise kernel (K2).  Gradients flow straight through the quantization (the
posit division is a fake-quant of the true one), as the reference's
``_posit_div_rowwise_ste`` custom_vjp: ``ga = g / b`` and ``gb = sum(-g *
out / b)`` over the row, in plain torch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import posit_div_fused_rowwise, rowwise_applicable
from .formats import NumericsConfig


class _RowwiseSTE(torch.autograd.Function):
    """``a[..., C] / bcol[..., 1]`` on K2, straight-through gradients."""

    @staticmethod
    def forward(ctx, a, bcol, fmt, variant):
        out = posit_div_fused_rowwise(fmt, a, bcol, variant)
        ctx.save_for_backward(bcol, out)
        return out

    @staticmethod
    def backward(ctx, g):
        bcol, out = ctx.saved_tensors
        ga = g / bcol
        gb = torch.sum(-g * out / bcol, dim=-1, keepdim=True)
        return ga, gb, None, None


def posit_div_values(a, b, cfg: NumericsConfig):
    """``a / b`` in posit arithmetic (float in, float32 out, STE grads).

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
    return _RowwiseSTE.apply(a, bcol, cfg.div_fmt, cfg.div_algo)


def posit_rmsnorm_div(x, rms, cfg: NumericsConfig):
    """``x / rms`` via the posit divider (rms broadcast along the last axis):
    the per-row rms is quantized/decoded once per row."""
    return posit_div_values(x, rms, cfg)
