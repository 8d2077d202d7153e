"""Model ops whose divisions run through the digit-recurrence divider.

Port of the reference package's ``numerics/posit_ops.py`` (its ``fused``
backend): values are quantized to the configured posit format, divided
with the configured Table IV variant and dequantized, in one launch of the
rowwise kernel (K2) for a per-row divisor, of the elementwise kernel (K10)
for any other broadcast, or of the fused softmax kernel (K9).  Gradients of
the division flow straight through the quantization (the posit division is
a fake-quant of the true one), as the reference's custom_vjps: ``ga = g /
b`` and ``gb = -g * out / b`` (summed over the row for the rowwise one),
in plain torch.  The softmax's backward is the reference's
``_softmax_bwd``: ``dx = p * (g - sum(g * y))`` with ``p`` the float
softmax of ``x`` recomputed in f32, also in plain torch (the reference
computes it in XLA, outside any kernel).  Every planned (format, variant)
runs, posit64 and posit32 ``srt_r4_scaled`` on the two-word datapath (on
CUDA tensors the softmax's K9 is built for every posit8, posit16, posit32
and posit64 plan).
"""

from __future__ import annotations

import torch

from repro_torch.core.quire import fixed_order_rowsum
from repro_torch.kernels.ops import (
    posit_div_fused,
    posit_div_fused_rowwise,
    posit_softmax_fused,
    rowwise_applicable,
)
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


class _ElementwiseSTE(torch.autograd.Function):
    """Same-shape ``a / b`` on K10, straight-through gradients (reference
    ``_div_bwd``)."""

    @staticmethod
    def forward(ctx, a, b, fmt, variant):
        out = posit_div_fused(fmt, a, b, variant)
        ctx.save_for_backward(b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        b, out = ctx.saved_tensors
        return g / b, -g * out / b, None, None


def posit_div_values(a, b, cfg: NumericsConfig):
    """``a / b`` in posit arithmetic (float in, float32 out, STE grads).

    A row-broadcast divisor (size-1 or absent last axis) runs on the rowwise
    kernel with no materialized broadcast; any other pair is broadcast and
    divided elementwise.  The broadcast is an autograd op, so a broadcast
    operand's gradient is summed back to its own shape.
    """
    b = torch.as_tensor(b, device=a.device)
    if rowwise_applicable(a.shape, b.shape):
        bcol = b.broadcast_to(tuple(a.shape[:-1]) + (1,))
        return _RowwiseSTE.apply(a, bcol, cfg.div_fmt, cfg.div_algo)
    a, b = torch.broadcast_tensors(a, b)
    return _ElementwiseSTE.apply(a, b, cfg.div_fmt, cfg.div_algo)


def posit_rmsnorm_div(x, rms, cfg: NumericsConfig):
    """``x / rms`` via the posit divider (rms broadcast along the last axis):
    the per-row rms is quantized/decoded once per row."""
    return posit_div_values(x, rms, cfg)


class _SoftmaxSTE(torch.autograd.Function):
    """Last-axis softmax on K9, straight-through gradient (reference
    ``_softmax_bwd``): the posit divide's STE chained through ``e = exp(x -
    m)`` and ``s = sum(e)`` collapses to ``dx = p * (g - sum(g * y))``."""

    @staticmethod
    def forward(ctx, x, fmt, variant):
        y = posit_softmax_fused(fmt, x, variant)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        xf = x.to(torch.float32)
        e = torch.exp(xf - torch.amax(xf, dim=-1, keepdim=True))
        p = e / torch.sum(e, dim=-1, keepdim=True)
        dx = p * (g - torch.sum(g * y, dim=-1, keepdim=True))
        return dx.to(x.dtype), None, None


def posit_softmax(x, cfg: NumericsConfig, axis: int = -1):
    """Numerically stable softmax along ``axis`` with a posit-divided
    normalizer: one launch of K9 (row max, exp, fixed-order row sum and the
    SRT divide), float32 out, with the straight-through gradient of
    :class:`_SoftmaxSTE`."""
    ax = axis % x.ndim
    if ax != x.ndim - 1:
        out = _SoftmaxSTE.apply(torch.movedim(x, ax, -1), cfg.div_fmt, cfg.div_algo)
        return torch.movedim(out, -1, ax)
    return _SoftmaxSTE.apply(x, cfg.div_fmt, cfg.div_algo)


def posit_router_norm(weights, cfg: NumericsConfig, axis: int = -1):
    """Normalize MoE router weights to sum to 1 with posit division: the
    fixed-order row sum (batch-composition invariant, as the softmax's) is
    the divisor of a rowwise posit division (K2)."""
    return posit_div_values(weights, fixed_order_rowsum(weights, axis=axis), cfg)
