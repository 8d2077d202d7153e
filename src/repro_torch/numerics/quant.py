"""Tensor quantization to posit formats with straight-through gradients.

Port of the reference package's ``numerics/quant.py``.  The casts run on
K12 for a CUDA tensor (one launch of its round kernel for
``posit_round_value``, which rounds to the posit grid) and on its plain
twin for a CPU tensor (``kernels/ops.posit_quantize`` /
``posit_dequantize`` / ``posit_round_value``).  Patterns are
int64 lanes holding the unsigned value; the ``pack_*`` wire formats are
uint16 / uint8.
"""

from __future__ import annotations

import torch

from repro_torch.core.posit import PositFormat
from repro_torch.kernels.ops import posit_dequantize, posit_quantize, posit_round_value


def quantize_tensor(fmt: PositFormat, x):
    """float tensor -> posit bit patterns (int64 lanes; pack externally if
    needed)."""
    return posit_quantize(fmt, x)


def dequantize_tensor(fmt: PositFormat, p):
    return posit_dequantize(fmt, p)


class _STE(torch.autograd.Function):
    """Fake-quantize forward, identity backward."""

    @staticmethod
    def forward(ctx, x, fmt):
        return posit_round_value(fmt, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def posit_quantize_ste(fmt: PositFormat, x):
    """Fake-quantize with a straight-through estimator (posit-aware
    training): the forward rounds to the posit grid, the gradient is the
    identity."""
    return _STE.apply(x, fmt)


def pack_posit16(p):
    """posit16 patterns -> the uint16 wire format (for collectives)."""
    return p.to(torch.uint16)


def unpack_posit16(w):
    return w.to(torch.int64)


def pack_posit8(p):
    return p.to(torch.uint8)


def unpack_posit8(w):
    return w.to(torch.int64)
