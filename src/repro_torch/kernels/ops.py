"""The rowwise fused posit divide (K2) and its dispatch rule.

Port of the rowwise entry of the reference package's ``kernels/ops.py``:
``a[..., C] / b[..., 1]`` where ``b`` broadcasts into ``a`` with a size-1
(or absent) last axis — the RMSNorm reciprocal and every per-row
normalizer.  The divisor stays an O(rows) column end to end.

For a CUDA tensor :func:`posit_div_fused_rowwise` launches the hand-written
kernel ``csrc/posit_fused_div.cu`` (or raises); for a CPU tensor it runs the
plain twin :func:`posit_div_rowwise_plain`, which is bit-identical.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.posit import PositFormat
from . import _build
from .posit_div import (
    DEFAULT_KERNEL_VARIANT,
    DatapathPlan,
    divide_floats_block,
    one_word_plan,
)

DEFAULT_DIV_VARIANT = DEFAULT_KERNEL_VARIANT
_ROWS_PER_BLOCK = 4          # csrc/posit_fused_div.cu kRows
_MAX_GRID_Y = 65535


def plan_args(plan: DatapathPlan):
    """The plan fields in the order the C entry points take them."""
    return (plan.n, plan.radix, int(plan.redundant), int(plan.otf),
            int(plan.scaled), int(plan.nonrestoring), plan.iterations,
            plan.shift, plan.gbits)


PLAN_ARGTYPES = [ctypes.c_int] * 9


def rowwise_applicable(a_shape, b_shape) -> bool:
    """Is ``a / b`` a row-broadcast division the rowwise kernel can take?

    True when ``b`` broadcasts into ``a`` with a size-1 (or absent) last
    axis while ``a``'s last axis is real.
    """
    a_shape, b_shape = tuple(a_shape), tuple(b_shape)
    if len(a_shape) == 0 or a_shape[-1] <= 1:
        return False
    if len(b_shape) > len(a_shape):
        return False
    if b_shape and b_shape[-1] != 1:
        return False
    try:
        out = np.broadcast_shapes(a_shape, b_shape)
    except ValueError:
        return False
    return out == a_shape


@functools.lru_cache(maxsize=None)
def _rowwise_fn():
    fn = _build.load("posit_fused_div").posit_fused_div_rowwise
    fn.argtypes = PLAN_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_rowwise(plan: DatapathPlan, a2: torch.Tensor, bcol: torch.Tensor):
    R, C = a2.shape
    if R * C >= 2 ** 31 or -(-R // _ROWS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"rowwise kernel takes R*C < 2^31 and R <= "
                         f"{_ROWS_PER_BLOCK * _MAX_GRID_Y} rows; got ({R}, {C})")
    out = torch.empty_like(a2)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        rc = _rowwise_fn()(*plan_args(plan), a2.data_ptr(), bcol.data_ptr(),
                           out.data_ptr(), R, C, stream)
    if rc != 0:
        raise RuntimeError(f"posit_fused_div_rowwise launch failed ({rc}): "
                           + ("no compiled plan" if rc < 0 else
                              f"cudaError {rc}"))
    return out


def _as_rows(a, b):
    shape = tuple(a.shape)
    C = shape[-1]
    a2 = a.to(torch.float32).reshape(-1, C).contiguous()
    bcol = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    bcol = bcol.broadcast_to(shape[:-1] + (1,)).reshape(-1, 1).contiguous()
    return shape, a2, bcol


def _check(fmt: PositFormat, a, b, variant: str) -> DatapathPlan:
    plan = one_word_plan(fmt, variant)
    if not rowwise_applicable(a.shape, tuple(getattr(b, "shape", ()))):
        raise ValueError(
            f"rowwise division needs a per-row divisor; got a.shape="
            f"{tuple(a.shape)}, b.shape={tuple(getattr(b, 'shape', ()))}")
    return plan


def posit_div_rowwise_plain(fmt: PositFormat, a, b,
                            variant: str = DEFAULT_DIV_VARIANT):
    """The plain PyTorch twin of K2 (any device): float32 out."""
    _check(fmt, a, b, variant)
    shape, a2, bcol = _as_rows(a, b)
    return divide_floats_block(fmt, a2, bcol, variant).reshape(shape)


def posit_div_fused_rowwise(fmt: PositFormat, a, b,
                            variant: str = DEFAULT_DIV_VARIANT):
    """Row-broadcast fused division ``a[..., C] / b[..., 1]``, float32 out.

    CUDA tensors launch the hand-written kernel (counted in
    ``posit_div_fused_rowwise.launches``); CPU tensors run the plain twin.
    Bit-identical to the reference's ``ops.posit_div_fused_rowwise``.
    """
    plan = _check(fmt, a, b, variant)
    if a.device.type == "cuda":
        shape, a2, bcol = _as_rows(a, b)
        out = _launch_rowwise(plan, a2, bcol)
        posit_div_fused_rowwise.launches += 1
        return out.reshape(shape)
    if a.device.type == "cpu":
        return posit_div_rowwise_plain(fmt, a, b, variant)
    raise ValueError(f"no posit divide for device {a.device}")


posit_div_fused_rowwise.launches = 0
