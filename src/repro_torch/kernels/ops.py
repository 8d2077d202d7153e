"""The rowwise fused posit divide (K2), the fused posit softmax (K9) and
the rowwise dispatch rule.

Port of the rowwise and softmax entries of the reference package's
``kernels/ops.py``:

* ``a[..., C] / b[..., 1]`` where ``b`` broadcasts into ``a`` with a size-1
  (or absent) last axis — the RMSNorm reciprocal and every per-row
  normalizer.  The divisor stays an O(rows) column end to end.
* the softmax over the last axis with a posit-divided normalizer: row max,
  ``exp``, fixed-order row sum and the SRT divide in one launch — the MoE
  router's probabilities.

For a CUDA tensor :func:`posit_div_fused_rowwise` and
:func:`posit_softmax_fused` launch the hand-written kernels
``csrc/posit_fused_div.cu`` and ``csrc/posit_softmax.cu`` (or raise); for a
CPU tensor they run the plain twins :func:`posit_div_rowwise_plain` and
:func:`posit_softmax_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.posit import PositFormat
from repro_torch.core.quire import fixed_order_rowsum
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


# --------------------------------------------------------------------- K9


def posit_softmax_plain(fmt: PositFormat, x, variant: str = DEFAULT_DIV_VARIANT):
    """The plain PyTorch twin of K9 (any device): float32 out.

    ``m = max(x)`` over the row (NaN if any entry is), ``e = exp(x - m)``,
    ``s`` the fixed-order row sum of ``e``, then ``e / s`` through the SRT
    datapath twin, as the reference's ``_softmax_kernel``."""
    one_word_plan(fmt, variant)
    shape = tuple(x.shape)
    x2 = x.to(torch.float32).reshape(-1, shape[-1])
    e = torch.exp(x2 - torch.amax(x2, dim=-1, keepdim=True))
    return divide_floats_block(fmt, e, fixed_order_rowsum(e), variant).reshape(shape)


@functools.lru_cache(maxsize=None)
def _softmax_fn():
    lib = _build.load("posit_softmax")
    fn = lib.posit_softmax
    fn.argtypes = PLAN_ARGTYPES + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.posit_softmax_max_cols.restype = ctypes.c_int
    return fn, lib.posit_softmax_max_cols()


def _launch_softmax(plan: DatapathPlan, x2: torch.Tensor):
    R, C = x2.shape
    if plan.n != 16:
        raise NotImplementedError(f"the softmax kernel is built for posit16 plans only, "
                                  f"not posit{plan.n} (ROADMAP.md)")
    fn, max_cols = _softmax_fn()
    if C > max_cols or R * C >= 2 ** 31:
        raise ValueError(f"softmax kernel takes rows of at most {max_cols} columns and "
                         f"R*C < 2^31; got ({R}, {C})")
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        rc = fn(*plan_args(plan), x2.data_ptr(), out.data_ptr(), R, C, stream)
    if rc != 0:
        raise RuntimeError(f"posit_softmax launch failed ({rc})")
    return out


def posit_softmax_fused(fmt: PositFormat, x, variant: str = DEFAULT_DIV_VARIANT):
    """Posit softmax over the last axis of ``x``, float32 out.

    CUDA tensors launch the hand-written kernel (counted in
    ``posit_softmax_fused.launches``; posit16 plans only); CPU tensors run
    the plain twin.  Bit-identical to the reference's
    ``ops.posit_softmax_fused`` wherever the two ``exp`` give the same bits.
    """
    plan = one_word_plan(fmt, variant)
    if x.ndim == 0:
        raise ValueError("softmax needs at least one axis")
    if x.device.type == "cuda":
        shape = tuple(x.shape)
        out = _launch_softmax(plan, x.to(torch.float32).reshape(-1, shape[-1]).contiguous())
        posit_softmax_fused.launches += 1
        return out.reshape(shape)
    if x.device.type == "cpu":
        return posit_softmax_plain(fmt, x, variant)
    raise ValueError(f"no posit softmax for device {x.device}")


posit_softmax_fused.launches = 0
