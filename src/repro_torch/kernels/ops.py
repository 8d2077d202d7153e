"""The division API and the rowwise dispatch rule: the elementwise fused
posit divide (K10), the pattern divide (K11), the f32 <-> posit casts
(K12), the rowwise fused divide (K2) and the fused posit softmax (K9).

Port of the reference package's ``kernels/ops.py``:

* ``posit_div`` — division on posit bit patterns (n <= 32), any shape;
* ``posit_div_fused`` — quantize, SRT divide, dequantize on same-shape
  float operands in one launch, bit-identical to the chained
  ``posit_quantize -> posit_div -> posit_dequantize``;
* ``posit_quantize`` / ``posit_dequantize`` — the storage casts;
  ``posit_round_value`` / ``posit_round_kv`` — the rounding to the posit
  grid in one pass (the straight-through quantizer; the posit-KV cache's K
  and V, both in one launch);
* ``a[..., C] / b[..., 1]`` where ``b`` broadcasts into ``a`` with a size-1
  (or absent) last axis — the RMSNorm reciprocal and every per-row
  normalizer.  The divisor stays an O(rows) column end to end.
* the softmax over the last axis with a posit-divided normalizer: row max,
  ``exp``, fixed-order row sum and the SRT divide in one launch — the MoE
  router's probabilities.

For a CUDA tensor each entry point launches its hand-written kernel
(``csrc/posit_fused_div.cu``, ``posit_div.cu``, ``posit_cast.cu``,
``posit_softmax.cu``) and counts the launch in its ``launches`` attribute,
or raises where no kernel is compiled for the plan or format: it never runs
the twin instead.  For a CPU tensor it runs the plain twin
(``*_plain``).  Patterns are int64 lanes holding the unsigned 32-bit value
(``core/posit.py``); ``posit_div`` and ``posit_dequantize`` also take
int32 words or packed uint8/uint16 patterns, which their kernels read as
they are (``posit_div`` packed ones after a cast to int64).  The
reference's ``block`` and ``interpret`` arguments and its padding have no
counterpart: the kernels mask their ragged end, and any shape, zero-size
included, is taken.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.posit import PositFormat
from repro_torch.core.quire import fixed_order_rowsum
from . import _build
from . import posit_cast as _cast
from .posit_div import (
    DEFAULT_KERNEL_VARIANT,
    KERNEL_VARIANTS,
    DatapathPlan,
    _divide_block,
    datapath_plan,
    divide_floats_block,
    kernel_plan_error,
)

DEFAULT_DIV_VARIANT = DEFAULT_KERNEL_VARIANT
FUSED_DIV_VARIANTS = KERNEL_VARIANTS


def plan_args(plan: DatapathPlan):
    """The plan fields in the order the C entry points take them."""
    return (plan.n, plan.radix, int(plan.redundant), int(plan.otf),
            int(plan.scaled), int(plan.nonrestoring), plan.iterations,
            plan.shift, plan.gbits)


PLAN_ARGTYPES = [ctypes.c_int] * 9


def fused_variant_supported(fmt: PositFormat, variant: str) -> bool:
    """Does (fmt, variant) have a single-kernel fused datapath plan?"""
    return kernel_plan_error(fmt, variant) is None


def _pair(a, b, what: str, dtype):
    """``a`` and ``b`` (moved to ``a``'s device) of one shape, as ``dtype``."""
    if not (isinstance(b, torch.Tensor) and b.device == a.device):
        b = torch.as_tensor(b, device=a.device)
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"{what} takes operands of one shape; got {tuple(a.shape)} and "
                         f"{tuple(b.shape)} (numerics.posit_div_values broadcasts)")
    return a.to(dtype), b.to(dtype)


@functools.lru_cache(maxsize=None)
def _flat_fn(lib: str, sym: str):
    fn = getattr(_build.load(lib), sym)
    fn.argtypes = PLAN_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_plan_args = functools.lru_cache(maxsize=None)(plan_args)


def _on_device(device: torch.device, fn, *args):
    """``fn(*args)`` with ``device`` current (a launch goes to the current
    device), entering its context only when another device is current."""
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def _launch_flat(fn, what: str, fmt: PositFormat, variant: str, a, b, out):
    """One launch of an elementwise kernel over contiguous ``a``, ``b``.

    The plans the kernel is built for are its source's ``dispatch_plan``
    alone: for any other the launch returns -1 and this raises (it never
    falls back to the twin)."""
    plan = datapath_plan(fmt, variant)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _on_device(a.device, fn, *_plan_args(plan), a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), a.numel(), stream)
    _check_launch(rc, what, fmt, variant)
    return out


def _unsupported_device(what: str, t):
    return ValueError(f"no {what} for device {t.device}")


def _check_launch(rc: int, what: str, fmt: PositFormat, variant: str):
    """Raise for a launch's return code: -1 when the kernel's own plan table
    has no row for (fmt, variant) (never the twin instead), a cudaError."""
    if rc == -1:
        raise NotImplementedError(f"{what}: no kernel is built for {fmt} {variant}; the twin "
                                  "runs on CPU tensors only")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


# ------------------------------------------------------------- K11: patterns


@functools.lru_cache(maxsize=None)
def _pattern_fn():
    fn = _build.load("posit_div").posit_div
    fn.argtypes = PLAN_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _pattern_plan(fmt: PositFormat, variant: str) -> DatapathPlan:
    if fmt.n > 32:
        raise ValueError(
            f"posit_div takes uint32 bit patterns, which cannot hold {fmt}; "
            "wide formats divide through the float-level fused entry points "
            "(posit_div_fused / posit_div_fused_rowwise / posit_softmax_fused)")
    return datapath_plan(fmt, variant)


def posit_div_plain(fmt: PositFormat, px, pd, variant: str = DEFAULT_DIV_VARIANT):
    """The plain PyTorch twin of K11 (any device): int64 lanes out."""
    _pattern_plan(fmt, variant)
    px, pd = _pair(px, pd, "posit_div", torch.int64)
    return _divide_block(fmt, px, pd, variant)


def posit_div(fmt: PositFormat, px, pd, variant: str = DEFAULT_DIV_VARIANT):
    """Elementwise posit division on bit patterns (n <= 32, any shape).

    CUDA tensors launch K11 (counted in ``posit_div.launches``); CPU tensors
    run the plain twin.  Bit-identical to the reference's ``ops.posit_div``.
    """
    plan = _pattern_plan(fmt, variant)
    if px.device.type == "cuda":
        dtype = px.dtype if px.dtype in (torch.int64, torch.int32) else torch.int64
        wx, wd = (t.contiguous() for t in _pair(px, pd, "posit_div", dtype))
        out = torch.empty(wx.shape, dtype=torch.int64, device=wx.device)
        rc = _on_device(wx.device, _pattern_fn(), *_plan_args(plan), wx.data_ptr(),
                        wd.data_ptr(), out.data_ptr(), wx.numel(), int(dtype == torch.int64),
                        torch.cuda.current_stream(wx.device).cuda_stream)
        _check_launch(rc, "posit_div", fmt, variant)
        posit_div.launches += 1
        return out
    if px.device.type == "cpu":
        return posit_div_plain(fmt, px, pd, variant)
    raise _unsupported_device("posit divide", px)


posit_div.launches = 0


# ------------------------------------------------------------ K10: elementwise


def posit_div_fused_plain(fmt: PositFormat, a, b, variant: str = DEFAULT_DIV_VARIANT):
    """The plain PyTorch twin of K10 (any device): float32 out."""
    datapath_plan(fmt, variant)
    a, b = _pair(a, b, "posit_div_fused", torch.float32)
    return divide_floats_block(fmt, a, b, variant)


def posit_div_fused(fmt: PositFormat, a, b, variant: str = DEFAULT_DIV_VARIANT):
    """Fused quantize -> divide -> dequantize on same-shape operands:
    float32 out, one launch.

    CUDA tensors launch K10 (counted in ``posit_div_fused.launches``); CPU
    tensors run the plain twin.  Bit-identical to the reference's
    ``ops.posit_div_fused`` and to the chained
    ``posit_dequantize(posit_div(posit_quantize(a), posit_quantize(b)))``
    (n <= 32; posit64 divides on its wide casts inside the same launch).
    """
    datapath_plan(fmt, variant)
    if a.device.type == "cuda":
        a32, b32 = (t.contiguous() for t in _pair(a, b, "posit_div_fused", torch.float32))
        out = _launch_flat(_flat_fn("posit_fused_div", "posit_fused_div"), "posit_div_fused",
                           fmt, variant, a32, b32, torch.empty_like(a32))
        posit_div_fused.launches += 1
        return out
    if a.device.type == "cpu":
        return posit_div_fused_plain(fmt, a, b, variant)
    raise _unsupported_device("posit divide", a)


posit_div_fused.launches = 0


# ------------------------------------------------------------------ K12: casts

posit_quantize_plain = _cast.quantize_plain
posit_dequantize_plain = _cast.dequantize_plain
posit_round_plain = _cast.round_plain


def posit_quantize(fmt: PositFormat, x):
    """float32 -> posit patterns (int64 lanes; RNE, saturating), any shape.

    CUDA tensors launch K12's quantize kernel (posit8/16/32, counted in
    ``posit_quantize.launches``), which writes the lanes itself; CPU tensors
    run the plain twin."""
    _cast.check_format(fmt)
    if x.device.type == "cuda":
        out = _cast.launch_quantize(fmt, x)
        posit_quantize.launches += 1
        return out
    if x.device.type == "cpu":
        return _cast.quantize_plain(fmt, x)
    raise _unsupported_device("posit cast", x)


def posit_dequantize(fmt: PositFormat, p):
    """posit patterns (int64 lanes, int32 words or packed) -> float32, any
    shape.  CUDA tensors launch K12's dequantize kernel (posit8/16/32,
    counted in ``posit_dequantize.launches``), which reads the patterns as
    they are; CPU tensors run the twin."""
    _cast.check_format(fmt)
    if p.device.type == "cuda":
        out = _cast.launch_dequantize(fmt, p)
        posit_dequantize.launches += 1
        return out
    if p.device.type == "cpu":
        return _cast.dequantize_plain(fmt, p)
    raise _unsupported_device("posit cast", p)


posit_quantize.launches = 0
posit_dequantize.launches = 0


def posit_round_value(fmt: PositFormat, x):
    """``x`` rounded to the nearest posit value, float32 out: the bits of
    ``posit_dequantize(posit_quantize(x))``.

    CUDA tensors launch K12's round kernel once (f32 in and out; counted in
    ``posit_round_value.launches``); CPU tensors run the twins."""
    _cast.check_format(fmt)
    if x.device.type == "cuda":
        (out,) = _cast.launch_round(fmt, x.to(torch.float32))
        posit_round_value.launches += 1
        return out
    if x.device.type == "cpu":
        return _cast.dequantize_plain(fmt, _cast.quantize_plain(fmt, x))
    raise _unsupported_device("posit cast", x)


posit_round_value.launches = 0


def posit_round_kv(fmt: PositFormat, k, v):
    """K and V rounded to the posit grid ``fmt`` in their own dtype (bf16 or
    f32), as the posit-KV cache stores them: each element's
    ``posit_round_value`` cast back to the dtype (bf16 as the card's
    conversion rounds: ``csrc/posit_srt.cuh`` ``bf16_bits``).

    CUDA tensors launch K12's round kernel once for both (counted in
    ``posit_round_kv.launches``), with no copy to f32 and back; CPU tensors
    run the twin chain (quantize, dequantize, cast).  posit8/16/32 only
    (the formats the kernel is built for), on any device."""
    _cast.check_format(fmt)
    if fmt.n not in _cast.ROUND_FORMATS:
        raise NotImplementedError(f"posit_round_kv: no kernel is built for {fmt}")
    if k.dtype not in _cast.ROUND_DTYPES or v.dtype != k.dtype or v.device != k.device:
        raise ValueError(f"posit_round_kv takes K and V of one dtype among "
                         f"{list(_cast.ROUND_DTYPES)} on one device; got {k.dtype} on "
                         f"{k.device} and {v.dtype} on {v.device}")
    if k.device.type == "cuda":
        out = tuple(_cast.launch_round(fmt, k, v))
        posit_round_kv.launches += 1
        return out
    if k.device.type == "cpu":
        return _cast.round_plain(fmt, k), _cast.round_plain(fmt, v)
    raise _unsupported_device("posit cast", k)


posit_round_kv.launches = 0


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
    # b broadcasts to a's shape: each of its axes is 1 or a's
    return all(d in (1, ad) for d, ad in zip(b_shape, a_shape[len(a_shape) - len(b_shape):]))


@functools.lru_cache(maxsize=None)
def _rowwise_fn():
    fn = _build.load("posit_fused_div").posit_fused_div_rowwise
    fn.argtypes = PLAN_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_rowwise(plan: DatapathPlan, a2: torch.Tensor, bcol: torch.Tensor):
    R, C = a2.shape
    out = torch.empty_like(a2)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    rc = _on_device(a2.device, _rowwise_fn(), *_plan_args(plan), a2.data_ptr(),
                    bcol.data_ptr(), out.data_ptr(), R, C, stream)
    if rc == -1:
        raise NotImplementedError(f"posit_fused_div_rowwise: no kernel is built for "
                                  f"posit{plan.n} {plan.variant}")
    if rc != 0:
        raise RuntimeError(f"posit_fused_div_rowwise launch failed ({rc}): "
                           + ("more than 2^31 - 1 rows or 65535 column tiles of 128"
                              if rc == -2 else
                              f"cudaError {rc}"))
    return out


def _as_rows(a, b):
    shape = tuple(a.shape)
    C = shape[-1]
    a2 = a.to(torch.float32).reshape(-1, C).contiguous()
    rows = shape[:-1] + (1,)
    if not (isinstance(b, torch.Tensor) and b.dtype == torch.float32 and b.device == a.device
            and tuple(b.shape) == rows and b.is_contiguous()):
        b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
        b = b.broadcast_to(rows).contiguous()
    return shape, a2, b.reshape(-1, 1)


def _check(fmt: PositFormat, a, b, variant: str) -> DatapathPlan:
    plan = datapath_plan(fmt, variant)
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
    datapath_plan(fmt, variant)
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
    fn, max_cols = _softmax_fn()
    if C > max_cols or R * C >= 2 ** 31:
        raise ValueError(f"softmax kernel takes rows of at most {max_cols} columns and "
                         f"R*C < 2^31; got ({R}, {C})")
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        rc = fn(*plan_args(plan), x2.data_ptr(), out.data_ptr(), R, C, stream)
    if rc == -1:
        raise NotImplementedError(f"posit_softmax: no kernel is built for posit{plan.n} "
                                  f"{plan.variant} (ROADMAP.md)")
    if rc != 0:
        raise RuntimeError(f"posit_softmax launch failed ({rc})")
    return out


def posit_softmax_fused(fmt: PositFormat, x, variant: str = DEFAULT_DIV_VARIANT):
    """Posit softmax over the last axis of ``x``, float32 out.

    CUDA tensors launch the hand-written kernel (counted in
    ``posit_softmax_fused.launches``; every posit8, posit16, posit32 and
    posit64 plan, else ``NotImplementedError``);
    CPU tensors run the plain twin.  Bit-identical to the reference's
    ``ops.posit_softmax_fused`` wherever the two ``exp`` give the same bits.
    """
    plan = datapath_plan(fmt, variant)
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
