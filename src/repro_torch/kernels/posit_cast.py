"""f32 <-> posit casts and the rounding to the posit grid (K12): the
launchers of ``csrc/posit_cast.cu`` and their plain twins.

Port of the reference package's ``kernels/posit_cast.py``
(``posit_quantize_pallas``, ``posit_dequantize_pallas``) and of the
rounding its ``numerics/quant.py`` ``posit_round_value`` makes with its jnp
codec.  The twins are :func:`repro_torch.core.posit.float_to_posit` and
``posit_to_float``, the bit-exact codec the tests hold against the
reference's.

Pattern dtype: the port keeps posit patterns in int64 lanes holding the
unsigned 32-bit value (``core/posit.py``).  The quantize kernel writes such
lanes, so a posit32 negative (top bit set) comes back as its unsigned
value, never as a negative int64; the dequantize kernel reads int64 lanes,
int32 words and packed uint16 / uint8 patterns as they are
(``WORD_BYTES``), and any other integer dtype after a cast to int64.  The
round kernel reads and writes bf16 or f32 (``ROUND_DTYPES``), two tensors
in one launch.  The public entry points (with their launch counters) are
``ops.posit_quantize`` / ``ops.posit_dequantize`` /
``ops.posit_round_value`` / ``ops.posit_round_kv``.  The formats the
kernels are built for are ``csrc/posit_cast.cu``'s ``dispatch_format``
alone (``ROUND_FORMATS``): a launch for any other raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.posit import PositFormat, float_to_posit, posit_to_float
from . import _build

# the pattern widths the dequantize kernel reads as they are
WORD_BYTES = {torch.int64: 8, torch.int32: 4, torch.uint32: 4, torch.uint16: 2,
              torch.uint8: 1}
# the round kernel's dtypes, by its C code
ROUND_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/posit_cast.cu dispatch_format
ROUND_FORMATS = (8, 16, 32)


def check_format(fmt: PositFormat) -> None:
    """Casts are storage formats: they must fit a 32-bit word."""
    if fmt.n > 32:
        raise ValueError(f"posit casts take n <= 32 (a uint32 pattern), not {fmt}")


def quantize_plain(fmt: PositFormat, x) -> torch.Tensor:
    """The plain twin of the quantize kernel: int64 lanes out."""
    check_format(fmt)
    return float_to_posit(fmt, x.to(torch.float32))


def dequantize_plain(fmt: PositFormat, p) -> torch.Tensor:
    """The plain twin of the dequantize kernel: float32 out."""
    check_format(fmt)
    return posit_to_float(fmt, p)


def round_plain(fmt: PositFormat, x) -> torch.Tensor:
    """The plain twin of the round kernel: ``x`` rounded to the posit grid
    in f32, then cast back to ``x``'s dtype."""
    return dequantize_plain(fmt, quantize_plain(fmt, x)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _fns():
    lib = _build.load("posit_cast")
    lib.posit_quantize.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong, ctypes.c_void_p]
    lib.posit_dequantize.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.posit_round.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    for fn in (lib.posit_quantize, lib.posit_dequantize, lib.posit_round):
        fn.restype = ctypes.c_int
    return lib


def _check_rc(rc: int, name: str, fmt: PositFormat):
    if rc == -1:
        raise NotImplementedError(f"{name}: no kernel is built for {fmt}; the twin runs on "
                                  "CPU tensors only")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_quantize(fmt: PositFormat, x) -> torch.Tensor:
    """One launch of the quantize kernel on a CUDA tensor: int64 lanes out."""
    x32 = x.to(torch.float32).contiguous()
    out = torch.empty(x32.shape, dtype=torch.int64, device=x32.device)
    with torch.cuda.device(x32.device):
        rc = _fns().posit_quantize(fmt.n, x32.data_ptr(), out.data_ptr(), x32.numel(),
                                   _stream(x32))
    _check_rc(rc, "posit_quantize", fmt)
    return out


def launch_dequantize(fmt: PositFormat, p) -> torch.Tensor:
    """One launch of the dequantize kernel on a CUDA tensor (int64 lanes,
    int32 words and packed patterns read as they are): float32 out."""
    if p.dtype not in WORD_BYTES:
        p = p.to(torch.int64)
    p = p.contiguous()
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        rc = _fns().posit_dequantize(fmt.n, WORD_BYTES[p.dtype], p.data_ptr(), out.data_ptr(),
                                     p.numel(), _stream(p))
    _check_rc(rc, "posit_dequantize", fmt)
    return out


def launch_round(fmt: PositFormat, *xs):
    """One launch of the round kernel on one or two CUDA tensors of one
    dtype among ROUND_DTYPES: each rounded to the posit grid, in its dtype."""
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    pairs = [(x.data_ptr(), y.data_ptr(), x.numel()) for x, y in zip(xs, outs)]
    pairs += [(None, None, 0)] * (2 - len(pairs))
    with torch.cuda.device(xs[0].device):
        rc = _fns().posit_round(fmt.n, ROUND_DTYPES[xs[0].dtype], *pairs[0], *pairs[1],
                                _stream(xs[0]))
    _check_rc(rc, "posit_round", fmt)
    return outs
