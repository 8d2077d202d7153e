"""f32 <-> posit casts (K12): the launchers of ``csrc/posit_cast.cu`` and
their plain twins.

Port of the reference package's ``kernels/posit_cast.py``
(``posit_quantize_pallas``, ``posit_dequantize_pallas``).  The twins are
:func:`repro_torch.core.posit.float_to_posit` and ``posit_to_float``, the
bit-exact codec the tests hold against the reference's.

Pattern dtype: the port keeps posit patterns in int64 lanes holding the
unsigned 32-bit value (``core/posit.py``); the kernels read and write
32-bit words.  :func:`to_words` and :func:`from_words` convert at the
public entry points, so a posit32 negative (top bit set) comes back as the
same unsigned value, never as a negative int64; the launchers themselves
take and give int32 words, so a rounding (quantize, then dequantize) keeps
its patterns in one word buffer.  The public entry points (with their
launch counters) are ``ops.posit_quantize`` / ``ops.posit_dequantize`` /
``ops.posit_round_value``.  The formats the kernels are built for are
``csrc/posit_cast.cu``'s ``dispatch_format`` alone: a launch for any
other raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.posit import M32, PositFormat, float_to_posit, posit_to_float
from . import _build

def to_words(p) -> torch.Tensor:
    """Contiguous int32 words holding the low 32 bits of integer patterns
    (int64 lanes, int32 words, or packed uint8/uint16)."""
    if p.dtype == torch.int32:
        return p.contiguous()
    return p.to(torch.int64).to(torch.int32).contiguous()


def from_words(w) -> torch.Tensor:
    """int64 lanes holding the unsigned value of 32-bit words."""
    return w.to(torch.int64) & M32


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


@functools.lru_cache(maxsize=None)
def _fns():
    lib = _build.load("posit_cast")
    for fn in (lib.posit_quantize, lib.posit_dequantize):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib.posit_quantize, lib.posit_dequantize


def _run(which: int, name: str, fmt: PositFormat, src: torch.Tensor, out: torch.Tensor):
    fn = _fns()[which]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        rc = fn(fmt.n, src.data_ptr(), out.data_ptr(), src.numel(), stream)
    if rc == -1:
        raise NotImplementedError(f"{name}: no kernel is built for {fmt}; the twin runs on "
                                  "CPU tensors only")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return out


def launch_quantize(fmt: PositFormat, x) -> torch.Tensor:
    """One launch of the quantize kernel on a CUDA tensor: int32 words out."""
    x32 = x.to(torch.float32).contiguous()
    words = torch.empty(x32.shape, dtype=torch.int32, device=x32.device)
    return _run(0, "posit_quantize", fmt, x32, words)


def launch_dequantize(fmt: PositFormat, p) -> torch.Tensor:
    """One launch of the dequantize kernel on a CUDA tensor (int32 words go
    in as they are): float32 out."""
    words = to_words(p)
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    return _run(1, "posit_dequantize", fmt, words, out)
