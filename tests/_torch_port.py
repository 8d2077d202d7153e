"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

The reference's Pallas kernels read ``pltpu.TPUCompilerParams``, a name
the installed JAX no longer has (it is ``pltpu.CompilerParams`` there), and
its dk/dv backward kernel calls ``pl.load``, which the installed JAX no
longer has either (a ref is indexed directly there), so the reference
kernels raise before they run.  The port's tests still hold the port
against those kernels, in interpret mode, by aliasing the old names to
their replacements — but only inside a monkeypatch scope, and with JAX's
compile caches cleared on the way out, so no reference test that runs
later in the same worker sees an alias or anything traced under it.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu


@contextlib.contextmanager
def reference_kernels():
    """Run the reference Pallas kernels (interpret mode) inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                   raising=False)
        if not hasattr(pl, "load"):
            mp.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
        try:
            yield
        finally:
            jax.clear_caches()


@pytest.fixture
def ref_kernels():
    with reference_kernels():
        yield


def bits(x) -> np.ndarray:
    """The uint32 bit patterns of a float32 array or tensor."""
    a = x.numpy() if hasattr(x, "numpy") else np.asarray(x)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)
