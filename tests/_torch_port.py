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
import jax.numpy as jnp
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


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for the module that uses it, restored
    after.  The suite runs six workers on one host, each with torch's
    default pool of a thread a core: a module of many small ops (a CPU
    training loop, a scanned prefill) then waits on the other workers'
    threads, 20x slower than alone (``test_loss_decreases``: 30 s alone,
    613 s in the suite), where one thread a worker is 1.3x slower alone.
    Every comparison in such a module runs at the one thread count."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOGIT_ULPS = 8      # engine logits against the reference's, as tests/test_torch_model.py


def _assert_tokens_match(jcfg, jp, stream, ref, got, max_seq):
    """Each request's greedy tokens are the reference engine's, or first
    differ where the reference's top-2 margin is within the logit bound.
    ``stream`` holds (prompt, max_new) pairs, ``jp`` the reference's
    parameters."""
    from repro.models import transformer as JT

    for (p, _), r, g in zip(stream, ref, got):
        if np.array_equal(r, g):
            continue
        j = int(np.flatnonzero(r != g)[0])      # first differing token
        with reference_kernels():
            seq = jnp.asarray(np.concatenate([p, r[:j]])[None])
            lg, _ = JT.prefill(jp, jcfg, {"tokens": seq},
                               JT.init_cache(jcfg, 1, max_seq))
        row = np.asarray(lg[0, -1, :jcfg.vocab].astype(jnp.float32))
        top2 = np.sort(row)[-2:]
        print(f"token {j} differs; reference top-2 margin {top2[1] - top2[0]:.4g}")
        assert top2[1] - top2[0] <= LOGIT_ULPS * bf16_ulp(np.abs(row).max())


def bits(x) -> np.ndarray:
    """The uint32 bit patterns of a float32 array or tensor."""
    a = x.numpy() if hasattr(x, "numpy") else np.asarray(x)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def posit_steps(n: int, a, b) -> np.ndarray:
    """Posit<n> steps between two float32 arrays of posit<n> values (n <=
    32): the distance of their patterns in two's-complement order, the
    order of the values."""
    import torch

    from repro_torch.core.posit import PositFormat, float_to_posit

    fmt = PositFormat(n)
    pa, pb = (float_to_posit(fmt, torch.from_numpy(np.array(x, np.float32)))
              for x in (a, b))
    sa = torch.where(pa >= 2 ** (n - 1), pa - 2 ** n, pa)
    sb = torch.where(pb >= 2 ** (n - 1), pb - 2 ** n, pb)
    return (sa - sb).abs().numpy()
