"""K3's plain twin (the port's flash attention on the CPU) against the
reference's posit flash-attention kernel in interpret mode.

The two scan kv tiles of different widths from different anchors (the port
anchors its 64-key tiles at each sequence's kv_start, the reference starts
min(128, round_up(Sk, 8))-key tiles at key 0), so the online-softmax
rescaling and summation order differ: outputs are held within FLASH_TOL,
about two posit16 ulps near 1.  The division stage alone is bit-exact
against the reference's ``divide_floats_block`` on the twin's own (acc, l).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, ref_kernels  # noqa: F401  (fixture)
from repro.core.posit import PositFormat as JFmt
from repro.kernels.posit_flash_attn import posit_flash_attention as jflash
from repro_torch.core.posit import PositFormat
from repro_torch.kernels.posit_flash_attn import (
    flash_scan_plain,
    minpos_eps,
    posit_flash_attention,
)

JD = importlib.import_module("repro.kernels.posit_div")
FLASH_TOL = 2e-3
RNG = np.random.default_rng(17)
H, KV, HD = 3, 1, 32

# (name, Sq, Sk, per-sequence kwargs): a causal prefill with a left pad, a
# long prefill that spans several tiles of both widths, decode slots at
# mixed positions (one fully masked: start past pos)
CASES = [
    ("prefill", 40, 40, {"kv_start": [0, 5]}),
    ("prefill_long", 150, 150, {"kv_start": [0, 21]}),
    ("decode", 1, 160, {"q_pos": [20, 159, 70], "kv_len": [21, 160, 71],
                        "kv_start": [3, 0, 71]}),
]


def _inputs(B, Sq, Sk, heads=H, kv=KV):
    q = RNG.standard_normal((B, Sq, heads, HD)).astype(np.float32)
    k = RNG.standard_normal((B, Sk, kv, HD)).astype(np.float32)
    v = RNG.standard_normal((B, Sk, kv, HD)).astype(np.float32)
    return q, k, v


def _both(q, k, v, kw, variant="srt_r4_cs_of_fr"):
    ref = jflash(JFmt(16), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                 variant=variant,
                 **{n: jnp.asarray(np.array(x, np.int32)) for n, x in kw.items()})
    got = posit_flash_attention(PositFormat(16), torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), True, variant=variant,
                                **{n: torch.tensor(x, dtype=torch.int32)
                                   for n, x in kw.items()})
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("name,Sq,Sk,kw", CASES, ids=[c[0] for c in CASES])
def test_twin_matches_reference_kernel(ref_kernels, name, Sq, Sk, kw):
    B = len(next(iter(kw.values())))
    ref, got = _both(*_inputs(B, Sq, Sk), kw)
    err = float(np.abs(ref - got).max())
    print(f"{name}: max|port - reference| = {err:.3g} (tolerance {FLASH_TOL})")
    assert err <= FLASH_TOL
    assert np.isfinite(got).all()
    # fully masked rows (prefill pads, the decode slot past its start) are 0
    np.testing.assert_array_equal(got == 0, ref == 0)


def test_window_mask(ref_kernels):
    q, k, v = _inputs(2, 40, 40)
    ref = jflash(JFmt(16), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 16)
    got = posit_flash_attention(PositFormat(16), torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), True, 16)
    assert np.abs(np.asarray(ref) - got.numpy()).max() <= FLASH_TOL


def test_gqa_and_variant(ref_kernels):
    q, k, v = _inputs(2, 24, 24, heads=4, kv=2)
    ref, got = _both(q, k, v, {"kv_start": [2, 0]}, variant="srt_r2_cs_of_fr")
    assert np.abs(ref - got).max() <= FLASH_TOL


@pytest.mark.parametrize("name,Sq,Sk,kw", CASES, ids=[c[0] for c in CASES])
def test_division_stage_bit_exact(name, Sq, Sk, kw):
    B = len(next(iter(kw.values())))
    q, k, v = (torch.from_numpy(x) for x in _inputs(B, Sq, Sk))
    tkw = {n: torch.tensor(x, dtype=torch.int32) for n, x in kw.items()}
    acc, l, _ = flash_scan_plain(q, k, v, True, **tkw)
    l_safe = torch.where(l > 0, l, minpos_eps(PositFormat(16)))
    div = jax.jit(lambda a, b: JD.divide_floats_block(JFmt(16), a, b))
    ref = div(jnp.asarray(acc.numpy()), jnp.asarray(l_safe[..., None].numpy()))
    got = posit_flash_attention(PositFormat(16), q, k, v, True, **tkw)
    np.testing.assert_array_equal(bits(np.asarray(ref).transpose(0, 2, 1, 3)), bits(got))


def test_rows_invariant_to_left_pad():
    """A sequence's rows are the same bits whatever its left-pad length:
    the kv tiles are anchored at kv_start (what serving invariance needs)."""
    S, pad = 70, 13
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, S, S))
    solo = posit_flash_attention(PositFormat(16), q, k, v, True)
    zq = lambda x: torch.cat([torch.zeros_like(x[:, :pad]), x], dim=1)
    padded = posit_flash_attention(PositFormat(16), zq(q), zq(k), zq(v), True,
                                   kv_start=torch.tensor([pad], dtype=torch.int32))
    np.testing.assert_array_equal(bits(padded[:, pad:]), bits(solo))
    assert (padded[:, :pad] == 0).all()


def test_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 4))
    with pytest.raises(ValueError, match="incompatible"):
        posit_flash_attention(PositFormat(16), q, k[:1], v[:1])
    with pytest.raises(ValueError, match="per-sequence"):
        posit_flash_attention(PositFormat(16), q, k, v, kv_start=torch.zeros(3))
    with pytest.raises(ValueError, match="device"):
        posit_flash_attention(PositFormat(16), q.to("meta"), k.to("meta"), v.to("meta"))
