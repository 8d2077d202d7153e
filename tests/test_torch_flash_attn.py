"""K3's plain twin (the port's flash attention on the CPU) against the
reference's posit flash-attention kernel in interpret mode.

The two scan kv tiles of different widths from different anchors (the port
anchors its 64-key tiles at each sequence's kv_start, the reference starts
min(128, round_up(Sk, 8))-key tiles at key 0), so the online-softmax
rescaling and summation order differ: outputs are held within FLASH_TOL,
about two posit16 ulps near 1, at posit16 and posit32.  Posit8 keeps at
most 3 fraction bits, so one f32 ulp of ``acc`` or ``l`` can move a
quotient a whole posit8 step (12.5% near 1): posit8 outputs are held by
their patterns, at most one step apart in at most POSIT8_FLIP_SHARE of the
elements.  The division stage alone is bit-exact against the reference's
``divide_floats_block`` on the twin's own (acc, l), in every format.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread, posit_steps, ref_kernels  # noqa: F401  (fixture)
from repro.core.posit import PositFormat as JFmt
from repro.kernels.posit_flash_attn import posit_flash_attention as jflash
from repro_torch.core.posit import PositFormat
from repro_torch.kernels.posit_flash_attn import (
    flash_scan_plain,
    minpos_eps,
    posit_flash_attention,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JD = importlib.import_module("repro.kernels.posit_div")
FLASH_TOL = 2e-3
# the share of posit8 outputs one step from the reference's, at most: a
# quotient within an f32 ulp of a posit8 rounding boundary flips (measured
# 0 over CASES on the CPU)
POSIT8_FLIP_SHARE = 0.03
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


def _both(q, k, v, kw, variant="srt_r4_cs_of_fr", n=16):
    ref = jflash(JFmt(n), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                 variant=variant,
                 **{a: jnp.asarray(np.array(x, np.int32)) for a, x in kw.items()})
    got = posit_flash_attention(PositFormat(n), torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), True, variant=variant,
                                **{a: torch.tensor(x, dtype=torch.int32)
                                   for a, x in kw.items()})
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


# posit8 and posit32 on the same cases, the default plan, and posit32's
# two-word plan (srt_r4_scaled) on the decode case
FORMAT_CASES = ([(n, "srt_r4_cs_of_fr", c) for n in (8, 32) for c in CASES]
                + [(32, "srt_r4_scaled", CASES[2])])


@pytest.mark.parametrize("n,variant,case", FORMAT_CASES,
                         ids=[f"posit{n}-{v}-{c[0]}" for n, v, c in FORMAT_CASES])
def test_twin_matches_reference_kernel_posit8_posit32(ref_kernels, n, variant, case):
    """Posit32 within FLASH_TOL of the reference's kernel; posit8 at most one
    posit8 step apart, in at most POSIT8_FLIP_SHARE of the elements."""
    name, Sq, Sk, kw = case
    B = len(next(iter(kw.values())))
    ref, got = _both(*_inputs(B, Sq, Sk), kw, variant, n)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got == 0, ref == 0)
    if n == 8:
        steps = posit_steps(8, ref, got)
        share = float((steps > 0).mean())
        print(f"posit8 {name}: {share:.4f} of the outputs one step from the reference's")
        assert steps.max() <= 1
        assert share <= POSIT8_FLIP_SHARE
        return
    err = float(np.abs(ref - got).max())
    print(f"posit{n} {variant} {name}: max|port - reference| = {err:.3g}")
    assert err <= FLASH_TOL


# posit64's other datapaths: the NRD baseline (63 non-restoring iterations
# on the two-word frame), radix-2 and radix-4 carry-save, on the decode case
POSIT64_PLANS = ["nrd", "srt_r2_cs", "srt_r4_cs"]


@pytest.mark.parametrize("variant", POSIT64_PLANS)
def test_twin_matches_reference_kernel_posit64_plans(ref_kernels, variant):
    """Posit64 at three more plans within FLASH_TOL of the reference's
    kernel, fully masked rows 0 in both."""
    name, Sq, Sk, kw = CASES[2]
    ref, got = _both(*_inputs(3, Sq, Sk), kw, variant, 64)
    err = float(np.abs(ref - got).max())
    print(f"posit64 {variant} {name}: max|port - reference| = {err:.3g}")
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert err <= FLASH_TOL


@pytest.mark.parametrize("n,variant", [(16, "srt_r4_cs_of_fr"), (64, "nrd")])
def test_twin_f32_kv_matches_reference_kernel(ref_kernels, n, variant):
    """K/V in f32, as the reference's kernel takes them (it upcasts any K/V
    to f32): values bf16 cannot hold within FLASH_TOL of the reference's;
    on bf16 K/V the twin gives the bits of the same call on their exact f32
    upcast."""
    name, Sq, Sk, kw = CASES[0]
    q, k, v = _inputs(2, Sq, Sk)
    ref, got = _both(q, k, v, kw, variant, n)
    assert float(np.abs(ref - got).max()) <= FLASH_TOL
    tkw = {a: torch.tensor(x, dtype=torch.int32) for a, x in kw.items()}
    kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    call = lambda kk, vv: posit_flash_attention(PositFormat(n), torch.from_numpy(q), kk, vv,
                                                True, variant=variant, **tkw)
    np.testing.assert_array_equal(bits(call(kb, vb)), bits(call(kb.float(), vb.float())))


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


@pytest.mark.parametrize("n,variant", [(8, "srt_r4_cs_of_fr"), (32, "srt_r4_cs_of_fr"),
                                       (32, "srt_r4_scaled")]
                         + [(64, v) for v in POSIT64_PLANS])
def test_division_stage_bit_exact_posit8_posit32(n, variant):
    """The twin's o / l is the reference's ``divide_floats_block`` on the
    twin's own (acc, l), bit for bit, at posit8 and posit32 (its two-word
    plan too), and at posit64's nrd, srt_r2_cs and srt_r4_cs: the decode
    case, one fully masked slot."""
    _, Sq, Sk, kw = CASES[2]
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, Sq, Sk))
    tkw = {a: torch.tensor(x, dtype=torch.int32) for a, x in kw.items()}
    acc, l, _ = flash_scan_plain(q, k, v, True, **tkw)
    l_safe = torch.where(l > 0, l, minpos_eps(PositFormat(n)))
    div = jax.jit(lambda a, b: JD.divide_floats_block(JFmt(n), a, b, variant))
    ref = div(jnp.asarray(acc.numpy()), jnp.asarray(l_safe[..., None].numpy()))
    got = posit_flash_attention(PositFormat(n), q, k, v, True, variant=variant, **tkw)
    np.testing.assert_array_equal(bits(np.asarray(ref).transpose(0, 2, 1, 3)), bits(got))
    assert (got[2] == 0).all()


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
