"""The training path's attention on the CPU against the reference: K6's twin
(the forward that saves the row residuals), K7/K8's twin (the recompute
backward) behind the straight-through wrapper, and the rowwise division's
straight-through gradients.

Bounds:
  * K6 ``o`` within FLASH_TOL (2e-3), the K3 twin's bound: the port's 64-key
    tiles anchored at 0 and the reference's min(128, round_up(Sk, 8))-key
    tiles rescale at other points and sum in another order;
  * ``lse = m + log l`` within LSE_TOL (1e-5), the reference's own bound for
    its residuals (tests/test_flash_attn_kernel.py);
  * gradients within _BWD_TOL (5e-3 posit16, 1e-5 posit32 and posit64), the
    reference's own bound between its two backends: ``p`` is a posit
    quantization, so a one-ulp change in ``e`` can move it one posit16 step
    (about 2^-10 relative), a posit32 or posit64 step far less; posit8 is
    held to 1e-5 against the reference's fused backward (its rounding
    boundaries are 2^8 times sparser than posit16's, so an f32 ulp of ``e``
    moves no ``p`` here) and to _POSIT8_FLOAT_BWD_TOL against its float
    backward (posit8's own rounding of ``p``);
  * the same bound at head_dim 256 with a window (posit16, posit64,
    posit8), the shape hybrid training gives K7/K8;
  * rowwise straight-through gradients within 1e-6 relative (the same f32
    formula on the same division output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, ref_kernels  # noqa: F401  (fixture)
from repro.core.posit import PositFormat as JFmt
from repro.kernels.posit_flash_attn import (
    posit_flash_attention_fwd as jfwd,
    posit_flash_attention_ste as jste,
)
from repro.numerics import posit_ops as JP
from repro_torch.core.posit import PositFormat
from repro_torch.kernels.posit_flash_attn import (
    flash_backward,
    posit_flash_attention,
    posit_flash_attention_fwd,
    posit_flash_attention_ste,
)
from repro_torch.numerics import NumericsConfig, posit_div_values

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLASH_TOL = 2e-3
LSE_TOL = 1e-5
_BWD_TOL = {8: 1e-5, 16: 5e-3, 32: 1e-5, 64: 1e-5}
# posit8 against the reference's float-softmax backward: p rounded to at
# most 3 fraction bits is up to 2^-4 from the float p, so the gradients sit
# that far from a float attention's (measured 0.23 on these inputs); the
# reference holds no posit8 case, and its posit16 bound scaled by the ratio
# of the two formats' steps (2^8) would be 1.28
_POSIT8_FLOAT_BWD_TOL = 0.5
B, H, KV, HD = 2, 4, 2, 16


def _arrays(seed, seq, kv_seq):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, seq, H, HD)).astype(np.float32)
    k = rng.normal(0, 1, (B, kv_seq, KV, HD)).astype(np.float32)
    v = rng.normal(0, 1, (B, kv_seq, KV, HD)).astype(np.float32)
    co = rng.normal(0, 1, (B, seq, H, HD)).astype(np.float32)
    return q, k, v, co


FWD_CASES = [  # (causal, window, seq)
    (True, 0, 24),
    (False, 0, 24),
    (True, 8, 24),
    (True, 0, 70),     # two of the port's key tiles
]


@pytest.mark.parametrize("causal,window,seq", FWD_CASES,
                         ids=["causal", "bidirectional", "windowed", "two_tiles"])
def test_fwd_twin_matches_reference(ref_kernels, causal, window, seq):
    q, k, v, _ = _arrays(1, seq, seq)
    o_r, m_r, l_r = jfwd(JFmt(16), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, window)
    o, m, l = posit_flash_attention_fwd(PositFormat(16), torch.from_numpy(q),
                                        torch.from_numpy(k), torch.from_numpy(v),
                                        causal, window)
    assert m.shape == l.shape == (B * H, seq)
    o_err = float(np.abs(np.asarray(o_r) - o.numpy()).max())
    lse_r = np.asarray(m_r)[:, :seq] + np.log(np.asarray(l_r)[:, :seq])
    lse_err = float(np.abs(lse_r - (m + torch.log(l)).numpy()).max())
    print(f"K6 twin: max|o - ref| {o_err:.3g}, max|lse - ref| {lse_err:.3g}")
    assert o_err <= FLASH_TOL
    assert lse_err <= LSE_TOL
    # the residual-saving forward's output is the serving forward's, bit for bit
    o3 = posit_flash_attention(PositFormat(16), torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal, window)
    assert torch.equal(o, o3)


# the reference's sweep (tests/test_flash_attn_kernel.py), plus posit8;
# posit32 srt_r4_scaled and posit64 (radix 4, and srt_r2: 63 non-redundant
# iterations) run K1's two-word frame
BWD_CASES = [  # (fmt_n, variant, causal, window, q_offset)
    (16, "srt_r4_cs_of_fr", True, 0, 0),
    (16, "srt_r4_cs_of_fr", False, 0, 0),
    (16, "srt_r4_cs_of_fr", True, 8, 0),
    (16, "srt_r4_cs_of_fr", True, 0, 16),
    (16, "srt_r2_cs_of_fr", True, 0, 0),
    (32, "srt_r4_cs_of_fr", True, 0, 0),
    (64, "srt_r4_cs_of_fr", True, 0, 0),
    (32, "srt_r4_scaled", True, 0, 0),
    (8, "srt_r4_cs_of_fr", True, 0, 0),
    (64, "srt_r2", True, 0, 0),
]
BWD_IDS = ["causal", "bidirectional", "windowed", "suffix_block", "radix2", "posit32",
           "posit64", "posit32_scaled", "posit8", "posit64_radix2"]


def _ste_grads(fmt_n, variant, causal, window, q_offset, seed, bwd_impl="fused"):
    seq = 8 if q_offset else 24
    kv_seq = q_offset + seq if q_offset else seq
    q, k, v, co = _arrays(seed, seq, kv_seq)

    def loss(q, k, v):
        out = jste(fmt_n, variant, causal, window, q_offset, 0.0, q, k, v, bwd_impl)
        return (out * jnp.asarray(co)).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = posit_flash_attention_ste(fmt_n, variant, causal, window, q_offset, 0.0, *leaves)
    got = torch.autograd.grad((out * torch.from_numpy(co)).sum(), leaves)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("fmt_n,variant,causal,window,q_offset", BWD_CASES, ids=BWD_IDS)
def test_backward_matches_reference(ref_kernels, fmt_n, variant, causal, window,
                                    q_offset):
    """The port's K6 + K7/K8 twins against the reference's fused backward."""
    _check_grads(fmt_n, *_ste_grads(fmt_n, variant, causal, window, q_offset, seed=5))


@pytest.mark.parametrize("fmt_n,variant,causal,window,q_offset", BWD_CASES, ids=BWD_IDS)
def test_backward_matches_float_reference(ref_kernels, fmt_n, variant, causal, window,
                                          q_offset):
    """The port's K6 + K7/K8 twins against the reference's other backward
    (``bwd_impl="reference"``: the gradient of a plain float attention), at
    the bound the reference holds its own two backends to."""
    _check_grads(fmt_n, *_ste_grads(fmt_n, variant, causal, window, q_offset, seed=5,
                                    bwd_impl="reference"),
                 tol=_POSIT8_FLOAT_BWD_TOL if fmt_n == 8 else None)


def _check_grads(fmt_n, ref, got, tol=None):
    tol = _BWD_TOL[fmt_n] if tol is None else tol
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        err = float(np.abs(r - g).max())
        print(f"posit{fmt_n} {name}: max|port - reference| {err:.3g}")
        assert np.isfinite(g).all(), name
        assert err <= tol, f"posit{fmt_n} {name}: {err}"


# head_dim 256 (RecurrentGemma's: 10/1 heads in the model, 2/1 here) with a
# window the rows pass (Sq 80, window 48), the case K7/K8's kBwdHdMax class
# takes on the card: (fmt_n, variant)
WIDE_BWD_CASES = [(16, "srt_r4_cs_of_fr"), (64, "srt_r4_cs_of_fr"), (8, "srt_r4_cs_of_fr")]


@pytest.mark.parametrize("fmt_n,variant", WIDE_BWD_CASES, ids=["posit16", "posit64", "posit8"])
def test_backward_head_dim_256_windowed_matches_reference(ref_kernels, fmt_n, variant):
    """The K6 + K7/K8 twins at head_dim 256 with a 48-key window over 80
    rows against the reference's fused backward, within _BWD_TOL."""
    rng = np.random.default_rng(29)
    seq, window, hd = 80, 48, 256
    q = rng.normal(0, 1, (1, seq, 2, hd)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, seq, 1, hd)).astype(np.float32) for _ in "kv")
    co = rng.normal(0, 1, (1, seq, 2, hd)).astype(np.float32)

    def loss(q, k, v):
        out = jste(fmt_n, variant, True, window, 0, 0.0, q, k, v, "fused")
        return (out * jnp.asarray(co)).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = posit_flash_attention_ste(fmt_n, variant, True, window, 0, 0.0, *leaves)
    got = torch.autograd.grad((out * torch.from_numpy(co)).sum(), leaves)
    _check_grads(fmt_n, [np.asarray(r) for r in ref], [g.numpy() for g in got])


def test_fully_masked_rows_give_zero_gradients():
    """All-masked rows (l == 0) give zero gradients, not NaN (q_offset -8
    puts every query before every key)."""
    q, k, v, _ = _arrays(3, 8, 8)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = posit_flash_attention_ste(16, "srt_r4_cs_of_fr", True, 0, -8, 0.0, *leaves)
    assert (out == 0).all()
    for g in torch.autograd.grad(out.sum(), leaves):
        assert torch.isfinite(g).all()
        assert (g == 0).all()


def test_backward_refuses_bad_residuals_and_impl():
    q, k, v, co = (torch.from_numpy(x) for x in _arrays(4, 8, 8))
    o, m, l = posit_flash_attention_fwd(PositFormat(16), q, k, v)
    with pytest.raises(ValueError, match="m and l"):
        flash_backward(PositFormat(16), q, k, v, o, co, m[:, :4], l[:, :4])
    # one backward only: the reference's A/B ``bwd_impl`` argument is not ported
    with pytest.raises(TypeError):
        posit_flash_attention_ste(16, "srt_r4_cs_of_fr", True, 0, 0, 0.0, q, k, v, "fused")
    with pytest.raises(ValueError, match="device"):
        flash_backward(PositFormat(16), *(t.to("meta") for t in (q, k, v, o, co, m, l)))


def test_rowwise_ste_gradients_match_reference(ref_kernels):
    rng = np.random.default_rng(7)
    a = rng.normal(0, 2, (6, 40)).astype(np.float32)
    b = (rng.random((6, 1)) + 0.1).astype(np.float32)
    g = rng.normal(0, 1, (6, 40)).astype(np.float32)
    out_r, vjp = jax.vjp(lambda a, b: JP._posit_div_rowwise_ste(16, "srt_r4_cs_of_fr", a, b),
                         jnp.asarray(a), jnp.asarray(b))
    ga_r, gb_r = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = posit_div_values(ta, tb, NumericsConfig())
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_r))
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    np.testing.assert_allclose(ga.numpy(), ga_r, rtol=1e-6, atol=0)
    np.testing.assert_allclose(gb.numpy(), gb_r, rtol=1e-6, atol=0)
