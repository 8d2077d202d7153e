"""Card-only tests: each hand-written kernel against its plain twin.

Marked ``cuda``; without a CUDA device they skip.  On the GPU machine run
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import math

import pytest
import torch

from repro_torch.core.posit import POSIT8, POSIT16, posit_to_float
from repro_torch.kernels import ops
from repro_torch.kernels.posit_div import KERNEL_VARIANTS, one_word_pairs
from repro_torch.kernels import posit_flash_attn as F
from repro_torch.kernels.posit_flash_attn import (
    posit_flash_attention,
    posit_flash_attention_plain,
)

pytestmark = pytest.mark.cuda
# max|K3 - twin|: the two share tiles and key order and differ only by f32
# rounding in exp and the sums, which can move a quotient by one posit16
# step (2^-11 = 4.9e-4 in [1, 2))
FLASH_TOL = 5e-4
# lse = m + log l of K6 against its twin (the reference's residual bound)
LSE_TOL = 1e-5
# K7/K8 against their twin: p is a posit16 quantization of e, and the twin's
# f32 products round in another order, so one p may move a posit16 step
# (the reference's bound between its own two backward backends)
BWD_TOL = 5e-3
SPECIALS = torch.tensor([1.5, -2.25, 0.0, -0.0, math.inf, -math.inf, math.nan, 1e30,
                         -1e-30, 3.0, 1e-45, -3e-39])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def _wide(g, *shape):
    return torch.randn(*shape, generator=g) * torch.exp(
        torch.empty(*shape).uniform_(-30, 30, generator=g))


@pytest.mark.parametrize("fmt,variant", [(f, v) for f, v, _ in one_word_pairs()],
                         ids=lambda x: str(x))
def test_rowwise_kernel_bit_exact(dev, fmt, variant):
    g = torch.Generator().manual_seed(fmt.n)
    a, b = _wide(g, 96, 257), _wide(g, 96, 1)
    a[0, :len(SPECIALS)] = SPECIALS
    b[:len(SPECIALS), 0] = SPECIALS
    a, b = a.to(dev), b.to(dev)
    k = ops.posit_div_fused_rowwise(fmt, a, b, variant)
    p = ops.posit_div_rowwise_plain(fmt, a, b, variant)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


def test_rowwise_kernel_posit8_exhaustive(dev):
    vals = torch.cat([posit_to_float(POSIT8, torch.arange(256)), SPECIALS]).to(dev)
    a, b = vals[None, :].expand(len(vals), -1).contiguous(), vals[:, None].contiguous()
    k = ops.posit_div_fused_rowwise(POSIT8, a, b)
    p = ops.posit_div_rowwise_plain(POSIT8, a, b)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_flash_kernel_decode_and_prefill(dev, variant):
    """Every posit16 plan the kernel is built for, at decode and prefill."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 1, 15, 64, generator=g).to(dev)
    k = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    pos = torch.tensor([299, 5, 100, 40], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 2, 64, 41], dtype=torch.int32, device=dev)
    kw = dict(kv_start=start, kv_len=pos + 1, q_pos=pos, variant=variant)
    o = posit_flash_attention(POSIT16, q, k, v, True, **kw)
    p = posit_flash_attention_plain(POSIT16, q, k, v, True, **kw)
    assert (o - p).abs().max() <= FLASH_TOL
    assert (o[3] == 0).all()
    q = torch.randn(2, 77, 15, 64, generator=g).to(dev)
    k, v = k[:2, :77].contiguous(), v[:2, :77].contiguous()
    kw = dict(kv_start=torch.tensor([0, 30], dtype=torch.int32, device=dev),
              variant=variant)
    o = posit_flash_attention(POSIT16, q, k, v, True, **kw)
    p = posit_flash_attention_plain(POSIT16, q, k, v, True, **kw)
    assert (o - p).abs().max() <= FLASH_TOL
    assert (o[1, :30] == 0).all()


def test_flash_kernel_refuses_what_it_is_not_built_for(dev):
    q = torch.randn(1, 1, 3, 32, device=dev)
    k = torch.randn(1, 8, 1, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        posit_flash_attention(POSIT16, q, k.float(), k.float(), True)
    with pytest.raises(NotImplementedError, match="posit16"):
        posit_flash_attention(POSIT8, q, k, k, True)


def test_launch_counters_count_kernel_launches_only(dev):
    a = torch.randn(4, 64, device=dev)
    before = ops.posit_div_fused_rowwise.launches
    ops.posit_div_rowwise_plain(POSIT16, a, a[:, :1])
    ops.posit_div_fused_rowwise(POSIT16, a, a[:, :1])
    assert ops.posit_div_fused_rowwise.launches == before + 1


def _train_inputs(dev, B=2, S=200, H=15, KV=5, hd=64, seed=3):
    """Training-shaped attention inputs: q and dO in f32 (q holds bf16
    values, as the model gives them), k/v in bf16."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(torch.bfloat16).float().to(dev)
    k = torch.randn(B, S, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, S, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    co = torch.randn(B, S, H, hd, generator=g).to(dev)
    return q, k, v, co


@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_forward_residual_kernel_matches_twin(dev, variant):
    """K6: o within FLASH_TOL and lse within LSE_TOL of its twin."""
    q, k, v, _ = _train_inputs(dev)
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, True, variant=variant)
    po, pm, pl = F.posit_flash_attention_fwd_plain(POSIT16, q, k, v, True, variant=variant)
    assert (o - po).abs().max() <= FLASH_TOL
    assert (m + torch.log(l) - pm - torch.log(pl)).abs().max() <= LSE_TOL


@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_backward_kernels_match_twin(dev, variant):
    """K7 and K8 (float32 outputs) within BWD_TOL of their twin, the same
    bits on a second run."""
    q, k, v, co = _train_inputs(dev)
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, True, variant=variant)
    plan = F.one_word_plan(POSIT16, variant)
    args = (q, k, v, co, m, l, F._row_sums(co, o), True, 0, 0, 1 / 8)
    runs = [(F.flash_backward_dq(POSIT16, plan, *args),
             *F.flash_backward_dkv(POSIT16, plan, *args)) for _ in range(2)]
    twin = F.flash_backward_plain(POSIT16, q, k.float(), v.float(), o, co, m, l, True,
                                  variant=variant)
    for got, again, want in zip(runs[0], runs[1], twin):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= BWD_TOL
        assert torch.equal(got, again)


def test_backward_fully_masked_rows_are_zero(dev):
    q, k, v, co = _train_inputs(dev, S=40)
    grads = [t.requires_grad_() for t in (q, k, v)]
    out = F.posit_flash_attention_ste(16, "srt_r4_cs_of_fr", True, 0, -40, 0.0, *grads)
    assert (out == 0).all()
    for gr in torch.autograd.grad((out * co).sum(), grads):
        assert torch.isfinite(gr).all() and (gr == 0).all()


def test_training_kernel_counters(dev):
    q, k, v, co = _train_inputs(dev, S=32)
    before = (F.posit_flash_attention.launches, F.posit_flash_attention_fwd.launches,
              F.flash_backward_dq.launches, F.flash_backward_dkv.launches)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = F.posit_flash_attention_ste(16, "srt_r4_cs_of_fr", True, 0, 0, 0.0, *leaves)
    torch.autograd.grad((out * co).sum(), leaves)
    F.flash_backward_plain(POSIT16, q.detach(), k.detach(), v.detach(), out.detach(), co,
                           *F.posit_flash_attention_fwd_plain(POSIT16, q.detach(), k.detach(),
                                                              v.detach())[1:])
    after = (F.posit_flash_attention.launches, F.posit_flash_attention_fwd.launches,
             F.flash_backward_dq.launches, F.flash_backward_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 1]
