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
from repro_torch.kernels.posit_flash_attn import (
    posit_flash_attention,
    posit_flash_attention_plain,
)

pytestmark = pytest.mark.cuda
# max|K3 - twin|: the two share tiles and key order and differ only by f32
# rounding in exp and the sums, which can move a quotient by one posit16
# step (2^-11 = 4.9e-4 in [1, 2))
FLASH_TOL = 5e-4
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
