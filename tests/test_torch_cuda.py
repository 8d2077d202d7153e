"""Card-only tests: each hand-written kernel against its plain twin.

Marked ``cuda``; without a CUDA device they skip.  On the GPU machine run
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import math

import pytest
import torch

from repro_torch.core.posit import (
    POSIT8,
    POSIT16,
    POSIT32,
    POSIT64,
    PositFormat,
    posit_to_float,
)
from repro_torch.kernels import ops
from repro_torch.kernels.posit_div import KERNEL_VARIANTS, one_word_pairs, planned_pairs
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
# posit8 keeps at most 3 fraction bits: one f32 ulp between a kernel and its
# twin (expf against torch.exp, FMA contraction) moves a quotient a whole
# posit8 step (12.5% near 1) where it sits at a rounding boundary, so posit8
# outputs are held by their patterns: at most one step apart, in at most
# POSIT8_FLIP_SHARE of the elements; posit8 gradients within BWD_TOL of the
# twin's in all but that share, and within POSIT8_BWD_TOL everywhere (one
# posit8 step of one p, 2^-4, times the |dO|, |dp - D| and |q|, |k| it
# meets)
POSIT8_FLIP_SHARE = 0.01
POSIT8_BWD_TOL = 0.5
# every posit8 and posit32 (format, variant): K3-K9 are built for each
NEW_PLANS = [(f, v) for f in (POSIT8, POSIT32) for v in KERNEL_VARIANTS]
# posit64's eight (its six datapaths): K3-K9 are built for each
POSIT64_PLANS = [(f, v) for f, v, _ in planned_pairs((POSIT64,))]
SPECIALS = torch.tensor([1.5, -2.25, 0.0, -0.0, math.inf, -math.inf, math.nan, 1e30,
                         -1e-30, 3.0, 1e-45, -3e-39])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpret mode)")
    return torch.device("cuda")


def bits(t):
    return t.contiguous().view(torch.int32)


def _steps8(a, b):
    """Posit8 steps between two tensors of posit8 values."""
    from repro_torch.core.posit import float_to_posit

    pa, pb = (float_to_posit(POSIT8, t.float().cpu()) for t in (a, b))
    sa = torch.where(pa >= 128, pa - 256, pa)
    sb = torch.where(pb >= 128, pb - 256, pb)
    return (sa - sb).abs()


def _close(fmt, got, want, tol=FLASH_TOL):
    """``got`` against its twin's ``want``: within ``tol``, or at posit8 at
    most one posit8 step apart in at most POSIT8_FLIP_SHARE of the elements."""
    assert torch.isfinite(got).all()
    if fmt.n != 8:
        assert (got - want).abs().max() <= tol
        return
    steps = _steps8(got, want)
    assert steps.max() <= 1
    assert (steps > 0).float().mean() <= POSIT8_FLIP_SHARE


def _close_grad(fmt, got, want):
    """K7/K8's float32 gradients against their twin's (see POSIT8_BWD_TOL)."""
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    if fmt.n != 8:
        assert err.max() <= BWD_TOL
        return
    assert err.max() <= POSIT8_BWD_TOL
    assert (err > BWD_TOL).float().mean() <= POSIT8_FLIP_SHARE


def _wide(g, *shape):
    return torch.randn(*shape, generator=g) * torch.exp(
        torch.empty(*shape).uniform_(-30, 30, generator=g))


@pytest.mark.parametrize("fmt,variant", [(f, v) for f, v, _ in planned_pairs()],
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


@pytest.mark.parametrize("R,C", [(8, 2048), (1, 2048)])
def test_rowwise_kernel_olmoe_rmsnorm_rows(dev, R, C):
    g = torch.Generator().manual_seed(R)
    a, b = torch.randn(R, C, generator=g), torch.rand(R, 1, generator=g) + 0.01
    a, b = a.to(dev), b.to(dev)
    k = ops.posit_div_fused_rowwise(POSIT16, a, b)
    p = ops.posit_div_rowwise_plain(POSIT16, a, b)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("R,C", [(8, 2560), (8, 5120), (4096, 5120)])
def test_rowwise_kernel_mamba2_rows(dev, R, C):
    """Mamba2-2.7B's K2 calls: the block and final RMSNorms at d_model 2560,
    the gated norm at d_inner 5120 (40 column tiles), a decode step's 8
    rows and a 4096-token forward's."""
    g = torch.Generator().manual_seed(C + R)
    a, b = torch.randn(R, C, generator=g), torch.rand(R, 1, generator=g) + 0.01
    a, b = a.to(dev), b.to(dev)
    k = ops.posit_div_fused_rowwise(POSIT16, a, b)
    p = ops.posit_div_rowwise_plain(POSIT16, a, b)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("R", [8, 1])
def test_rowwise_kernel_router_norm_rows(dev, R):
    """The router norm's K2 call: top-8 gates over their fixed-order sum."""
    from repro_torch.core.quire import fixed_order_rowsum

    gates = (torch.rand(R, 8, generator=torch.Generator().manual_seed(R)) * 0.1).to(dev)
    k = ops.posit_div_fused_rowwise(POSIT16, gates, fixed_order_rowsum(gates))
    p = ops.posit_div_rowwise_plain(POSIT16, gates, fixed_order_rowsum(gates))
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
    _check_decode_and_prefill(dev, POSIT16, variant)


def _check_decode_and_prefill(dev, fmt, variant):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 1, 15, 64, generator=g).to(dev)
    k = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    pos = torch.tensor([299, 5, 100, 40], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 2, 64, 41], dtype=torch.int32, device=dev)
    kw = dict(kv_start=start, kv_len=pos + 1, q_pos=pos, variant=variant)
    o = posit_flash_attention(fmt, q, k, v, True, **kw)
    _close(fmt, o, posit_flash_attention_plain(fmt, q, k, v, True, **kw))
    assert (o[3] == 0).all()
    q = torch.randn(2, 77, 15, 64, generator=g).to(dev)
    k, v = k[:2, :77].contiguous(), v[:2, :77].contiguous()
    kw = dict(kv_start=torch.tensor([0, 30], dtype=torch.int32, device=dev),
              variant=variant)
    o = posit_flash_attention(fmt, q, k, v, True, **kw)
    _close(fmt, o, posit_flash_attention_plain(fmt, q, k, v, True, **kw))
    assert (o[1, :30] == 0).all()


def test_flash_kernel_refuses_what_it_is_not_built_for(dev):
    """What stays refused: head_dim past 128 in a decode call (past 256 in
    a prefill: the tile loop takes up to 256 since the hybrid family),
    posit10 (only K11 divides it) and a float64 k/v (it would have to be
    rounded)."""
    q = torch.randn(1, 1, 3, 32, device=dev)
    k = torch.randn(1, 8, 1, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float64"):
        posit_flash_attention(POSIT16, q, k.double(), k.double(), True)
    with pytest.raises(NotImplementedError, match="posit10"):
        posit_flash_attention(PositFormat(10), q, k, k, True)
    with pytest.raises(NotImplementedError, match="paged"):
        posit_flash_attention(PositFormat(10), q, k, k, True,
                              block_tables=torch.zeros(1, 1, dtype=torch.int32, device=dev))
    wide = torch.randn(1, 1, 1, 256, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        posit_flash_attention(POSIT64, wide, wide.bfloat16(), wide.bfloat16(), True,
                              variant="nrd", q_pos=pos, kv_len=pos + 1)
    wider = torch.randn(1, 1, 1, 264, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        posit_flash_attention(POSIT64, wider, wider.bfloat16(), wider.bfloat16(), True,
                              variant="nrd")
    with pytest.raises(NotImplementedError, match="posit10"):
        ops.posit_softmax_fused(PositFormat(10), q[0, 0])


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
    plan = F.datapath_plan(POSIT16, variant)
    args = (q, k, v, co, m, l, F._row_sums(co, o), True, 0, 0, 1 / 8)
    runs = [(F.flash_backward_dq(POSIT16, plan, *args),
             *F.flash_backward_dkv(POSIT16, plan, *args)) for _ in range(2)]
    twin = F.flash_backward_plain(POSIT16, q, k.float(), v.float(), o, co, m, l, True,
                                  variant=variant)
    for got, again, want in zip(runs[0], runs[1], twin):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= BWD_TOL
        assert torch.equal(got, again)


def test_training_kernels_posit64_match_twin(dev):
    """K6, K7 and K8 at posit64 srt_r4_cs_of_fr (p = e / l on the two-word
    frame): o within FLASH_TOL, lse within LSE_TOL, dq / dk / dv within
    BWD_TOL of their twin (a posit64 p moves by f32 steps, not posit16
    ones), the same bits on a second run."""
    q, k, v, co = _train_inputs(dev)
    o, m, l = F.posit_flash_attention_fwd(POSIT64, q, k, v, True)
    po, pm, pl = F.posit_flash_attention_fwd_plain(POSIT64, q, k, v, True)
    assert (o - po).abs().max() <= FLASH_TOL
    assert (m + torch.log(l) - pm - torch.log(pl)).abs().max() <= LSE_TOL
    plan = F.datapath_plan(POSIT64, "srt_r4_cs_of_fr")
    args = (q, k, v, co, m, l, F._row_sums(co, o), True, 0, 0, 1 / 8)
    runs = [(F.flash_backward_dq(POSIT64, plan, *args),
             *F.flash_backward_dkv(POSIT64, plan, *args)) for _ in range(2)]
    twin = F.flash_backward_plain(POSIT64, q, k.float(), v.float(), o, co, m, l, True)
    for got, again, want in zip(runs[0], runs[1], twin):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= BWD_TOL
        assert torch.equal(got, again)


def test_train_step_posit64_matches_cpu(dev):
    """One train step of the smoke config at posit64 on the card (K2, K6-K8
    at W = 2) against the same f32 weights and batch on the CPU (the twins):
    loss within 1e-3 relative, every gradient leaf within 2e-2 relative L2
    (bf16 products round in other orders; the CPU tests' bounds)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.train.trainer import TrainConfig, init_train_state, loss_and_grads

    cfg = get_config("smollm_360m", smoke=True).with_numerics(div_format="posit64")
    cpu = init_train_state(cfg, TrainConfig(steps=1), device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    batch = SyntheticLMDataset(DataConfig(2, 64), cfg).batch_at(0)
    out = []
    for state, d in ((cpu, "cpu"), (gpu, dev)):
        b = {n: torch.from_numpy(np.asarray(x)).to(d) for n, x in batch.items()}
        (loss, _), grads = loss_and_grads(state["params"], cfg, b)
        out.append((float(loss), tree_leaves(grads)))
    (c_loss, c_grads), (g_loss, g_grads) = out
    assert abs(g_loss - c_loss) <= 1e-3 * abs(c_loss)
    for g, c in zip(g_grads, c_grads):
        g = g.cpu()
        assert torch.isfinite(g).all()
        assert torch.linalg.vector_norm(g - c) <= 2e-2 * torch.linalg.vector_norm(c)


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


def _paged_case(dev, B=4, bs=16, max_blocks=8, H=15, KV=5, hd=64, seed=5):
    """Block pools with a shuffled table: sequences 0 and 1 share their
    first two pages, the last sequence is parked (an all-zero row)."""
    g = torch.Generator().manual_seed(seed)
    NB = B * max_blocks + 1
    pool_k = torch.randn(NB, bs, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    pool_v = torch.randn(NB, bs, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    bt = (1 + torch.randperm(NB - 1, generator=g)[:B * max_blocks]).reshape(B, max_blocks)
    bt[1, :2] = bt[0, :2]
    bt[-1] = 0
    q = torch.randn(B, 1, H, hd, generator=g).to(dev)
    return q, pool_k, pool_v, bt.to(torch.int32).to(dev)


@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_paged_kernel_is_dense_kernel_on_gathered_cache(dev, variant):
    """K4 gives K3's bits on the gathered dense cache, within FLASH_TOL of
    its twin, for kv_start 0 (paged admission) and above (left pads)."""
    _check_paged(dev, POSIT16, variant)


def test_paged_kernel_posit64_is_dense_kernel_on_gathered_cache(dev):
    """K4 at posit64 srt_r4_cs_of_fr (o / l on the two-word frame): K3's
    posit64 bits on the gathered cache, within FLASH_TOL of its twin."""
    _check_paged(dev, POSIT64, "srt_r4_cs_of_fr")


def _check_paged(dev, fmt, variant):
    q, pk, pv, bt = _paged_case(dev)
    pos = torch.tensor([127, 40, 77, 60], dtype=torch.int32, device=dev)
    k, v = F.gather_pages(pk, bt), F.gather_pages(pv, bt)
    for start in ([0, 0, 0, 0], [5, 0, 70, 61]):
        kw = dict(kv_start=torch.tensor(start, dtype=torch.int32, device=dev),
                  kv_len=pos + 1, q_pos=pos, variant=variant)
        o = posit_flash_attention(fmt, q, pk, pv, True, block_tables=bt, **kw)
        d = posit_flash_attention(fmt, q, k, v, True, **kw)
        p = posit_flash_attention_plain(fmt, q, pk, pv, True, block_tables=bt, **kw)
        assert torch.equal(o.view(torch.int32), d.view(torch.int32))
        _close(fmt, o, p)
    assert (o[3] == 0).all()


def _packed_case(dev, N, P, left=True, H=15, KV=5, hd=64, seed=6):
    """A pack of N segments of width P, left-padded (the dense layout) or
    right-padded (the paged layout): segment 0 a dummy when N > 2, the next
    two of one length, the second repeating the first one's first half."""
    g = torch.Generator().manual_seed(seed)
    S = N * P
    q = torch.randn(1, S, H, hd, generator=g)
    k = torch.randn(1, S, KV, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(1, S, KV, hd, generator=g).to(torch.bfloat16)
    d = int(N > 2)
    lens = [0] * d + [P - (3 * i) % P for i in range(1, N + 1 - d)]
    lens[d + 1] = lens[d]
    seg = torch.full((1, S), -1, dtype=torch.int32)
    offs = [i * P + (P - n if left else 0) for i, n in enumerate(lens)]
    for off, n, i in zip(offs, lens, range(N)):
        seg[0, off:off + n] = i
    half = lens[d] // 2
    for t in (q, k, v):
        t[:, offs[d + 1]:offs[d + 1] + half] = t[:, offs[d]:offs[d] + half]
    seg_q = torch.where(seg < 0, torch.full_like(seg, -2), seg)
    return [t.to(dev) for t in (q, k, v, seg_q, seg)] + [lens, offs]


# the first two as the dense layout packs them; the rest as the paged
# serving path packs them (right-padded, from 128 keys up several kv tiles
# per segment)
@pytest.mark.parametrize("N,P,left", [
    pytest.param(4, 64, True, id="4-64"), pytest.param(8, 8, True, id="8-8"),
    pytest.param(4, 128, True, id="4-128"), pytest.param(4, 128, False, id="4-128-right"),
    pytest.param(2, 256, False, id="2-256-right"), pytest.param(4, 256, True, id="4-256"),
    pytest.param(4, 256, False, id="4-256-right"),
    pytest.param(8, 16, False, id="8-16-right")])
def test_packed_kernel_segments_are_solo_kernel(dev, N, P, left):
    """K5: each segment's rows are the bits of a solo K3 prefill of it, the
    dummy segment's and the pads' rows 0, all within FLASH_TOL of the twin."""
    _check_packed(dev, POSIT16, N, P, left)


@pytest.mark.parametrize("N,P,left", [
    pytest.param(4, 64, True, id="4-64"), pytest.param(4, 128, False, id="4-128-right"),
    pytest.param(8, 16, False, id="8-16-right"), pytest.param(2, 256, False, id="2-256-right")])
def test_packed_kernel_posit64_segments_are_solo_kernel(dev, N, P, left):
    """K5 at posit64 srt_r4_cs_of_fr: each segment the bits of a solo posit64
    K3 prefill, within FLASH_TOL of the twin."""
    _check_packed(dev, POSIT64, N, P, left)


def _check_packed(dev, fmt, N, P, left, variant="srt_r4_cs_of_fr"):
    q, k, v, seg_q, seg, lens, offs = _packed_case(dev, N, P, left)
    kw = dict(seg_q=seg_q, seg_kv=seg, seg_len=P, variant=variant)
    o = posit_flash_attention(fmt, q, k, v, True, **kw)
    p = posit_flash_attention_plain(fmt, q, k, v, True, seg_q=seg_q, seg_kv=seg,
                                    variant=variant)
    _close(fmt, o, p)
    assert (o[0][seg_q[0] < 0] == 0).all()
    for i, (off, n) in enumerate(zip(offs, lens)):
        if not n:
            continue
        # solo: the left-padded bucket from its first key (a dense admission),
        # or the unpadded prompt (a paged admission)
        w = slice(i * P, (i + 1) * P) if left else slice(off, off + n)
        start = torch.tensor([P - n if left else 0], dtype=torch.int32, device=dev)
        solo = posit_flash_attention(fmt, q[:, w], k[:, w], v[:, w], True, kv_start=start,
                                     variant=variant)
        rows = slice(P - n, P) if left else slice(0, n)
        assert torch.equal(o[:, off:off + n].view(torch.int32), solo[:, rows].view(torch.int32))


@pytest.mark.parametrize("fmt,variant", NEW_PLANS, ids=lambda x: str(x))
def test_flash_kernel_posit8_posit32(dev, fmt, variant):
    """K3 at every posit8 and posit32 plan (posit32 srt_r4_scaled on the
    two-word frame), decode and prefill, against its twin."""
    _check_decode_and_prefill(dev, fmt, variant)


@pytest.mark.parametrize("fmt,variant", NEW_PLANS, ids=lambda x: str(x))
def test_paged_kernel_posit8_posit32_is_dense_kernel(dev, fmt, variant):
    """K4 at every posit8 and posit32 plan: K3's bits on the gathered cache."""
    _check_paged(dev, fmt, variant)


@pytest.mark.parametrize("fmt,variant", NEW_PLANS, ids=lambda x: str(x))
def test_packed_kernel_posit8_posit32_segments_are_solo_kernel(dev, fmt, variant):
    """K5 at every posit8 and posit32 plan: each segment the bits of a solo
    K3 prefill (a right-padded pack of 4 x 128, as the paged path packs)."""
    _check_packed(dev, fmt, 4, 128, False, variant)


@pytest.mark.parametrize("fmt,variant", NEW_PLANS, ids=lambda x: str(x))
def test_training_kernels_posit8_posit32_match_twin(dev, fmt, variant):
    """K6, K7 and K8 at every posit8 and posit32 plan against their twins,
    the same bits on a second run."""
    _check_training(dev, fmt, variant)


def _check_training(dev, fmt, variant):
    q, k, v, co = _train_inputs(dev)
    o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, variant=variant)
    po, pm, pl = F.posit_flash_attention_fwd_plain(fmt, q, k, v, True, variant=variant)
    _close(fmt, o, po)
    assert (m + torch.log(l) - pm - torch.log(pl)).abs().max() <= LSE_TOL
    plan = F.datapath_plan(fmt, variant)
    args = (q, k, v, co, m, l, F._row_sums(co, o), True, 0, 0, 1 / 8)
    runs = [(F.flash_backward_dq(fmt, plan, *args),
             *F.flash_backward_dkv(fmt, plan, *args)) for _ in range(2)]
    twin = F.flash_backward_plain(fmt, q, k.float(), v.float(), o, co, m, l, True,
                                  variant=variant)
    for got, again, want in zip(runs[0], runs[1], twin):
        _close_grad(fmt, got, want)
        assert torch.equal(got, again)


@pytest.mark.parametrize("fmt,variant", NEW_PLANS, ids=lambda x: str(x))
def test_softmax_kernel_posit8_posit32(dev, fmt, variant):
    """K9 at every posit8 and posit32 plan: the twin's bits, the NaN row
    kept to itself."""
    x = _softmax_case(37, 200, fmt.n).to(dev)
    o = ops.posit_softmax_fused(fmt, x, variant)
    p = ops.posit_softmax_plain(fmt, x, variant)
    assert torch.equal(o.view(torch.int32), p.view(torch.int32))
    assert torch.isnan(o).any(-1).cpu().tolist() == [i == 2 for i in range(37)]


@pytest.mark.parametrize("fmt,variant", POSIT64_PLANS, ids=lambda x: str(x))
def test_flash_kernel_posit64_every_plan(dev, fmt, variant):
    """K3 at each posit64 plan (its six datapaths on K1's two-word frame),
    decode and prefill, against its twin."""
    _check_decode_and_prefill(dev, fmt, variant)


@pytest.mark.parametrize("fmt,variant", POSIT64_PLANS, ids=lambda x: str(x))
def test_paged_kernel_posit64_every_plan_is_dense_kernel(dev, fmt, variant):
    """K4 at each posit64 plan: K3's bits on the gathered cache."""
    _check_paged(dev, fmt, variant)


@pytest.mark.parametrize("fmt,variant", POSIT64_PLANS, ids=lambda x: str(x))
def test_packed_kernel_posit64_every_plan_segments_are_solo_kernel(dev, fmt, variant):
    """K5 at each posit64 plan: each segment the bits of a solo K3 prefill."""
    _check_packed(dev, fmt, 4, 128, False, variant)


@pytest.mark.parametrize("fmt,variant", POSIT64_PLANS, ids=lambda x: str(x))
def test_training_kernels_posit64_every_plan_match_twin(dev, fmt, variant):
    """K6, K7 and K8 at each posit64 plan against their twins, the same
    bits on a second run."""
    _check_training(dev, fmt, variant)


@pytest.mark.parametrize("fmt,variant", POSIT64_PLANS, ids=lambda x: str(x))
def test_softmax_kernel_posit64_every_plan(dev, fmt, variant):
    """K9 at each posit64 plan: the twin's bits, the NaN row kept to
    itself."""
    x = _softmax_case(37, 200, fmt.n).to(dev)
    o = ops.posit_softmax_fused(fmt, x, variant)
    p = ops.posit_softmax_plain(fmt, x, variant)
    assert torch.equal(o.view(torch.int32), p.view(torch.int32))
    assert torch.isnan(o).any(-1).cpu().tolist() == [i == 2 for i in range(37)]


# f32 K/V: posit16's default plan and posit64 nrd (the longest datapath)
F32_KV_PLANS = [(POSIT16, "srt_r4_cs_of_fr"), (POSIT64, "nrd")]


def _f32_twin(t, g):
    """An f32 tensor of ``t``'s shape whose values bf16 cannot hold: ``t``
    plus a perturbation below bf16's step."""
    return (t.float() + torch.randn(t.shape, generator=g).to(t.device) * 2 ** -12).contiguous()


@pytest.mark.parametrize("fmt,variant", F32_KV_PLANS, ids=lambda x: str(x))
def test_flash_kernels_f32_kv(dev, fmt, variant):
    """K3 (decode, prefill), K4 and K5 read f32 K/V: on bf16-representable
    f32 values the bits of the bf16 call (the upcast is exact), f16 the
    bits of its f32 upcast, and on values bf16 cannot hold within FLASH_TOL
    of the twin."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn(4, 1, 15, 64, generator=g).to(dev)
    k = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    pos = torch.tensor([299, 5, 100, 40], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 2, 64, 41], dtype=torch.int32, device=dev)
    qp, pk, pv, bt = _paged_case(dev)
    ppos = torch.tensor([127, 40, 77, 60], dtype=torch.int32, device=dev)
    pq, sk, sv, seg_q, seg, _, _ = _packed_case(dev, 4, 128, False)
    calls = [  # (q, k, v, kwargs)
        (q, k, v, dict(kv_start=start, kv_len=pos + 1, q_pos=pos)),
        (torch.randn(2, 77, 15, 64, generator=g).to(dev), k[:2, :77].contiguous(),
         v[:2, :77].contiguous(), dict(kv_start=start[:2])),
        (qp, pk, pv, dict(kv_len=ppos + 1, q_pos=ppos, block_tables=bt)),
        (pq, sk, sv, dict(seg_q=seg_q, seg_kv=seg, seg_len=128)),
    ]
    for q_, k_, v_, kw in calls:
        kw = dict(kw, variant=variant)
        ref = posit_flash_attention(fmt, q_, k_, v_, True, **kw)
        got = posit_flash_attention(fmt, q_, k_.float(), v_.float(), True, **kw)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        kf, vf = _f32_twin(k_, g), _f32_twin(v_, g)
        got = posit_flash_attention(fmt, q_, kf, vf, True, **kw)
        plain_kw = {a: t for a, t in kw.items() if a != "seg_len"}
        _close(fmt, got, posit_flash_attention_plain(fmt, q_, kf, vf, True, **plain_kw))
        half = posit_flash_attention(fmt, q_, k_.half(), v_.half(), True, **kw)
        up = posit_flash_attention(fmt, q_, k_.half().float(), v_.half().float(), True, **kw)
        assert torch.equal(half.view(torch.int32), up.view(torch.int32))


@pytest.mark.parametrize("fmt,variant", F32_KV_PLANS, ids=lambda x: str(x))
def test_training_kernels_f32_kv(dev, fmt, variant):
    """K6, K7 and K8 on f32 K/V: the bf16 call's bits on bf16-representable
    values; within their bounds of the twin on values bf16 cannot hold,
    the same bits on a second run; dk / dv come back in K/V's dtype."""
    q, k, v, co = _train_inputs(dev)
    plan = F.datapath_plan(fmt, variant)

    def run(k_, v_):
        o, m, l = F.posit_flash_attention_fwd(fmt, q, k_, v_, True, variant=variant)
        args = (q, k_, v_, co, m, l, F._row_sums(co, o), True, 0, 0, 1 / 8)
        return (o, m, l, F.flash_backward_dq(fmt, plan, *args),
                *F.flash_backward_dkv(fmt, plan, *args))

    for a, b in zip(run(k, v), run(k.float(), v.float())):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    g = torch.Generator().manual_seed(10)
    kf, vf = _f32_twin(k, g), _f32_twin(v, g)
    got, again = run(kf, vf), run(kf, vf)
    po, pm, pl = F.posit_flash_attention_fwd_plain(fmt, q, kf, vf, True, variant=variant)
    _close(fmt, got[0], po)
    assert (got[1] + torch.log(got[2]) - pm - torch.log(pl)).abs().max() <= LSE_TOL
    twin = F.flash_backward_plain(fmt, q, kf, vf, got[0], co, got[1], got[2], True,
                                  variant=variant)
    for a, b, want in zip(got[3:], again[3:], twin):
        _close_grad(fmt, a, want)
        assert torch.equal(a, b)
    grads = F.flash_backward(fmt, q, kf, vf, got[0], co, got[1], got[2], True,
                             variant=variant)
    assert [t.dtype for t in grads] == [torch.float32] * 3


@pytest.mark.parametrize("fmt", [POSIT8, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
def test_model_kernels_one_answer_per_format(dev, fmt):
    """The Table IV variants divide exactly, so within a format K3 (dense,
    paged), K6, K7, K8 and K9 give one answer for all its plans (nine;
    posit64 eight), bit for bit."""
    q, k, v, co = _train_inputs(dev, S=96)
    qp, pk, pv, bt = _paged_case(dev)
    pos = torch.tensor([127, 40, 77, 60], dtype=torch.int32, device=dev)
    x = _softmax_case(37, 200, fmt.n).to(dev)
    outs = {}
    for _, variant, plan in planned_pairs((fmt,)):
        o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, variant=variant)
        args = (q, k, v, co, m, l, F._row_sums(co, o), True, 0, 0, 1 / 8)
        outs[variant] = [
            posit_flash_attention(fmt, q, k, v, True, variant=variant), o, m, l,
            F.flash_backward_dq(fmt, plan, *args), *F.flash_backward_dkv(fmt, plan, *args),
            posit_flash_attention(fmt, qp, pk, pv, True, block_tables=bt, kv_len=pos + 1,
                                  q_pos=pos, variant=variant),
            ops.posit_softmax_fused(fmt, x, variant)]
    first = next(iter(outs.values()))
    for variant, got in outs.items():
        for a, b in zip(got, first):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), variant


def test_layout_counters_are_apart(dev):
    q, pk, pv, bt = _paged_case(dev)
    before = (F.posit_flash_attention.launches, F.posit_flash_attention.paged_launches,
              F.posit_flash_attention.packed_launches)
    posit_flash_attention(POSIT16, q, pk, pv, True, block_tables=bt)
    qq, k, v, seg_q, seg, _, _ = _packed_case(dev, 4, 8)
    posit_flash_attention(POSIT16, qq, k, v, True, seg_q=seg_q, seg_kv=seg, seg_len=8)
    posit_flash_attention_plain(POSIT16, q, pk, pv, True, block_tables=bt)
    after = (F.posit_flash_attention.launches, F.posit_flash_attention.paged_launches,
             F.posit_flash_attention.packed_launches)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1]


def _softmax_case(R, C, seed=0):
    """Logits with, from three rows up, -1e30 entries (row 0), equal values
    (row 1) and a NaN (row 2)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(R, C, generator=g) * 2
    if R >= 3:
        x[0, ::3] = -1e30
        x[1] = 0.75
        x[2, 5] = math.nan
    return x


@pytest.mark.parametrize("R,C", [(8, 64), (1, 64), (4096, 64), (37, 1000)])
def test_softmax_kernel_matches_twin(dev, R, C):
    """K9 at the router's shapes and wider: the twin's bits (both call CUDA's
    expf and sum each row left to right), the NaN row kept to itself, a row
    of equal values uniform."""
    x = _softmax_case(R, C).to(dev)
    o = ops.posit_softmax_fused(POSIT16, x)
    p = ops.posit_softmax_plain(POSIT16, x)
    assert torch.equal(o.view(torch.int32), p.view(torch.int32))
    nan_rows = torch.isnan(o).any(-1).cpu()
    assert nan_rows.tolist() == [i == 2 for i in range(R)]
    if R >= 3:
        assert (o[1] == o[1, 0]).all()
        assert (o[0, ::3] == 0).all()


@pytest.mark.parametrize("R,C", [(8, 64), (1, 64), (4096, 64), (37, 1000)])
def test_softmax_kernel_posit64_matches_twin(dev, R, C):
    """K9 at posit64 srt_r4_cs_of_fr (the two-word divisor per lane): the
    twin's bits, the NaN row kept to itself."""
    x = _softmax_case(R, C, 64).to(dev)
    o = ops.posit_softmax_fused(POSIT64, x)
    p = ops.posit_softmax_plain(POSIT64, x)
    assert torch.equal(o.view(torch.int32), p.view(torch.int32))
    assert torch.isnan(o).any(-1).cpu().tolist() == [i == 2 for i in range(R)]


@pytest.mark.parametrize("variant", KERNEL_VARIANTS)
def test_softmax_kernel_every_plan(dev, variant):
    x = _softmax_case(37, 200, 1).to(dev)
    o = ops.posit_softmax_fused(POSIT16, x, variant)
    p = ops.posit_softmax_plain(POSIT16, x, variant)
    assert torch.equal(o.view(torch.int32), p.view(torch.int32))


def test_softmax_kernel_refuses_and_counts(dev):
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(NotImplementedError, match="posit10 srt_r4_cs"):
        ops.posit_softmax_fused(PositFormat(10), x, "srt_r4_cs")
    before = ops.posit_softmax_fused.launches
    ops.posit_softmax_plain(POSIT16, x)
    ops.posit_softmax_fused(POSIT16, x)
    assert ops.posit_softmax_fused.launches == before + 1


# K9's geometries: one thread per column up to 1024 columns (a row over
# several warps, several rows to a block), a strided loop past that, up to
# the widest row it takes (None: posit_softmax_max_cols())
SOFTMAX_COLS = (1, 31, 33, 1023, 1025, None)


@pytest.mark.parametrize("R", [1, 5, 4097])
@pytest.mark.parametrize("C", SOFTMAX_COLS, ids=lambda c: "max_cols" if c is None else str(c))
def test_softmax_kernel_geometries(dev, R, C):
    """K9 from one column to its widest row, at 1, 5 and 4097 rows: the
    twin's bits (compared in row chunks: rows are independent), a NaN row
    kept to itself, -1e30 entries beside larger ones 0."""
    if C is None:
        C = ops._softmax_fn()[1]
    g = torch.Generator(device=dev).manual_seed(R + C)
    x = torch.randn(R, C, generator=g, device=dev) * 2
    if R >= 3:
        x[0, ::3] = -1e30
        x[1] = 0.75
        x[2, C // 2] = math.nan
    o = ops.posit_softmax_fused(POSIT16, x)
    chunk = max(1, (1 << 24) // C)
    for r in range(0, R, chunk):
        p = ops.posit_softmax_plain(POSIT16, x[r:r + chunk])
        assert torch.equal(bits(o[r:r + chunk]), bits(p)), r
    assert torch.isnan(o).any(-1).cpu().tolist() == [i == 2 for i in range(R)]
    if R >= 3 and C > 1:   # one column of -1e30 is its own row max
        assert (o[0, ::3] == 0).all()


def test_softmax_kernel_refuses_wider_rows(dev):
    widest = ops._softmax_fn()[1]
    assert widest >= 14848
    with pytest.raises(ValueError, match="at most"):
        ops.posit_softmax_fused(POSIT16, torch.zeros(1, widest + 1, device=dev))


# K8's geometries, (B, Sq, Sk, H, KV, hd, causal, window, q_offset): head_dim
# 30 (4-byte tile copies), 40, 64 and 128 (zero-padded to the MMA depth of
# 8); G = 1, 3 and 8; Sk off the 64-key tile; Sq < Sk with q_offset > 0; a
# window, with and without the causal mask; non-causal
DKV_CASES = {
    "hd30": (2, 70, 70, 6, 2, 30, True, 0, 0),
    "hd40": (2, 100, 100, 6, 2, 40, True, 0, 0),
    "hd64_G3": (2, 130, 130, 6, 2, 64, True, 0, 0),
    "hd128_G1": (1, 96, 96, 4, 4, 128, True, 0, 0),
    "G8": (1, 80, 80, 8, 1, 64, True, 0, 0),
    "Sk200": (1, 200, 200, 3, 1, 64, True, 0, 0),
    "q_offset": (2, 40, 150, 6, 2, 64, True, 0, 110),
    "window": (2, 160, 160, 6, 2, 64, True, 48, 0),
    "window_non_causal": (1, 100, 100, 4, 2, 64, False, 40, 0),
    "non_causal": (2, 90, 120, 6, 2, 64, False, 0, 0),
}


@pytest.mark.parametrize("case", list(DKV_CASES))
def test_dkv_kernel_geometries_match_twin(dev, case):
    """K8 (and K7 beside it) at each geometry: within BWD_TOL of the twin,
    the same bits on a second run, and on f32 K/V holding bf16 values the
    bf16 call's bits."""
    B, Sq, Sk, H, KV, hd, causal, window, q_offset = DKV_CASES[case]
    g = torch.Generator().manual_seed(hd + Sk)
    q = torch.randn(B, Sq, H, hd, generator=g).to(torch.bfloat16).float().to(dev)
    k = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    co = torch.randn(B, Sq, H, hd, generator=g).to(dev)
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, causal, window, q_offset)
    assert bool((l > 0).all())
    plan = F.datapath_plan(POSIT16, "srt_r4_cs_of_fr")
    scale = 1 / math.sqrt(hd)
    args = lambda k_, v_: (q, k_, v_, co, m, l, F._row_sums(co, o), causal, window,
                           q_offset, scale)
    runs = [F.flash_backward_dkv(POSIT16, plan, *args(k, v)) for _ in range(2)]
    from_f32 = F.flash_backward_dkv(POSIT16, plan, *args(k.float(), v.float()))
    dq = F.flash_backward_dq(POSIT16, plan, *args(k, v))
    twin = F.flash_backward_plain(POSIT16, q, k.float(), v.float(), o, co, m, l, causal,
                                  window, q_offset, scale)
    assert (dq - twin[0]).abs().max() <= BWD_TOL
    for got, again, same, want in zip(runs[0], runs[1], from_f32, twin[1:]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= BWD_TOL
        assert torch.equal(bits(got), bits(again))
        assert torch.equal(bits(got), bits(same))


# K7's geometries, (B, Sq, Sk, H, KV, hd, causal, window, q_offset): Sq off
# the 16-row q tile; head_dim 30 (K/V staged in 4-byte copies), 33 (bf16
# rows of 66 bytes, read straight from the tensors; f32 rows in 4-byte
# copies), 40 and 128 (zero-padded to the MMA depth of 8); SmolLM's GQA 15/5
# and OLMoE's 16/16 x 128; a window, with and without the causal mask; Sq <
# Sk with q_offset > 0; q_offset < 0, so the first 20 rows attend nothing
# (l = 0); non-causal
DQ_CASES = {
    "Sq70_hd30": (2, 70, 70, 6, 2, 30, True, 0, 0),
    "hd33": (1, 45, 45, 4, 2, 33, True, 0, 0),
    "hd40": (2, 100, 100, 6, 2, 40, True, 0, 0),
    "gqa_15_5": (2, 130, 130, 15, 5, 64, True, 0, 0),
    "mha_16_16_hd128": (1, 96, 96, 16, 16, 128, True, 0, 0),
    "window": (2, 160, 160, 6, 2, 64, True, 48, 0),
    "window_non_causal": (1, 100, 100, 4, 2, 64, False, 40, 0),
    "q_offset": (2, 40, 150, 6, 2, 64, True, 0, 110),
    "masked_rows": (2, 50, 50, 6, 2, 64, True, 0, -20),
    "non_causal": (2, 90, 120, 6, 2, 64, False, 0, 0),
}


@pytest.mark.parametrize("fmt", [POSIT8, POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
@pytest.mark.parametrize("case", list(DQ_CASES))
def test_dq_kernel_geometries_match_twin(dev, case, fmt):
    """K7 at each geometry and each format's model plan (srt_r4_cs_of_fr):
    within BWD_TOL of the twin (posit8: ``_close_grad``), the same bits on a
    second run, on f32 K/V holding bf16 values the bf16 call's bits, and
    rows that attend no key exactly 0."""
    B, Sq, Sk, H, KV, hd, causal, window, q_offset = DQ_CASES[case]
    g = torch.Generator().manual_seed(hd + Sq + Sk)
    q = torch.randn(B, Sq, H, hd, generator=g).to(torch.bfloat16).float().to(dev)
    k = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    co = torch.randn(B, Sq, H, hd, generator=g).to(dev)
    o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, causal, window, q_offset)
    plan = F.datapath_plan(fmt, "srt_r4_cs_of_fr")
    scale = 1 / math.sqrt(hd)
    args = lambda k_, v_: (q, k_, v_, co, m, l, F._row_sums(co, o), causal, window,
                           q_offset, scale)
    runs = [F.flash_backward_dq(fmt, plan, *args(k, v)) for _ in range(2)]
    from_f32 = F.flash_backward_dq(fmt, plan, *args(k.float(), v.float()))
    twin = F.flash_backward_plain(fmt, q, k.float(), v.float(), o, co, m, l, causal, window,
                                  q_offset, scale)[0]
    _close_grad(fmt, runs[0], twin)
    assert torch.equal(bits(runs[0]), bits(runs[1]))
    assert torch.equal(bits(runs[0]), bits(from_f32))
    empty = (l == 0).reshape(B, H, Sq).transpose(1, 2)   # (B, Sq, H): rows with no key
    assert bool(empty.any()) == (q_offset < 0)
    assert (runs[0][empty] == 0).all()


# The tile loop's geometries (K3 prefill; K5 and K6 run the same loop),
# (B, Sq, Sk, H, KV, hd, causal, window, kv_start): head_dim 8, 40, 64, 72
# and 128 (zero-padded to a multiple of 8), Sq off the 16-row tile,
# kv_start > 0, a window, non-causal with Sq < Sk
TILE_CASES = {
    "hd8": (2, 37, 37, 4, 2, 8, True, 0, [0, 5]),
    "hd40": (2, 77, 77, 6, 2, 40, True, 0, [0, 30]),
    "hd64_start56": (1, 256, 256, 15, 5, 64, True, 0, [56]),
    "hd72": (2, 50, 50, 6, 3, 72, True, 0, [3, 0]),
    "hd128": (1, 96, 96, 16, 16, 128, True, 0, [10]),
    "window": (2, 160, 160, 6, 2, 64, True, 48, [0, 20]),
    "non_causal": (2, 90, 120, 6, 2, 64, False, 0, [0, 7]),
}


@pytest.mark.parametrize("fmt", [POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_loop_geometries_match_twin(dev, case, fmt):
    """K3 prefill (the tile loop) at each geometry: within FLASH_TOL of its
    twin, the same bits on a second run, on f32 K/V holding bf16 values the
    bf16 call's bits, on f32 K/V bf16 cannot hold within FLASH_TOL, and rows
    before their kv_start exactly 0."""
    B, Sq, Sk, H, KV, hd, causal, window, start = TILE_CASES[case]
    g = torch.Generator().manual_seed(hd + Sq)
    q = torch.randn(B, Sq, H, hd, generator=g).to(dev)
    k = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    kw = dict(window=window, kv_start=torch.tensor(start, dtype=torch.int32, device=dev))
    runs = [posit_flash_attention(fmt, q, k, v, causal, **kw) for _ in range(2)]
    _close(fmt, runs[0], posit_flash_attention_plain(fmt, q, k, v, causal, **kw))
    assert torch.equal(bits(runs[0]), bits(runs[1]))
    same = posit_flash_attention(fmt, q, k.float(), v.float(), causal, **kw)
    assert torch.equal(bits(runs[0]), bits(same))
    kf, vf = _f32_twin(k, g), _f32_twin(v, g)
    _close(fmt, posit_flash_attention(fmt, q, kf, vf, causal, **kw),
           posit_flash_attention_plain(fmt, q, kf, vf, causal, **kw))
    if causal:
        for b, s in enumerate(start):
            assert (runs[0][b, :s] == 0).all()


# The tile loop past head_dim 128 (its kTileHdMax class: K3 prefill and K6,
# the dense layout), (B, Sq, H, KV, hd, window, kv_start): head_dim 136 and
# 200 (16-byte staging copies), 250 (4-byte copies; a row's bytes are not a
# multiple of 16) and 256 (RecurrentGemma's; posit8/16 f32 K/V past head_dim
# 206 read their rows straight, the staging buffer would not fit), each with
# a window
WIDE_TILE_CASES = {
    "hd136": (2, 70, 2, 1, 136, 24, [0, 9]),
    "hd200": (1, 130, 4, 2, 200, 0, [17]),
    "hd250": (2, 45, 2, 2, 250, 16, [3, 0]),
    "hd256": (1, 150, 2, 1, 256, 64, [0]),
}


@pytest.mark.parametrize("kv", ["bf16", "f32"])
@pytest.mark.parametrize("fmt", [POSIT8, POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
@pytest.mark.parametrize("case", list(WIDE_TILE_CASES))
def test_tile_loop_wide_head_dim_matches_twin(dev, case, fmt, kv):
    """K3 prefill and K6 at head_dim 136-256 with a window: within FLASH_TOL
    of their twins (posit8 by its patterns), K6's lse within LSE_TOL, the
    same bits on a second run, and on bf16 K/V the bits of the same values
    in f32 (staged or read straight)."""
    B, Sq, H, KV, hd, window, start = WIDE_TILE_CASES[case]
    g = torch.Generator().manual_seed(hd + Sq + fmt.n)
    q = torch.randn(B, Sq, H, hd, generator=g).to(dev)
    k = torch.randn(B, Sq, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sq, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    if kv == "f32":
        k, v = _f32_twin(k, g), _f32_twin(v, g)
    kw = dict(window=window, kv_start=torch.tensor(start, dtype=torch.int32, device=dev))
    runs = [posit_flash_attention(fmt, q, k, v, True, **kw) for _ in range(2)]
    _close(fmt, runs[0], posit_flash_attention_plain(fmt, q, k, v, True, **kw))
    assert torch.equal(bits(runs[0]), bits(runs[1]))
    if kv == "bf16":
        assert torch.equal(bits(runs[0]), bits(posit_flash_attention(
            fmt, q, k.float(), v.float(), True, **kw)))
    o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, window)
    po, pm, pl = F.posit_flash_attention_fwd_plain(fmt, q, k, v, True, window)
    _close(fmt, o, po)
    assert (m + torch.log(l) - pm - torch.log(pl)).abs().max() <= LSE_TOL


@pytest.mark.parametrize("fmt", [POSIT8, POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
def test_tile_loop_wide_head_dim_division_stage_bit_exact(dev, fmt):
    """The division stage at head_dim 256 on the kernel's own acc and l: q =
    0 makes every p exactly 1 and integer V makes acc and l exact integers
    whatever the order of the sums, so K6's o must be the twin's divide of
    them bit for bit, on bf16 and f32 K/V."""
    from repro_torch.kernels.posit_div import divide_floats_block

    S, H, hd, window = 300, 2, 256, 100
    g = torch.Generator().manual_seed(fmt.n)
    k = torch.randn(1, S, 1, hd, generator=g).to(dev)
    vi = torch.randint(-8, 9, (1, S, 1, hd), generator=g).float().to(dev)
    i = torch.arange(S, device=dev)
    keep = ((i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)).double()
    acc = (keep @ vi[0, :, 0].double()).float()
    cnt = keep.sum(-1).float()
    want = divide_floats_block(fmt, acc, cnt[:, None], "srt_r4_cs_of_fr")
    for dt in (torch.bfloat16, torch.float32):
        o, _, l = F.posit_flash_attention_fwd(fmt, torch.zeros(1, S, H, hd, device=dev),
                                              k.to(dt), vi.to(dt), True, window)
        assert torch.equal(l.reshape(H, S)[1], cnt)
        for h in range(H):
            assert torch.equal(bits(o[0, :, h]), bits(want))


# The backward past head_dim 128 (its kBwdHdMax class: K7 and K8),
# (B, Sq, H, KV, hd, window, q_offset): head_dim 136 and 200 (16-byte staging
# copies), 250 (4-byte copies) and 256 (RecurrentGemma's 10/1 heads), each
# with a window, the 256 case with Sq past it and a q_offset
WIDE_BWD_CASES = {
    "hd136": (2, 70, 2, 1, 136, 24, 0),
    "hd200": (1, 130, 4, 2, 200, 0, 0),
    "hd250": (2, 45, 2, 2, 250, 16, 0),
    "hd256": (1, 300, 10, 1, 256, 96, 0),
    "hd256_q_offset": (1, 120, 10, 1, 256, 64, 40),
}


@pytest.mark.parametrize("kv", ["bf16", "f32"])
@pytest.mark.parametrize("fmt", [POSIT8, POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
@pytest.mark.parametrize("case", list(WIDE_BWD_CASES))
def test_backward_wide_head_dim_matches_twin(dev, case, fmt, kv):
    """K7 and K8 at head_dim 136-256 with a window, from K6's residuals:
    within BWD_TOL of the twin (posit8: ``_close_grad``), the same bits on a
    second run, and on bf16 K/V the bits of the same values in f32."""
    B, Sq, H, KV, hd, window, q_offset = WIDE_BWD_CASES[case]
    Sk = Sq + q_offset
    g = torch.Generator().manual_seed(hd + Sq + fmt.n)
    q = torch.randn(B, Sq, H, hd, generator=g).to(torch.bfloat16).float().to(dev)
    k = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    co = torch.randn(B, Sq, H, hd, generator=g).to(dev)
    if kv == "f32":
        k, v = _f32_twin(k, g), _f32_twin(v, g)
    o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, window, q_offset)
    plan = F.datapath_plan(fmt, "srt_r4_cs_of_fr")
    scale = 1 / math.sqrt(hd)
    args = lambda k_, v_: (q, k_, v_, co, m, l, F._row_sums(co, o), True, window, q_offset,
                           scale)
    runs = [(F.flash_backward_dq(fmt, plan, *args(k, v)),
             *F.flash_backward_dkv(fmt, plan, *args(k, v))) for _ in range(2)]
    twin = F.flash_backward_plain(fmt, q, k.float(), v.float(), o, co, m, l, True, window,
                                  q_offset, scale)
    for got, again, want in zip(runs[0], runs[1], twin):
        _close_grad(fmt, got, want)
        assert torch.equal(bits(got), bits(again))
    if kv == "bf16":
        same = (F.flash_backward_dq(fmt, plan, *args(k.float(), v.float())),
                *F.flash_backward_dkv(fmt, plan, *args(k.float(), v.float())))
        for got, want in zip(runs[0], same):
            assert torch.equal(bits(got), bits(want))


def test_backward_wide_head_dim_through_autograd(dev):
    """``posit_flash_attention_ste`` at RecurrentGemma's attention shape cut
    to 1 x 2304 (10/1 heads of 256, window 2048): one K6, one K7 and one K8
    launch, and its gradients are ``flash_backward``'s."""
    g = torch.Generator().manual_seed(29)
    S, win = 2304, 2048
    q = torch.randn(1, S, 10, 256, generator=g).to(dev)
    k, v = (torch.randn(1, S, 1, 256, generator=g).to(torch.bfloat16).to(dev) for _ in "kv")
    co = torch.randn(1, S, 10, 256, generator=g).to(dev)
    before = (F.posit_flash_attention_fwd.launches, F.flash_backward_dq.launches,
              F.flash_backward_dkv.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.posit_flash_attention_ste(16, "srt_r4_cs_of_fr", True, win, 0, 0.0, *leaves)
    grads = torch.autograd.grad((out * co).sum(), leaves)
    assert (F.posit_flash_attention_fwd.launches, F.flash_backward_dq.launches,
            F.flash_backward_dkv.launches) == tuple(n + 1 for n in before)
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, True, win)
    want = F.flash_backward(POSIT16, q, k, v, o, co, m, l, True, win)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


def test_decode_loop_packed_and_backward_refuse_wide_head_dim(dev):
    """Past head_dim 128 the decode loop (K3 decode, K4) and the packed
    layout (K5), and past 256 the backward (K7, K8), raise ValueError naming
    ROADMAP before any launch: no kernel runs and no twin stands in."""
    fmt = POSIT16
    q = torch.randn(2, 1, 2, 256, device=dev)
    kv = torch.randn(2, 64, 1, 256, device=dev).to(torch.bfloat16)
    pos = torch.tensor([5, 40], dtype=torch.int32, device=dev)
    before = (posit_flash_attention.launches, posit_flash_attention.paged_launches,
              posit_flash_attention.packed_launches, F.flash_backward_dq.launches,
              F.flash_backward_dkv.launches)
    with pytest.raises(ValueError, match="decode loop.*ROADMAP"):
        posit_flash_attention(fmt, q, kv, kv, True, q_pos=pos, kv_len=pos + 1)
    with pytest.raises(ValueError, match="decode loop.*ROADMAP"):
        posit_flash_attention(fmt, q, kv[:1, :32].reshape(2, 16, 1, 256),
                              kv[:1, :32].reshape(2, 16, 1, 256), True, q_pos=pos,
                              kv_len=pos + 1, block_tables=torch.ones(2, 4, dtype=torch.int32,
                                                                      device=dev))
    qs, ks = torch.randn(1, 16, 2, 256, device=dev), kv[:1, :16]
    seg = torch.zeros(1, 16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="packed.*ROADMAP"):
        posit_flash_attention(fmt, qs, ks, ks, True, seg_q=seg, seg_kv=seg, seg_len=16)
    qw, kw = torch.randn(1, 16, 2, 264, device=dev), kv[:1, :16, :, :8].repeat(1, 1, 1, 33)
    ml = torch.ones(2, 16, device=dev)
    with pytest.raises(ValueError, match="backward.*ROADMAP"):
        F.flash_backward(fmt, qw, kw, kw, qw, torch.randn_like(qw), ml, ml)
    assert before == (posit_flash_attention.launches, posit_flash_attention.paged_launches,
                      posit_flash_attention.packed_launches, F.flash_backward_dq.launches,
                      F.flash_backward_dkv.launches)


@pytest.mark.parametrize("fmt", [POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
@pytest.mark.parametrize("suffix", [1, 17])
def test_suffix_prefill_rows_are_whole_prefill_rows(dev, suffix, fmt):
    """A prefix-sharing suffix prefill (``layers.prefill_suffix_attention``:
    the suffix's queries at q_offset t0 over the cache's rows [0, t0 + n))
    gives its rows the bits of the same rows of the whole prompt's prefill,
    for a 1-token and a 17-token suffix: every prefill takes the tile loop,
    whatever its length, and a row's bits do not depend on its tile."""
    g = torch.Generator().manual_seed(suffix)
    P = 150
    q = torch.randn(2, P, 15, 64, generator=g).to(dev)
    k = torch.randn(2, P, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(2, P, 5, 64, generator=g).to(torch.bfloat16).to(dev)
    start = torch.tensor([0, 6], dtype=torch.int32, device=dev)
    whole = posit_flash_attention(fmt, q, k, v, True, kv_start=start)
    for t0 in (P - suffix, 70):
        end = t0 + suffix
        part = posit_flash_attention(fmt, q[:, t0:end], k[:, :end], v[:, :end], True,
                                     q_offset=t0, kv_start=start)
        assert torch.equal(bits(part), bits(whole[:, t0:end])), t0


@pytest.mark.parametrize("fmt", [POSIT8, POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
@pytest.mark.parametrize("case", ["hd64_start56", "hd40", "window"])
def test_tile_loop_is_row_loop_bits(dev, case, fmt):
    """At posit8 and posit16 the tile loop (K3 prefill, K5, K6) keeps the
    one-row loop's arithmetic: a prefill's rows, and K6's m and l, are the
    bits the one-row loop gives the same rows (reached here with q_pos = 0,
    which routes a call there and shifts no position).  Posit32 and posit64
    run the tile loop's products on the tensor cores: there the two loops'
    outputs agree within FLASH_TOL and their lse = m + log l within
    LSE_TOL, the twin's gates."""
    B, Sq, Sk, H, KV, hd, causal, window, start = TILE_CASES[case]
    g = torch.Generator().manual_seed(hd + Sq + 1)
    q = torch.randn(B, Sq, H, hd, generator=g).to(dev)
    k = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    plan = F.datapath_plan(fmt, "srt_r4_cs_of_fr")
    ks = torch.tensor(start, dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    args = (fmt, plan, q, k, v, causal, window, 0, 0.0, ks, None)
    tile = F._launch(*args, None, residuals=True)
    rows = F._launch(*args, zero, residuals=True)
    if fmt.n < 32:
        for a, b in zip(tile, rows):
            assert torch.equal(bits(a), bits(b))
        return
    _close(fmt, tile[0], rows[0])
    live = rows[2] > 0
    lse = [(m + torch.log(l))[live] for _, m, l in (tile, rows)]
    assert (lse[0] - lse[1]).abs().max() <= LSE_TOL


@pytest.mark.parametrize("fmt", [POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
def test_forward_row_max_is_dq_kernels_row_max(dev, fmt):
    """K6's m against the largest of K7's scaled scores on the same inputs.
    K7 reads them back through its dq: with dO = 0, D = -1 and l = 1 its ds
    is p = exp(s * scale - m) through K1, and with q zero in head dims [64,
    128) and key j one-hot there (k[j, 64 + j] = 1), dq[i, 64 + j] = scale *
    p_ij, so a row's peak there is scale * exp(max_j s_ij * scale - m_i).
    At posit32 and posit64 K6 computes s by K7's own 3xTF32 code, scaled
    at the same point, so the two maxima are the same float: the peak is
    exp(0) = 1 exactly, and its log 0.  The bound below (2^-20 of the row's
    largest sum of |q_d k_d| times the scale) is what an f32 FMA forward
    would have to meet; posit16 would round p to 1 and show nothing."""
    B, S, H, KV, hd = 2, 64, 4, 2, 128
    g = torch.Generator().manual_seed(23)
    q = torch.randn(B, S, H, hd, generator=g).to(torch.bfloat16).float()
    q[..., 64:] = 0
    k = torch.randn(B, S, KV, hd, generator=g)
    k[..., 64:] = 0
    k[:, torch.arange(S), :, 64 + torch.arange(S)] = 1.0
    k = k.to(torch.bfloat16)
    v = torch.randn(B, S, KV, hd, generator=g).to(torch.bfloat16)
    scale = 0.125
    kh = k.float()[:, :, torch.arange(H) // (H // KV)]            # (B, S, H, hd)
    mag = torch.einsum("bihd,bjhd->bihj", q.double().abs(), kh.double().abs())
    causal = torch.ones(S, S, dtype=torch.bool).tril()[None, :, None, :]
    tol = (mag.masked_fill(~causal, 0).amax(-1) * scale * 2.0 ** -20).to(dev)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    _, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, 0, 0, scale)
    ones = torch.ones_like(l)
    plan = F.datapath_plan(fmt, "srt_r4_cs_of_fr")
    dq = F.flash_backward_dq(fmt, plan, q, k, v, torch.zeros_like(q), m, ones, -ones, True, 0,
                             0, scale)
    gap = torch.log(dq[..., 64:].amax(-1).double() / scale)       # max_j s_ij * scale - m_i
    assert bool((gap.abs() <= tol).all())
    assert bool((gap == 0).all())


def test_flash_kernel_decode_hd128_mha(dev):
    """OLMoE's decode: head_dim 128, 16/16 heads, 8 slots with left pads
    (slot 7's only key lies before its start: fully masked)."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(8, 1, 16, 128, generator=g).to(dev)
    k = torch.randn(8, 512, 16, 128, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(8, 512, 16, 128, generator=g).to(torch.bfloat16).to(dev)
    pos = torch.tensor([511, 0, 17, 130, 255, 64, 300, 12], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 5, 100, 250, 64, 0, 13], dtype=torch.int32, device=dev)
    kw = dict(kv_start=start, kv_len=pos + 1, q_pos=pos)
    o = posit_flash_attention(POSIT16, q, k, v, True, **kw)
    p = posit_flash_attention_plain(POSIT16, q, k, v, True, **kw)
    assert (o - p).abs().max() <= FLASH_TOL
    assert (o[7] == 0).all()


# The decode loop's geometries (K3 decode, K4), (B, Sk, H, KV, hd, window,
# positions, kv_start): head_dim 8, 40, 64, 72 and 128; G = H / KV of 1, 3
# and 8; rows of up to 1100 keys (five 256-key chunks), ending on and
# across tile and chunk edges; kv_start above 0; a fully masked slot
# (position before kv_start); a window; head_dim 7, whose rows take plain
# loads (bf16: 14 bytes) and 4-byte copies (f32: 28 bytes), where the rest
# take 16-byte copies (and f32 at 128, V staged into K's buffer)
DECODE_CASES = {
    "hd7_g2": (2, 200, 4, 2, 7, 0, [150, 64], [0, 2]),
    "hd8_g2": (2, 300, 4, 2, 8, 0, [70, 299], [0, 5]),
    "hd40_g3": (3, 520, 6, 2, 40, 0, [255, 256, 511], [0, 30, 1]),
    "hd64_g3_long": (4, 1100, 15, 5, 64, 0, [1099, 1023, 64, 3], [0, 1, 0, 10]),
    "hd72_g3": (2, 300, 6, 2, 72, 0, [257, 63], [3, 0]),
    "hd128_g1": (3, 700, 4, 4, 128, 0, [511, 65, 699], [10, 66, 0]),
    "hd64_g8_window": (2, 600, 8, 1, 64, 48, [500, 200], [0, 20]),
}


@pytest.mark.parametrize("fmt", [POSIT16, POSIT32, POSIT64], ids=lambda f: f"posit{f.n}")
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_loop_geometries_match_twin(dev, case, fmt):
    """K3 decode (the decode loop) at each geometry: within FLASH_TOL of
    its twin, the same bits on a second run, K4 on the same rows paged its
    bits, on f32 K/V holding bf16 values the bf16 call's bits, on f32 K/V
    bf16 cannot hold within FLASH_TOL of the twin, a fully masked slot
    exactly 0."""
    B, Sk, H, KV, hd, window, pos, start = DECODE_CASES[case]
    g = torch.Generator().manual_seed(hd + Sk)
    q = torch.randn(B, 1, H, hd, generator=g).to(dev)
    k = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(window=window, kv_start=torch.tensor(start, dtype=torch.int32, device=dev),
              kv_len=pos_t + 1, q_pos=pos_t)
    runs = [posit_flash_attention(fmt, q, k, v, True, **kw) for _ in range(2)]
    _close(fmt, runs[0], posit_flash_attention_plain(fmt, q, k, v, True, **kw))
    assert torch.equal(bits(runs[0]), bits(runs[1]))
    same = posit_flash_attention(fmt, q, k.float(), v.float(), True, **kw)
    assert torch.equal(bits(runs[0]), bits(same))
    # the same rows from a paged pool: pages of 16, in reversed order
    bs = 16
    nb = -(-Sk // bs)
    pad = nb * bs - Sk
    pool = [torch.cat([t, t.new_zeros(B, pad, KV, hd)], 1).reshape(B * nb, bs, KV, hd).flip(0)
            for t in (k, v)]
    bt = (B * nb - 1 - torch.arange(B * nb, device=dev)).reshape(B, nb).to(torch.int32)
    paged = posit_flash_attention(fmt, q, *pool, True, block_tables=bt, **kw)
    assert torch.equal(bits(runs[0]), bits(paged))
    kf, vf = _f32_twin(k, g), _f32_twin(v, g)
    _close(fmt, posit_flash_attention(fmt, q, kf, vf, True, **kw),
           posit_flash_attention_plain(fmt, q, kf, vf, True, **kw))
    for b, (p, s) in enumerate(zip(pos, start)):
        if p < s:
            assert (runs[0][b] == 0).all()


def test_paged_kernel_olmoe_heads_is_dense_kernel(dev):
    """K4 at OLMoE's 16/16 heads of 128 (8 slots, pages of 16, shuffled
    shared pages, a parked row): K3's bits on the gathered cache, within
    FLASH_TOL of its twin, at every posit16 plan and posit64's default."""
    q, pk, pv, bt = _paged_case(dev, B=8, max_blocks=32, H=16, KV=16, hd=128, seed=9)
    pos = torch.tensor([511, 0, 17, 130, 255, 64, 300, 40], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 5, 100, 250, 64, 0, 41], dtype=torch.int32, device=dev)
    kd, vd = F.gather_pages(pk, bt), F.gather_pages(pv, bt)
    for fmt, variant in [(POSIT16, v) for v in KERNEL_VARIANTS] + [(POSIT64, "srt_r4_cs_of_fr")]:
        kw = dict(kv_start=start, kv_len=pos + 1, q_pos=pos, variant=variant)
        o = posit_flash_attention(fmt, q, pk, pv, True, block_tables=bt, **kw)
        assert torch.equal(bits(o), bits(posit_flash_attention(fmt, q, kd, vd, True, **kw)))
        _close(fmt, o, posit_flash_attention_plain(fmt, q, pk, pv, True, block_tables=bt, **kw))
        assert (o[7] == 0).all()


# ------------------------------------------------- the division API: K10-K12


def _k11_pairs():
    from repro_torch.core.posit import PositFormat

    return [(f, v) for f, v, _ in planned_pairs() if f.n <= 32] + [
        (f, v) for f, v, _ in one_word_pairs((PositFormat(10),))]


@pytest.mark.parametrize("fmt,variant", _k11_pairs(), ids=lambda x: str(x))
def test_pattern_kernel_matches_twin(dev, fmt, variant):
    """K11 on random patterns (posit8/10 exhaustive) with the edges."""
    n = fmt.n
    if n <= 10:
        px, pd = (m.reshape(-1) for m in torch.meshgrid(torch.arange(1 << n),
                                                        torch.arange(1 << n), indexing="ij"))
    else:
        g = torch.Generator().manual_seed(n)
        px, pd = (torch.randint(0, 1 << n, (70000,), generator=g, dtype=torch.int64)
                  for _ in range(2))
        edges = torch.tensor([0, 1 << (n - 1), 1, (1 << n) - 1, (1 << (n - 1)) - 1,
                              (1 << (n - 1)) + 1, 1 << (n - 2)])
        px[:49], pd[:49] = edges.repeat(7), edges.repeat_interleave(7)
    k = ops.posit_div(fmt, px.to(dev), pd.to(dev), variant)
    p = ops.posit_div_plain(fmt, px, pd, variant)
    assert k.dtype == torch.int64 and int(k.min()) >= 0
    assert torch.equal(k.cpu(), p)


@pytest.mark.parametrize("fmt,variant", [(f, v) for f, v, _ in planned_pairs()],
                         ids=lambda x: str(x))
def test_elementwise_kernel_matches_twin_and_chain(dev, fmt, variant):
    g = torch.Generator().manual_seed(fmt.n + 1)
    a, b = _wide(g, 37, 129), _wide(g, 37, 129)
    a[0, :len(SPECIALS)] = SPECIALS
    b[1, :len(SPECIALS)] = SPECIALS
    a, b = a.to(dev), b.to(dev)
    k = ops.posit_div_fused(fmt, a, b, variant)
    assert torch.equal(bits(k), bits(ops.posit_div_fused_plain(fmt, a, b, variant)))
    if fmt.n > 32:   # no posit64 patterns in a word: no chain
        return
    chained = ops.posit_dequantize(fmt, ops.posit_div(fmt, ops.posit_quantize(fmt, a),
                                                      ops.posit_quantize(fmt, b), variant))
    assert torch.equal(bits(k), bits(chained))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_cast_kernels_match_twin(dev, n):
    from repro_torch.core.posit import PositFormat

    fmt = PositFormat(n)
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-2 ** 31, 2 ** 31, (1 << 18,), generator=g, dtype=torch.int64)
    x = torch.cat([x.to(torch.int32).view(torch.float32), SPECIALS])
    p = (torch.arange(1 << n) if n < 32 else
         torch.randint(0, 1 << 32, (1 << 18,), generator=g, dtype=torch.int64))
    q = ops.posit_quantize(fmt, x.to(dev))
    assert torch.equal(q.cpu(), ops.posit_quantize_plain(fmt, x))
    d = ops.posit_dequantize(fmt, p.to(dev))
    assert torch.equal(bits(d.cpu()), bits(ops.posit_dequantize_plain(fmt, p)))
    # int32 words (a posit32 negative's top bit set) and, where they hold
    # the pattern, packed uint16 / uint8 words give the same values, read
    # as they are; a misaligned view takes the one-element path
    words = [torch.int32] + [t for t, b in ((torch.uint16, 16), (torch.uint8, 8)) if n <= b]
    for dt in words:
        w = p.to(dt).to(dev)
        assert torch.equal(bits(ops.posit_dequantize(fmt, w)), bits(d))
        assert torch.equal(bits(ops.posit_dequantize(fmt, w[1:])), bits(d[1:]))
    if n < 32:   # every pattern is its own image under quantize o dequantize
        assert torch.equal(ops.posit_quantize(fmt, d), p.to(dev))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_round_value_bf16_patterns_match_twin(dev, n):
    """posit_round_value, as the posit-KV path calls it, on every bf16 bit
    pattern widened to f32: one quantize and one dequantize launch, the
    twin's bits."""
    from repro_torch.core.posit import PositFormat

    fmt = PositFormat(n)
    x = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
    ops.posit_quantize.launches = ops.posit_dequantize.launches = 0
    ops.posit_round_value.launches = 0
    r = ops.posit_round_value(fmt, x.to(dev))
    assert ops.posit_round_value.launches == 1
    assert (ops.posit_quantize.launches, ops.posit_dequantize.launches) == (0, 0)
    twin = ops.posit_dequantize_plain(fmt, ops.posit_quantize_plain(fmt, x))
    assert torch.equal(bits(r.cpu()), bits(twin))


def _bits16(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_round_kv_kernel_matches_chain(dev, n):
    """K12's round kernel as the posit-KV path calls it (``posit_round_kv``,
    one launch for K and V of unequal sizes) against the chain it replaces
    on the card, quantize -> dequantize -> ``.to(dtype)``: every bf16 bit
    pattern (NaN classes included: the kernel's conversion is torch's CUDA
    one), 2^20 random f32 bit patterns with the specials (the vectorized
    path; a misaligned view the one-element one), a zero-size V, a
    non-contiguous K."""
    from repro_torch.core.posit import PositFormat

    fmt = PositFormat(n)
    chain = lambda t: ops.posit_dequantize(fmt, ops.posit_quantize(fmt, t)).to(t.dtype)
    g = torch.Generator().manual_seed(n + 5)
    kb = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
    kb = kb.to(torch.bfloat16).reshape(256, 4, 64).to(dev)
    kf = torch.randint(-2 ** 31, 2 ** 31, (1 << 20,), generator=g).to(torch.int32)
    kf = torch.cat([kf.view(torch.float32), SPECIALS]).to(dev)
    ops.posit_round_kv.launches = 0
    for k, v in ((kb, kb[:77].flip(0)), (kf, kf[: 1 << 17]), (kb, kb[:0]),
                 (kb.transpose(0, 2), kb[:3]), (kf[1:], kf[:1001])):
        rk, rv = ops.posit_round_kv(fmt, k, v)
        for r, t in ((rk, k), (rv, v)):
            assert r.shape == t.shape and r.dtype == t.dtype
            b = bits if t.dtype == torch.float32 else _bits16
            assert torch.equal(b(r), b(chain(t.contiguous())))
    assert ops.posit_round_kv.launches == 5
    # the host rule's NaN (posit_srt.cuh bf16_bits) is torch's CUDA conversion's
    nan = torch.tensor([math.nan, -math.nan], device=dev).to(torch.bfloat16)
    assert _bits16(nan).tolist() == [0x7FFF, 0x7FFF]


def test_pattern_and_dequantize_kernels_read_every_word(dev):
    """K11 and K12's dequantize on int64 lanes, int32 words and packed
    uint16 / uint8 patterns give the same bits; K11 writes int64 lanes
    (a posit32 quotient's top bit set comes back unsigned), at sizes on
    both sides of the vectorized path's threshold."""
    g = torch.Generator().manual_seed(3)
    for fmt, words in ((POSIT8, (torch.int32, torch.uint16, torch.uint8)),
                       (POSIT16, (torch.int32, torch.uint16)), (POSIT32, (torch.int32,))):
        for size in (4099, (1 << 20) + 5):
            px, pd = (torch.randint(0, 1 << fmt.n, (size,), generator=g) for _ in range(2))
            want = ops.posit_div_plain(fmt, px, pd)
            k = ops.posit_div(fmt, px.to(dev), pd.to(dev))
            assert k.dtype == torch.int64 and torch.equal(k.cpu(), want)
            d = ops.posit_dequantize(fmt, px.to(dev))
            for dt in words:
                a, b = px.to(dt).to(dev), pd.to(dt).to(dev)
                assert torch.equal(ops.posit_div(fmt, a, b), k), (fmt, dt)
                assert torch.equal(ops.posit_div(fmt, a[1:], b[1:]), k[1:]), (fmt, dt)
                assert torch.equal(bits(ops.posit_dequantize(fmt, a)), bits(d)), (fmt, dt)


def test_division_api_counts_and_refuses(dev):
    """One launch each; the chain four against the fused one; plans and
    formats no kernel is built for raise on a CUDA tensor (no twin)."""
    from repro_torch.core.posit import POSIT32, PositFormat

    a = torch.rand(64, 1024, device=dev) + 0.1
    b = torch.rand(64, 1024, device=dev) + 0.1
    counters = (ops.posit_div_fused, ops.posit_div, ops.posit_quantize, ops.posit_dequantize)
    for c in counters:
        c.launches = 0
    ops.posit_div_fused(POSIT16, a, b)
    ops.posit_dequantize(POSIT16, ops.posit_div(POSIT16, ops.posit_quantize(POSIT16, a),
                                                ops.posit_quantize(POSIT16, b)))
    assert [c.launches for c in counters] == [1, 1, 2, 1]
    ops.posit_div_fused_plain(POSIT16, a, b)
    ops.posit_quantize_plain(POSIT16, a)
    assert [c.launches for c in counters] == [1, 1, 2, 1]
    ops.posit_div_fused(POSIT32, a, b, "srt_r4_scaled")      # a two-word plan launches
    assert ops.posit_div_fused.launches == 2
    with pytest.raises(NotImplementedError, match="no kernel is built"):
        ops.posit_div_fused(PositFormat(10), a, b)
    with pytest.raises(NotImplementedError, match="no kernel is built"):
        ops.posit_div(PositFormat(12), a.long(), b.long())
    with pytest.raises(NotImplementedError, match="no kernel is built"):
        ops.posit_quantize(PositFormat(10), a)
    with pytest.raises(ValueError, match="uint32 bit patterns"):
        ops.posit_div(PositFormat(64), a.long(), b.long())
    # the kernels' own plan tables refuse, zero-size operands too
    e = a[:0]
    with pytest.raises(NotImplementedError, match="no kernel is built"):
        ops.posit_div_fused(PositFormat(10), e, e)
    with pytest.raises(NotImplementedError, match="no kernel is built"):
        ops.posit_div(PositFormat(12), e.long(), e.long())
    with pytest.raises(NotImplementedError, match="no kernel is built"):
        ops.posit_dequantize(PositFormat(10), e.long())
    with pytest.raises(NotImplementedError, match="no kernel is built"):
        ops.posit_round_value(PositFormat(10), a)
    assert [c.launches for c in counters] == [2, 1, 2, 1]


def test_kv_rounding_launches_k12(dev):
    """A posit-KV decode step rounds K and V in every layer: L launches of
    K12's round kernel (one a layer for both) and no quantize or
    dequantize, the cache holding posit-grid values."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.numerics.quant import posit_round_value

    cfg = get_config("smollm_360m", smoke=True).with_numerics(kv_cache_format="posit8")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    cache = T.init_cache(cfg, 2, 32, device=dev)
    toks = torch.from_numpy(np.arange(20, dtype=np.int64).reshape(2, 10) + 3).to(dev)
    T.prefill(params, cfg, toks, cache)
    ops.posit_quantize.launches = ops.posit_dequantize.launches = 0
    ops.posit_round_kv.launches = 0
    pos = torch.full((2,), 10, dtype=torch.int32, device=dev)
    lg, cache = T.decode_step(params, cfg, cache, toks[:, :1], pos)
    L = cfg.n_layers
    assert ops.posit_round_kv.launches == L
    assert (ops.posit_quantize.launches, ops.posit_dequantize.launches) == (0, 0)
    rows = cache["k"][:, :, :11].float()
    assert torch.equal(bits(posit_round_value(POSIT8, rows)), bits(rows))
    twin = ops.posit_dequantize_plain(POSIT8, ops.posit_quantize_plain(POSIT8, rows.cpu()))
    assert torch.equal(bits(twin), bits(rows.cpu()))
    assert bool(torch.isfinite(lg).all())


# ------------------------------ the two-word datapath's model kernels, grids


@pytest.mark.parametrize("shape", ["decode", "prefill"])
def test_flash_kernel_posit64(dev, shape):
    """K3's posit64 srt_r4_cs_of_fr instantiation (o / l on the two-word
    frame) within FLASH_TOL of its twin; fully masked rows 0."""
    g = torch.Generator().manual_seed(64)
    if shape == "decode":
        q = torch.randn(8, 1, 15, 64, generator=g).to(dev)
        k = torch.randn(8, 512, 5, 64, generator=g).to(torch.bfloat16).to(dev)
        v = torch.randn(8, 512, 5, 64, generator=g).to(torch.bfloat16).to(dev)
        pos = torch.tensor([47, 63, 92, 120, 151, 178, 199, 231], dtype=torch.int32,
                           device=dev)
        kw = dict(kv_start=torch.tensor([0, 0, 5, 3, 9, 0, 14, 232], dtype=torch.int32,
                                        device=dev), kv_len=pos + 1, q_pos=pos)
    else:
        q = torch.randn(1, 128, 15, 64, generator=g).to(dev)
        k = torch.randn(1, 128, 5, 64, generator=g).to(torch.bfloat16).to(dev)
        v = torch.randn(1, 128, 5, 64, generator=g).to(torch.bfloat16).to(dev)
        kw = dict(kv_start=torch.tensor([28], dtype=torch.int32, device=dev))
    o = posit_flash_attention(POSIT64, q, k, v, True, **kw)
    p = posit_flash_attention_plain(POSIT64, q, k, v, True, **kw)
    assert (o - p).abs().max() <= FLASH_TOL
    assert ((o[7] if shape == "decode" else o[0, :28]) == 0).all()


def test_rowwise_kernel_past_the_old_grid(dev):
    """K2 at 262144 rows of 960 (the training RMSNorm rows of a 1024 x 256
    batch): more than the 4 x 65535 rows gridDim.y took, bit-identical to its
    twin (run on the card, in row chunks)."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(262144, 960, generator=g, device=dev)
    b = torch.rand(262144, 1, generator=g, device=dev) + 0.01
    k = ops.posit_div_fused_rowwise(POSIT16, a, b)
    for r in range(0, 262144, 32768):
        p = ops.posit_div_rowwise_plain(POSIT16, a[r:r + 32768], b[r:r + 32768])
        assert torch.equal(bits(k[r:r + 32768]), bits(p)), r


def test_flash_kernels_past_the_old_grid(dev):
    """K3 decode and K6 (the tile loop) at B*H = 65536 and K7/K8 at B*KV =
    65536 (gridDim.y took 65535), within their bounds of the twins (K6 at
    posit32: o within FLASH_TOL, lse = m + log l within LSE_TOL), and K6's
    rows past head 65535 the bits a small launch gives them, at posit16
    and posit32.  (At posit16 the twin on the card sums in cuBLAS's order:
    over these 6.7e7 outputs some came out 2^-10 off, past FLASH_TOL, as
    posit16's two roundings allow.)"""
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, hd = 4096, 16, 64
    q = torch.randn(B, 1, H, hd, generator=g, device=dev)
    k = torch.randn(B, 64, H, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, 64, H, hd, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.full((B,), 63, dtype=torch.int32, device=dev)
    o = posit_flash_attention(POSIT16, q, k, v, True, kv_len=pos + 1, q_pos=pos)
    p = posit_flash_attention_plain(POSIT16, q, k, v, True, kv_len=pos + 1, q_pos=pos)
    assert (o - p).abs().max() <= FLASH_TOL
    q, k, v, co = _train_inputs(dev, B=B, S=16, H=H, KV=H, hd=hd)
    # K6's tile loop past the old grid: in its MMA form (posit32) within the
    # twin's bounds; in both forms the last 16 sequences' rows (heads past
    # 65535) the bits a launch of those 16 alone gives them
    res = F.posit_flash_attention_fwd(POSIT32, q, k, v, True)
    twin = F.posit_flash_attention_fwd_plain(POSIT32, q, k, v, True)
    assert (res[0] - twin[0]).abs().max() <= FLASH_TOL
    assert ((res[1] + torch.log(res[2])) - (twin[1] + torch.log(twin[2]))).abs().max() <= LSE_TOL
    for fmt in (POSIT16, POSIT32):
        whole = F.posit_flash_attention_fwd(fmt, q, k, v, True)
        tail = F.posit_flash_attention_fwd(fmt, q[-16:], k[-16:], v[-16:], True)
        for a, b in zip(whole, tail):
            assert torch.equal(bits(a[-b.shape[0]:]), bits(b))
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, True)
    plan = F.datapath_plan(POSIT16, "srt_r4_cs_of_fr")
    args = (q, k, v, co, m, l, F._row_sums(co, o), True, 0, 0, 1 / 8)
    got = (F.flash_backward_dq(POSIT16, plan, *args), *F.flash_backward_dkv(POSIT16, plan, *args))
    twin = F.flash_backward_plain(POSIT16, q, k.float(), v.float(), o, co, m, l, True)
    for x, want in zip(got, twin):
        assert (x - want).abs().max() <= BWD_TOL


def test_scaled_two_word_pattern_kernel_edges(dev):
    """K11 at posit32 srt_r4_scaled: every pair of the special patterns
    (0, NaR, +-minpos, +-maxpos, +-1 and their neighbours)."""
    base = [0, 1 << 31, 1, (1 << 32) - 1, (1 << 31) - 1, (1 << 31) + 1, 1 << 30,
            (1 << 32) - (1 << 30)]
    sp = torch.tensor(sorted({(x + d) % (1 << 32) for x in base for d in (-1, 0, 1)}))
    px, pd = (t.reshape(-1) for t in torch.meshgrid(sp, sp, indexing="ij"))
    k = ops.posit_div(POSIT32, px.to(dev), pd.to(dev), "srt_r4_scaled")
    assert torch.equal(k.cpu(), ops.posit_div_plain(POSIT32, px, pd, "srt_r4_scaled"))


# ------------------------------------------------------- the MoE family


def test_softmax_ste_gradient_on_card_matches_cpu(dev):
    """K9's straight-through gradient at a training step's router shape
    (2048 rows of 64 experts) on the card against the CPU path's, on rows
    whose exp(x - max) the card's torch gives the CPU's bits (each row's max
    0, the other entries drawn from values whose exp the two devices round
    alike; row 0 with -1e30 entries): the forward the CPU's bits (K9 is its
    twin's bits on the card), the backward exactly the reference formula
    on the card's own forward, and within 1e-5 relative L2 of the CPU's
    gradient (the two devices' row sums of ``e`` round apart)."""
    from repro_torch.numerics.formats import NumericsConfig
    from repro_torch.numerics.posit_ops import posit_softmax

    nm = NumericsConfig()
    g = torch.Generator().manual_seed(26)
    pool = -(torch.randn(8192, generator=g) * 4).abs()
    pool = pool[bits(torch.exp(pool.to(dev)).cpu()) == bits(torch.exp(pool))]
    x = pool[torch.randint(0, pool.numel(), (2048, 64), generator=g)]
    x[:, 0] = 0.0
    x[0, 1::5] = -1e30
    ct = torch.randn(2048, 64, generator=g)
    out = {}
    for d in ("cpu", dev):
        xd = x.to(d).requires_grad_()
        y = posit_softmax(xd, nm)
        (dx,) = torch.autograd.grad(y, xd, ct.to(d))
        out[torch.device(d).type] = (y.detach(), dx)
    (yc, dxc), (yg, dxg) = out["cpu"], out["cuda"]
    xg, cg = x.to(dev), ct.to(dev)
    e = torch.exp(xg - xg.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    assert torch.equal(bits(dxg), bits(p * (cg - (cg * yg).sum(-1, keepdim=True))))
    assert torch.equal(bits(yg.cpu()), bits(yc))
    err = float(torch.linalg.vector_norm(dxg.cpu() - dxc) / torch.linalg.vector_norm(dxc))
    assert err <= 1e-5
    assert float(dxg[0, 1::5].abs().max()) == 0.0


def _moe_smoke(dtype=torch.bfloat16):
    """The smoke OLMoE config and its weights on the CPU, from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("olmoe_1b_7b", smoke=True)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)


def test_moe_paged_engine_on_card_is_dense_engine(dev):
    """A smoke OLMoE served from the page pool on the card, solo and with
    batch-axis packs into the pool, against its dense-slot engine on the
    card (solo, and packed): the same tokens bit for bit, a prefix hit in
    both paged runs, L K4 launches a decode step and no K3 there."""
    import numpy as np

    from repro_torch.optim.tree import tree_map
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg, cpu = _moe_smoke()
    params = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.default_rng(26)
    prefix = rng.integers(0, cfg.vocab, 32)
    chat = [np.concatenate([prefix, rng.integers(0, cfg.vocab, n)]) for n in (5, 11, 3)]
    own = [rng.integers(0, cfg.vocab, n) for n in (9, 20, 40, 4)]
    prompts = [chat[0], own[0], own[1], chat[1], own[2], chat[2], own[3]]
    reqs = lambda: [Request(p.astype(np.int32), max_new=6) for p in prompts]
    for packed in (False, True):
        sc = dict(max_batch=4, max_seq=128, packed_prefill=packed)
        want = ServeEngine(cfg, params, ServeConfig(**sc), device=dev).serve(reqs())
        eng = ServeEngine(cfg, params, ServeConfig(kv_layout="paged", block_size=16, **sc),
                          device=dev)
        F_ = posit_flash_attention
        F_.launches = F_.paged_launches = 0
        got = eng.serve(reqs())
        st = eng.last_serve_stats
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (packed, i)
        assert st["prefix_hit_tokens"] > 0 and st["faults"] == 0
        assert st["packed_packs"] > 0 if packed else st["packed_packs"] == 0
        assert F_.paged_launches == cfg.n_layers * st["decode_steps"]
        assert F_.launches == cfg.n_layers * st["prefill_forwards"]


def test_moe_train_loss_on_card_matches_cpu(dev):
    """A smoke moe ``train_loss`` and its gradients (f32 masters, remat
    "full", capacity drops) on the card against the same weights and batch
    on the CPU.  The card's recompute routes as its forward; the CPU run
    follows the card's routes (top-k is a step function, and a bf16 ulp on
    the other device flips a near-tie), its own top-k differing only at
    near-ties (probabilities within 2^-6 of each other); the loss within
    1e-3 relative and every gradient leaf within 2e-2 relative L2."""
    import numpy as np

    from repro_torch.models.routes import NEAR_TIE, followed_routes, recorded_routes
    from repro_torch.optim.tree import tree_items, tree_leaves, tree_map
    from repro_torch.train.trainer import loss_and_grads

    cfg, cpu = _moe_smoke(torch.float32)
    cfg = cfg.replace(capacity_factor=0.5)
    gpu = tree_map(lambda t: t.to(dev), cpu)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    log, flips, runs = [], [], {}
    for d, params in ((dev, gpu), ("cpu", cpu)):
        batch = {"tokens": torch.from_numpy(tokens).to(d)}
        with recorded_routes(log) if d == dev else followed_routes(log, flips):
            (loss, _), grads = loss_and_grads(params, cfg, batch)
        runs[torch.device(d).type] = (float(loss), grads)
    L_ = cfg.n_layers
    assert len(log) == 2 * L_
    for j in range(L_):
        assert torch.equal(log[j], log[2 * L_ - 1 - j])
    assert max((gap for _, _, gap in flips), default=0.0) <= NEAR_TIE, flips[:3]
    (c_loss, c_grads), (g_loss, g_grads) = runs["cpu"], runs["cuda"]
    assert math.isfinite(g_loss) and abs(g_loss - c_loss) <= 1e-3 * abs(c_loss)
    for (key, g), c in zip(tree_items(g_grads), tree_leaves(c_grads)):
        err = float(torch.linalg.vector_norm(g.cpu() - c) / torch.linalg.vector_norm(c))
        assert err <= 2e-2, key


def test_stream_snapshot_restore_on_card_is_uninterrupted_run(dev):
    """A smoke SmolLM dense stream on the card, stopped after its 7th event
    (slots busy, requests queued), snapshot to host memory, restored on a
    fresh engine and drained: every request the uninterrupted run's tokens,
    greedy and sampled (the CUDA generators' states carried over)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeConfig, ServeEngine, TokenEvent

    cfg = get_config("smollm_360m", smoke=True)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 30, 9, 17, 3)]
    sc = ServeConfig(max_batch=2, max_seq=64)
    for temperature in (0.0, 0.8):
        reqs = lambda: [Request(p, max_new=6, temperature=temperature, seed=i)
                        for i, p in enumerate(prompts)]
        want = ServeEngine(cfg, params, sc, device=dev).serve(reqs())
        eng = ServeEngine(cfg, params, sc, device=dev)
        for r in reqs():
            eng.submit(r)
        toks = {}
        for n, ev in enumerate(eng.serve_stream()):
            if isinstance(ev, TokenEvent):
                toks.setdefault(ev.rid, []).append(ev.token)
            if n == 6:
                break
        snap = eng.snapshot()
        assert snap["queue"] and snap["cache"]["k"].device.type == "cpu"
        del eng
        eng2 = ServeEngine(cfg, params, sc, device=dev)
        eng2.restore(snap)
        for ev in eng2.serve_stream():
            if isinstance(ev, TokenEvent):
                toks.setdefault(ev.rid, []).append(ev.token)
        for i, w in enumerate(want):
            assert np.array_equal(np.asarray(toks[i], np.int32), w), (temperature, i)


def _hybrid_smoke(dtype=torch.float32, **cut):
    from repro_torch.configs import get_config
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import init_train_state

    cfg = get_config("recurrentgemma_2b", smoke=True).replace(**cut)
    return cfg, init_train_state(cfg, TrainConfig(seed=0), device="cpu")["params"]


def test_remat_policies_give_the_same_bits_on_card(dev):
    """The hybrid smoke config on the card (K6, K7, K8 at the smoke shape,
    the RG-LRU scan): remat "none", "full" and "dots" give the same loss
    and gradients, bit for bit, with K6 twice an attention layer under
    "full" and "dots"."""
    import numpy as np

    from repro_torch.optim.tree import tree_items, tree_leaves, tree_map
    from repro_torch.train.trainer import loss_and_grads

    cfg, cpu = _hybrid_smoke()
    params = tree_map(lambda t: t.to(dev), cpu)
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 96)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    runs = {}
    for remat in ("none", "full", "dots"):
        before = F.posit_flash_attention_fwd.launches
        runs[remat] = loss_and_grads(params, cfg.replace(remat=remat), batch)
        assert F.posit_flash_attention_fwd.launches - before == (1 if remat == "none" else 2)
    (loss0, _), g0 = runs["none"]
    for remat in ("full", "dots"):
        (loss, _), g = runs[remat]
        assert torch.equal(bits(loss), bits(loss0)), remat
        for (key, a), b in zip(tree_items(g), tree_leaves(g0)):
            assert torch.equal(bits(a), bits(b)), (remat, key)


def test_compress_gradients_on_card_is_twin(dev):
    """``compress_gradients`` on the card: one launch of K12's round kernel
    a leaf, the CPU twin chain's bits (NaN by value: the card's and the
    CPU's NaN bits differ), at posit8, posit16 and posit32."""
    from repro_torch.optim import compress_gradients
    from repro_torch.optim.tree import tree_items, tree_leaves, tree_map

    g = torch.Generator().manual_seed(40)
    tree = {"a": _wide(g, 300, 7), "b": [{"c": torch.cat([SPECIALS, _wide(g, 5000)])},
                                         {"d": torch.zeros(4)}]}
    for fmt in ("posit8", "posit16", "posit32"):
        before = ops.posit_round_value.launches
        got = compress_gradients(tree_map(lambda t: t.to(dev), tree), fmt)
        assert ops.posit_round_value.launches - before == 3
        want = compress_gradients(tree, fmt)
        for (key, a), b in zip(tree_items(got), tree_leaves(want)):
            a = a.cpu()
            nan = torch.isnan(b)
            assert torch.equal(torch.isnan(a), nan), (fmt, key)
            assert torch.equal(bits(a[~nan]), bits(b[~nan])), (fmt, key)


def test_hybrid_train_step_on_card_matches_cpu(dev):
    """The loss and gradients of a train step of the hybrid smoke config cut to one RG-LRU and
    one attention layer (2 x 96 tokens, past the 64-key window; f32
    masters) on the card against the same weights and batch on the CPU:
    the loss within 1e-3 relative and every gradient leaf within 2e-2
    relative L2."""
    import numpy as np

    from repro_torch.optim.tree import tree_items, tree_leaves, tree_map
    from repro_torch.train.trainer import loss_and_grads

    cfg, cpu = _hybrid_smoke(n_layers=2, attn_period=2)
    gpu = tree_map(lambda t: t.to(dev), cpu)
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 96)).astype(np.int32)
    runs = {}
    for d, params in ((dev, gpu), ("cpu", cpu)):
        (loss, _), grads = loss_and_grads(params, cfg, {"tokens": torch.from_numpy(toks).to(d)})
        runs[torch.device(d).type] = (float(loss), grads)
    (c_loss, c_grads), (g_loss, g_grads) = runs["cpu"], runs["cuda"]
    assert math.isfinite(g_loss) and abs(g_loss - c_loss) <= 1e-3 * abs(c_loss)
    for (key, g), c in zip(tree_items(g_grads), tree_leaves(c_grads)):
        err = float(torch.linalg.vector_norm(g.cpu() - c) / torch.linalg.vector_norm(c))
        assert err <= 2e-2, (key, err)


def test_ssm_decode_and_forward_on_card_match_cpu(dev):
    """The ssm smoke config (Mamba2: the chunked SSD, K2 at d_model and
    d_inner) on the card against the same bf16 weights on the CPU: the
    whole-sequence forward's logits (2 x 96, chunks of 48) and a scanned
    prefill then three decode steps' logits within 8 bf16 ulps of the
    largest logit, the state ``h`` within 1e-2 of its largest magnitude."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim.tree import tree_map

    cfg = get_config("mamba2-2.7b", smoke=True).replace(remat="none")
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab, (2, 96)))
    start = torch.tensor([0, 5], dtype=torch.int32)
    runs = {}
    for d, params in ((dev, gpu), ("cpu", cpu)):
        before = ops.posit_div_fused_rowwise.launches
        with torch.inference_mode():
            h = T.forward(params, cfg, {"tokens": toks.to(d)})
            fwd = L.logits(params["head"], h).float().cpu()
            cache = T.init_cache(cfg, 2, 64, device=d)
            lg, cache = T.prefill(params, cfg, toks[:, :12].to(d), cache, start.to(d))
            steps = [lg.float().cpu()]
            for i in range(12, 15):
                lg, cache = T.decode_step(params, cfg, cache, toks[:, i:i + 1].to(d),
                                          torch.full((2,), i, dtype=torch.int32, device=d),
                                          start.to(d))
                steps.append(lg.float().cpu())
        if torch.device(d).type == "cuda":
            # 2L + 1 a forward: the forward, 12 scan steps, 3 decode steps
            assert ops.posit_div_fused_rowwise.launches - before == 16 * (2 * cfg.n_layers + 1)
        runs[torch.device(d).type] = (fwd, torch.cat(steps, 1), cache["layers"]["h"].cpu())
    (c_fwd, c_dec, c_h), (g_fwd, g_dec, g_h) = runs["cpu"], runs["cuda"]
    for c, g in ((c_fwd, g_fwd), (c_dec, g_dec)):
        c, g = c[..., :cfg.vocab], g[..., :cfg.vocab]
        ulp = 2.0 ** (math.floor(math.log2(float(c.abs().max()))) - 7)
        assert torch.isfinite(g).all() and float((g - c).abs().max()) <= 8 * ulp
    assert float((g_h - c_h).abs().max()) <= 1e-2 * float(c_h.abs().max())
