"""The port's packed multi-prompt prefill on the CPU (smoke config): K5's
twin against the reference's segment-masked kernel, each segment against
its solo twin (bit for bit), the packing planner against the reference's,
and packed serving against solo serving (bit for bit, dense and paged
layouts) and against the reference engine (under test_torch_serve's
margin rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401  (fixtures)
    bf16_ulp, bits, one_torch_thread, ref_kernels, reference_kernels)
from repro.configs import get_config as jget
from repro.core.posit import PositFormat as JFmt
from repro.kernels.posit_flash_attn import posit_flash_attention as jflash
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import Scheduler as JScheduler
from repro_torch.configs import get_config as tget
from repro_torch.core.posit import PositFormat
from repro_torch.kernels.posit_flash_attn import posit_flash_attention
from repro_torch.models import transformer as TT
from repro_torch.serve import FinishReason, Request, Scheduler, ServeConfig, ServeEngine
from repro_torch.serve.engine import _pow2_ceil

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLASH_TOL = 2e-3    # K3's twin against the reference (test_torch_flash_attn.py)
LOGIT_ULPS = 8      # as tests/test_torch_model.py
RNG = np.random.default_rng(7)
PROMPTS = [RNG.integers(1, 100, size=n).astype(np.int32)
           for n in (3, 5, 7, 11, 13, 2, 9, 4, 6, 8, 17, 19)]
BUDGETS = [4, 6, 8, 5, 3, 7, 4, 6, 2, 8, 5, 4]
H, KV, HD = 3, 1, 32


# ------------------------------------------------------------------ K5 twin


def _pack(N, P, left=True):
    """A pack of N segments of width P (left-padded as the dense layout
    packs, right-padded as the paged one): segment 0 a dummy, segment 2
    sharing segment 1's first half, one segment of a single token.
    Returns q, k, v (numpy), seg_q, seg_kv and each segment's (offset,
    length)."""
    S = N * P
    q = RNG.standard_normal((1, S, H, HD)).astype(np.float32)
    k = RNG.standard_normal((1, S, KV, HD)).astype(np.float32)
    v = RNG.standard_normal((1, S, KV, HD)).astype(np.float32)
    lens = [0, P - 1, P - 1] + [1 + (5 * i) % P for i in range(3, N)]
    lens[-1] = 1
    seg = np.full((1, S), -1, np.int32)
    segs = []
    for i, n in enumerate(lens):
        off = i * P + (P - n if left else 0)
        if n:
            seg[0, off:off + n] = i
            segs.append((off, n))
    (o1, _), (o2, _) = segs[:2]
    for a in (q, k, v):
        a[:, o2:o2 + P // 2] = a[:, o1:o1 + P // 2]
    seg_q = np.where(seg < 0, -2, seg).astype(np.int32)
    return q, k, v, seg_q, seg, segs


@pytest.mark.parametrize("left", [True, False], ids=["left_padded", "right_padded"])
def test_packed_twin_matches_reference_kernel(ref_kernels, left):
    P = 16
    q, k, v, seg_q, seg, _ = _pack(4, P, left)
    ref = jflash(JFmt(16), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                 block_q=P, block_k=P, seg_q=jnp.asarray(seg_q), seg_kv=jnp.asarray(seg))
    got = posit_flash_attention(PositFormat(16), *map(torch.from_numpy, (q, k, v)), True,
                                seg_q=torch.from_numpy(seg_q), seg_kv=torch.from_numpy(seg),
                                seg_len=P)
    ref = np.asarray(ref)
    err = float(np.abs(ref - got.numpy()).max())
    print(f"K5 twin: max|port - reference| = {err:.3g} (tolerance {FLASH_TOL})")
    assert err <= FLASH_TOL
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)


@pytest.mark.parametrize("N,P,left", [(4, 64, True), (4, 64, False), (8, 8, True)])
def test_packed_segments_are_solo_twin(N, P, left):
    """Each segment's rows are the bits of a solo (unpacked) call on its
    prompt; the dummy segment's rows are 0."""
    q, k, v, seg_q, seg, segs = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                 for a in _pack(N, P, left))
    o = posit_flash_attention(PositFormat(16), q, k, v, True, seg_q=seg_q, seg_kv=seg,
                              seg_len=P)
    assert not o[:, :P].any()
    for off, n in segs:
        solo = posit_flash_attention(PositFormat(16), q[:, off:off + n], k[:, off:off + n],
                                     v[:, off:off + n], True)
        np.testing.assert_array_equal(bits(o[:, off:off + n].contiguous()), bits(solo))


def test_packed_inputs_are_checked():
    q, k, v, seg_q, seg, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in _pack(4, 16))
    with pytest.raises(ValueError, match="seg_len"):
        posit_flash_attention(PositFormat(16), q, k, v, True, seg_q=seg_q, seg_kv=seg)
    with pytest.raises(ValueError, match="multiple of 16"):
        posit_flash_attention(PositFormat(16), q[:, :48], k[:, :48], v[:, :48], True,
                              seg_q=seg_q[:, :48], seg_kv=seg[:, :48], seg_len=24)
    with pytest.raises(ValueError, match="kv_start"):
        posit_flash_attention(PositFormat(16), q, k, v, True, seg_q=seg_q, seg_kv=seg,
                              seg_len=16, kv_start=torch.zeros(1, dtype=torch.int32))


# ------------------------------------------------------------ the planner


@pytest.mark.parametrize("head", [
    [(1, ("a",)), (2, ("b",)), (3, ("a",)), (4, None), (5, ("b",))],
    [(0, 16), (1, 8), (2, 16), (3, 16), (4, 32), (5, None), (6, 8)],
    [(7, None), (8, None)],
    [],
], ids=["tuple_keys", "widths", "unpackable", "empty"])
def test_plan_packs_matches_reference(head):
    assert Scheduler.plan_packs(head) == JScheduler.plan_packs(head)


def test_pow2_ceil():
    assert [_pow2_ceil(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert _pow2_ceil(3, 8) == 8


# ------------------------------------------------------------ the engine

SC = dict(max_batch=4, max_seq=96)


@pytest.fixture(scope="module")
def model():
    tcfg = tget("smollm_360m", smoke=True, fused=True)
    jcfg = jget("smollm_360m", smoke=True, fused=True)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    solo = ServeEngine(tcfg, tp, ServeConfig(**SC), device="cpu")
    reqs = [Request(p, max_new=m) for p, m in zip(PROMPTS, BUDGETS)]
    return jcfg, jp, tcfg, tp, solo, reqs, solo.serve(reqs)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_packed_matches_solo(model, layout):
    """12 prompts through 4 slots: every request's tokens packed are its solo
    tokens, and packs formed (with dummy segments)."""
    _, _, tcfg, tp, _, reqs, souts = model
    eng = ServeEngine(tcfg, tp, ServeConfig(packed_prefill=True, kv_layout=layout,
                                            block_size=8, **SC), device="cpu")
    for i, (a, b) in enumerate(zip(souts, eng.serve(reqs))):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    st = eng.last_serve_stats
    assert st["packed_prefill"] is True and st["kv_layout"] == layout
    assert st["packed_segments"] == len(reqs) and st["admissions"] == len(reqs)
    assert st["packed_packs"] < len(reqs) and st["packed_dummies"] > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_packed_posit64_matches_solo(model, layout):
    """At posit64 srt_r4_cs_of_fr (every o / l and RMSNorm divide on K1's
    two-word frame; K4 / K5 are built for it): packed admission, from dense
    slots and from the paged pool, gives every request the tokens of a
    posit64 solo engine on dense slots."""
    _check_packed_format(model, layout, "posit64")


@pytest.mark.parametrize("div_format", ["posit8", "posit32"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_packed_posit8_posit32_matches_solo(model, layout, div_format):
    """The same at posit8 and posit32 (K4 / K5 built for every plan of
    both)."""
    _check_packed_format(model, layout, div_format)


def _check_packed_format(model, layout, div_format):
    _, _, tcfg, tp, _, reqs, _ = model
    cfg = tcfg.with_numerics(div_format=div_format)
    reqs = reqs[:8]
    solo = ServeEngine(cfg, tp, ServeConfig(**SC), device="cpu").serve(reqs)
    eng = ServeEngine(cfg, tp, ServeConfig(packed_prefill=True, kv_layout=layout,
                                           block_size=8, **SC), device="cpu")
    for i, (a, b) in enumerate(zip(solo, eng.serve(reqs))):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    st = eng.last_serve_stats
    assert st["packed_packs"] < len(reqs) and st["packed_segments"] == len(reqs)


def test_packed_shared_prefix_within_and_across_packs(model):
    """Two prompts sharing a block-aligned prefix pack together (both
    recomputed whole); a later repeat finds the prefix registered by the
    pack, maps its blocks and prefills only its suffix.  All three are
    their solo tokens."""
    _, _, tcfg, tp, solo, _, _ = model
    base = RNG.integers(1, 100, size=16).astype(np.int32)
    fork = np.concatenate([base[:8], RNG.integers(1, 100, size=5)]).astype(np.int32)
    reqs = [Request(base, max_new=5), Request(fork, max_new=4), Request(base.copy(), max_new=3)]
    eng = ServeEngine(tcfg, tp, ServeConfig(packed_prefill=True, kv_layout="paged",
                                            block_size=8, max_batch=2, max_seq=96),
                      device="cpu")
    for i, (a, b) in enumerate(zip(solo.serve(reqs), eng.serve(reqs))):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    st = eng.last_serve_stats
    assert st["packed_packs"] == 1 and st["packed_segments"] == 2
    assert st["prefix_hit_tokens"] > 0 and st["shared_blocks"] >= 1


def test_packed_sampling_matches_solo(model):
    """Per-request temperatures and generators survive packing."""
    _, _, tcfg, tp, solo, _, _ = model
    reqs = [Request(p, max_new=6, temperature=0.8, seed=100 + i)
            for i, p in enumerate(PROMPTS[:5])]
    eng = ServeEngine(tcfg, tp, ServeConfig(packed_prefill=True, **SC), device="cpu")
    for i, (a, b) in enumerate(zip(solo.serve(reqs), eng.serve(reqs))):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_faulted_segment_is_quarantined_alone(model, layout):
    """A prompt whose embedding is NaN faults at admission; its pack-mates
    keep their clean tokens (K5 never lets another segment's keys into a
    sum), and in the paged layout it maps no blocks (its rows go to the
    block-0 sink) and counts no prompt tokens."""
    _, _, tcfg, tp, _, _, _ = model
    poison = 97
    tok = dict(tp, tok=tp["tok"].clone())
    tok["tok"][poison] = float("nan")
    clean = [np.array([5, 6, 7, 8, 9], np.int32), np.array([1, 2, 3, 4, 11, 12], np.int32)]
    bad = np.array([5, poison, 7, 8], np.int32)
    reqs = [Request(clean[0], max_new=4), Request(bad, max_new=4), Request(clean[1], max_new=4)]
    sc = ServeConfig(packed_prefill=True, kv_layout=layout, block_size=8, **SC)
    eng = ServeEngine(tcfg, tok, sc, device="cpu")
    outs = eng.serve(reqs)
    ref = ServeEngine(tcfg, tok, ServeConfig(**SC), device="cpu").serve(
        [reqs[0], reqs[2]])
    assert [r.finish for r in eng.last_results] == [
        FinishReason.MAX_NEW, FinishReason.FAULT, FinishReason.MAX_NEW]
    assert outs[1].size == 0 and eng.last_serve_stats["faults"] == 1
    assert eng.last_serve_stats["packed_packs"] == 1
    np.testing.assert_array_equal(outs[0], ref[0])
    np.testing.assert_array_equal(outs[2], ref[1])
    if layout == "paged":
        assert eng.last_serve_stats["prompt_tokens"] == len(clean[0]) + len(clean[1])


def test_packed_matches_reference_engine(model):
    """Paged packed tokens equal the reference's paged packed engine's, a
    difference being allowed only where the reference's top-2 margin is
    within the model test's logit bound (tests/test_torch_serve.py)."""
    jcfg, jp, tcfg, tp, _, reqs, _ = model
    stream = [(p, m) for p, m in zip(PROMPTS[:6], BUDGETS[:6])]
    kw = dict(kv_layout="paged", block_size=8, packed_prefill=True, **SC)
    with reference_kernels():
        ref = JServeEngine(jcfg, jp, JServeConfig(**kw)).serve(
            [JRequest(p, max_new=m) for p, m in stream])
        ref = [np.asarray(r) for r in ref]
    outs = ServeEngine(tcfg, tp, ServeConfig(**kw), device="cpu").serve(
        [Request(p, max_new=m) for p, m in stream])
    for (p, _), r, g in zip(stream, ref, outs):
        if np.array_equal(r, g):
            continue
        j = int(np.flatnonzero(r != g)[0])
        with reference_kernels():
            seq = jnp.asarray(np.concatenate([p, r[:j]])[None])
            lg, _ = JT.prefill(jp, jcfg, {"tokens": seq}, JT.init_cache(jcfg, 1, 96))
        row = np.asarray(lg[0, -1, :jcfg.vocab].astype(jnp.float32))
        top2 = np.sort(row)[-2:]
        print(f"token {j} differs; reference top-2 margin {top2[1] - top2[0]:.4g}")
        assert top2[1] - top2[0] <= LOGIT_ULPS * bf16_ulp(np.abs(row).max())


def test_packed_cache_writes(model):
    """write_cache_slot_segments zero-fills past the segment; scatter_
    segments_to_pool writes owned pages only (block 0 is never written)."""
    _, _, tcfg, _, _, _, _ = model
    g = torch.Generator().manual_seed(1)
    mini = {n: torch.randn((tcfg.n_layers, 1, 32, tcfg.n_kv_heads, tcfg.head_dim),
                           generator=g).to(torch.bfloat16) for n in ("k", "v")}
    cache = TT.init_cache(tcfg, 3, 24, device="cpu")
    for n in ("k", "v"):
        cache[n].fill_(1.0)
    TT.write_cache_slot_segments(tcfg, cache, mini, [2, 0], 16)
    for n in ("k", "v"):
        assert torch.equal(cache[n][:, 0, :16], mini[n][:, 0, 16:32])
        assert torch.equal(cache[n][:, 2, :16], mini[n][:, 0, :16])
        assert not cache[n][:, 0, 16:].any() and (cache[n][:, 1] == 1).all()
    pool = TT.init_paged_cache(tcfg, 5, 8, device="cpu")
    TT.scatter_segments_to_pool(tcfg, pool, mini, np.array([[0, 3], [4, 0]]), 16)
    for n in ("k", "v"):
        assert torch.equal(pool[n][:, 3], mini[n][:, 0, 8:16])
        assert torch.equal(pool[n][:, 4], mini[n][:, 0, 16:24])
        assert not pool[n][:, 0].any() and not pool[n][:, 1].any()
