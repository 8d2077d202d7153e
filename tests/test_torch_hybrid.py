"""The port's hybrid family (RecurrentGemma: RG-LRU blocks and local
attention) against the reference on the smoke config, window 64.

Held against the reference, with its Pallas kernels in interpret mode:
``rglru_block`` in its whole-sequence and decode forms (within
BLOCK_ULPS bf16 ulps of the output's largest magnitude: the scan runs in
``jax.lax.associative_scan``'s order, and the two libraries' ``exp``,
``tanh`` and bf16 products round a few elements apart), ``forward``'s
logits and the scanned prefill's (a decode step a position; LOGIT_ULPS,
as the dense family's), the engine's greedy tokens, a decode past the
window included (a difference allowed only where the reference's top-2
margin is within that bound), and the tile loop's twin at head_dim 256
with a window against the reference's flash kernel (FLASH_TOL).  In the port, solo,
packed, mid-flight, ``kv_layout="paged"`` and snapshot-restored runs give
the same tokens, and the decode loop and the backward refuse head_dim
above 128 before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401  (fixtures)
    _assert_tokens_match, bf16_ulp, one_torch_thread, ref_kernels, reference_kernels)
from repro.configs import get_config as jget
from repro.core.posit import PositFormat as JFmt
from repro.kernels.posit_flash_attn import posit_flash_attention as jflash
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.core.posit import PositFormat
from repro_torch.kernels import posit_flash_attn as F
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import FinishEvent, Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.usefixtures("one_torch_thread")
LOGIT_ULPS = 8          # as tests/test_torch_model.py
BLOCK_ULPS = 2          # rglru_block's output (measured 1)
FLASH_TOL = 2e-3        # as tests/test_torch_flash_attn.py
B, S, MAX_SEQ = 2, 12, 96
RNG = np.random.default_rng(28)
# prompt lengths and budgets: the last is left-padded to 64 rows, so its
# ring buffer (64 rows) wraps from its first decode step
STREAM = [(RNG.integers(0, 512, n).astype(np.int32), m)
          for n, m in [(3, 6), (7, 4), (40, 6)]]


def _cfgs():
    return jget("recurrentgemma_2b", smoke=True, fused=True), tget("recurrentgemma_2b",
                                                                   smoke=True)


def _max_ulps(ref, got):
    return float(np.abs(ref - got).max()) / bf16_ulp(np.abs(ref).max())


# ------------------------------------------------------------ the block


def test_config_and_registry():
    _, cfg = _cfgs()
    full = tget("recurrentgemma-2b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab, full.local_window, full.lru_width) == (
        26, 2560, 10, 1, 256, 7680, 256000, 2048, 2560)
    assert [i for i in range(26) if full.is_attn_layer(i)] == [2, 5, 8, 11, 14, 17, 20, 23]
    assert (cfg.n_layers, cfg.local_window, cfg.head_dim) == (3, 64, 32)
    with pytest.raises(KeyError, match="recurrentgemma-2b.*smollm_360m"):
        tget("mamba2_2p7b")


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = _cfgs()
    jp = JR.init_rglru_block(jax.random.PRNGKey(1), jcfg)
    tp = {k: torch.from_numpy(np.array(v)).to(torch.float32 if k in ("conv_b", "lam")
                                             else torch.bfloat16)
          for k, v in jax.tree.map(np.asarray, jp).items()}
    return jcfg, tcfg, jp, tp


def test_rglru_scan_matches_reference(block):
    jcfg, tcfg, jp, tp = block
    x = RNG.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    ref = np.asarray(JR.rglru_block(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
                     .astype(jnp.float32))
    got = TR.rglru_block(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg).float().numpy()
    print(f"scan: {_max_ulps(ref, got):.3g} bf16 ulps of max|y|")
    assert _max_ulps(ref, got) <= BLOCK_ULPS


def test_rglru_scan_order_is_associative_scans():
    a = torch.from_numpy(RNG.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(RNG.standard_normal((2, 37, 5)).astype(np.float32))
    comb = lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1])
    _, ref = jax.lax.associative_scan(comb, (jnp.asarray(a.numpy()), jnp.asarray(b.numpy())),
                                      axis=1)
    _, got = TR._scan(a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    h, seq = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), torch.stack(seq, 1).numpy(), rtol=1e-5, atol=1e-5)


def test_rglru_decode_matches_reference(block):
    jcfg, tcfg, jp, tp = block
    x = RNG.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jst = JR.init_rglru_state(jcfg, 2)
    conv, h = TR.init_rglru_state(tcfg, 2, "cpu")
    for t in range(5):
        xt = x[:, t:t + 1]
        ro, jst = JR.rglru_block(jp, jnp.asarray(xt).astype(jnp.bfloat16), jcfg, jst,
                                 decode=True)
        go, (conv, h) = TR.rglru_block(tp, torch.from_numpy(xt).to(torch.bfloat16), tcfg,
                                       (conv, h), decode=True)
        assert h.dtype == torch.float32 and conv.dtype == torch.bfloat16
        assert _max_ulps(np.asarray(ro.astype(jnp.float32)), go.float().numpy()) <= BLOCK_ULPS
        np.testing.assert_allclose(h.numpy(), np.asarray(jst[1]), rtol=2e-2, atol=1e-3)


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def model():
    """Reference and port: forward's logits and the scanned prefill's (one
    left-padded row); the reference engine's tokens for STREAM (solo
    admission), in the same scope as the reference's other work."""
    jcfg, tcfg = _cfgs()
    toks = RNG.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    start = np.array([0, 4], np.int32)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        h = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
        ref_fwd = np.asarray(JL.logits(jp["embed"], h, jcfg).astype(jnp.float32))
        lg, _ = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           JT.init_cache(jcfg, B, MAX_SEQ), jnp.asarray(start))
        ref = np.asarray(lg.astype(jnp.float32))
        jeng = JServeEngine(jcfg, jp, JServeConfig(max_batch=2, max_seq=MAX_SEQ))
        ref_toks = [np.asarray(r) for r in jeng.serve([JRequest(p, max_new=m)
                                                       for p, m in STREAM])]
    tp = TT.params_from_numpy(tree, tcfg, device="cpu")
    got_fwd = TL.logits(tp["head"], TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}))
    lg, _ = TT.prefill(tp, tcfg, torch.from_numpy(toks),
                       TT.init_cache(tcfg, B, MAX_SEQ, device="cpu"), torch.from_numpy(start))
    return (tcfg, jcfg, jp, tp, (ref_fwd, got_fwd.float().numpy()), ref, lg.float().numpy(),
            ref_toks)


def test_forward_logits_within_bound(model):
    cfg, _, _, _, (ref, got), _, _, _ = model
    ulps = _max_ulps(ref[..., :cfg.vocab], got[..., :cfg.vocab])
    print(f"forward: {ulps:.3g} bf16 ulps")
    assert np.isfinite(got).all() and ulps <= LOGIT_ULPS


def test_scanned_prefill_logits_within_bound(model):
    """The prefill is a decode step a position (the ring buffer, the RG-LRU
    state gated until each row's start)."""
    cfg, _, _, _, _, ref, got, _ = model
    ulps = _max_ulps(ref[..., :cfg.vocab], got[..., :cfg.vocab])
    print(f"prefill: {ulps:.3g} bf16 ulps")
    assert np.isfinite(got).all() and ulps <= LOGIT_ULPS


def test_param_tree_cache_and_refusals(model):
    cfg, _, _, tp, _, _, _, _ = model
    kinds = ["rec" in lay for lay in tp["layers"]]
    assert kinds == [True, True, False]
    assert tp["layers"][0]["rec"]["lam"].dtype == torch.float32
    w = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["layers"][0]["rec"]
    assert 2.0 <= float(w["lam"].min()) and float(w["lam"].max()) < 4.0
    cache = TT.init_cache(cfg, 3, 40, device="cpu")["layers_list"]
    assert tuple(cache[2]["k"].shape) == (3, 40, 1, 32)          # W = min(64, 40)
    assert tuple(cache[0]["conv"].shape) == (3, 3, 128) and cache[0]["h"].dtype == torch.float32
    with pytest.raises(ValueError, match="no pageable KV cache"):
        TT.init_paged_cache(cfg, 4, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="batch axis"):
        z = torch.zeros(1, 8, dtype=torch.int32)
        TT.prefill_packed(tp, cfg, z, TT.init_cache(cfg, 1, 8, device="cpu"), z, z,
                          torch.tensor([7]), 8)


def test_batch_ragged_prefill_is_solo_prefill(model):
    """``prefill_batch_ragged`` on right-padded rows at start 0 gives each
    row the logits of its solo prefill."""
    cfg, _, _, tp, _, _, _, _ = model
    rows = [RNG.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 9)]
    toks = np.zeros((2, 9), np.int32)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
    lg, _ = TT.prefill_batch_ragged(tp, cfg, torch.from_numpy(toks),
                                    TT.init_cache(cfg, 2, 9, device="cpu"),
                                    torch.zeros(2, dtype=torch.int32), torch.tensor([4, 8]))
    for i, r in enumerate(rows):
        solo, _ = TT.prefill(tp, cfg, torch.from_numpy(r[None]),
                             TT.init_cache(cfg, 1, 9, device="cpu"))
        assert torch.equal(lg[i], solo[0])


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def served(model):
    cfg, jcfg, jp, tp, _, _, _, ref = model
    packed = ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ,
                                              packed_prefill=True), device="cpu")
    outs = packed.serve([Request(p, max_new=m) for p, m in STREAM])
    return cfg, jcfg, jp, tp, packed, ref, outs


def test_engine_matches_reference_engine(served):
    cfg, jcfg, jp, _, packed, ref, outs = served
    st = packed.last_serve_stats
    assert st["packed_packs"] >= 1 and st["admissions"] == len(STREAM)
    # the last prompt is left-padded to a 64-row bucket, the whole ring: each
    # of its decode steps overwrites the ring's oldest row
    assert cfg.local_window == 64 and 32 < len(STREAM[-1][0]) <= 64
    _assert_tokens_match(jcfg, jp, STREAM, ref, outs, MAX_SEQ)


def test_solo_packed_midflight_and_paged_bit_identical(served):
    cfg, _, _, tp, _, _, outs = served
    solo = ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ), device="cpu")
    mid = solo.serve([Request(p, max_new=m) for p, m in STREAM])
    st = solo.last_serve_stats
    assert st["packed_packs"] == 0
    assert st["prefill_forwards"] == sum(max(8, 1 << (len(p) - 1).bit_length())
                                         for p, _ in STREAM)
    for (p, m), a, b in zip(STREAM, outs, mid):
        assert len(a) == m
        np.testing.assert_array_equal(a, b)
    # the longest request alone, its window wrapped, under kv_layout="paged"
    # (which serves the hybrid family from dense slots)
    paged = ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ, kv_layout="paged",
                                             packed_prefill=True), device="cpu")
    p, m = STREAM[-1]
    np.testing.assert_array_equal(paged.serve([Request(p, max_new=m)])[0], outs[-1])
    assert paged.last_serve_stats["kv_layout"] == "dense"


def test_snapshot_restore_gives_the_same_tokens(served):
    cfg, _, _, tp, _, _, outs = served
    make = lambda: ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ,
                                                    packed_prefill=True), device="cpu")
    eng = make()
    for p, m in STREAM:
        eng.submit(Request(p, max_new=m))
    stream = eng.serve_stream()
    before = [next(stream) for _ in range(8)]
    snap = eng.snapshot()
    assert isinstance(snap["cache"]["layers_list"][0]["h"], torch.Tensor)
    other = make()
    other.restore(snap)
    done = {ev.rid: ev.result.tokens for ev in before + list(other.serve_stream())
            if isinstance(ev, FinishEvent)}
    assert sorted(done) == list(range(len(STREAM)))
    for rid, toks in done.items():
        np.testing.assert_array_equal(toks, outs[rid])


# ------------------------------------------------------ the flash kernels


def test_tile_loop_twin_at_head_dim_256_matches_reference(ref_kernels):
    q = RNG.standard_normal((1, 96, 2, 256)).astype(np.float32)
    k = RNG.standard_normal((1, 96, 1, 256)).astype(np.float32)
    v = RNG.standard_normal((1, 96, 1, 256)).astype(np.float32)
    ref = np.asarray(jflash(JFmt(16), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                            40))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got, m, l = F.posit_flash_attention_fwd(PositFormat(16), *t, True, 40)
    err = float(np.abs(ref - got.numpy()).max())
    print(f"hd 256, window 40: max|twin - reference| = {err:.3g}")
    assert err <= FLASH_TOL
    np.testing.assert_array_equal(got.numpy(),
                                  F.posit_flash_attention(PositFormat(16), *t, True, 40).numpy())
    assert float(l.max()) <= 40.0


def test_decode_loop_and_backward_refuse_head_dim_above_128(monkeypatch):
    """On a tensor the kernels would take (here on the meta device, which
    reaches the kernel path on this host), head_dim 256 raises ValueError
    naming ROADMAP before any library is loaded: no launch, no twin."""
    def no_load(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(F._build, "load", no_load)
    fmt = PositFormat(16)
    meta = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device="meta")
    q, kv = meta(2, 1, 2, 256), meta(2, 64, 1, 256, dt=torch.bfloat16)
    pos = torch.tensor([5, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="decode loop.*ROADMAP"):
        F.posit_flash_attention(fmt, q, kv, kv, True, q_pos=pos, kv_len=pos + 1)
    pool = meta(4, 16, 1, 256, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="decode loop.*ROADMAP"):
        F.posit_flash_attention(fmt, q, pool, pool, True, q_pos=pos, kv_len=pos + 1,
                                block_tables=torch.ones(2, 4, dtype=torch.int32))
    qs, ks = meta(1, 16, 2, 256), meta(1, 16, 1, 256)
    ml = meta(2, 16)
    with pytest.raises(ValueError, match="backward.*ROADMAP"):
        F.flash_backward(fmt, qs, ks, ks, qs, qs, ml, ml)
    seg = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="packed.*ROADMAP"):
        F.posit_flash_attention(fmt, qs, ks, ks, True, seg_q=seg, seg_kv=seg, seg_len=16)
    assert F.head_dim_max("dense", F.TILE_LOOP) == 256
    assert F.head_dim_max("dense", F.ROW_LOOP) == F.head_dim_max("backward") == 128
