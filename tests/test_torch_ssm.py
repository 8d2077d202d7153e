"""The port's ssm family (Mamba2: the chunked SSD, per-slot conv and SSM
state) against the reference on the smoke config.

Held against the reference, with its Pallas kernels in interpret mode:
``mamba2_block`` whole-sequence at S = 128 (chunks of 64) and S = 96 (the
chunk rule picks 48), and decode over several steps with its ``(conv, h)``
state (each within BLOCK_ULPS bf16 ulps of the output's largest magnitude:
the port keeps the reference's dtypes and op order, so they differ only
where the two libraries' ``exp`` or product sums round apart; the decode's
state within STATE_RTOL); ``forward``'s logits and the scanned prefill's
(LOGIT_ULPS, as every family's); the engine's greedy tokens (a difference
allowed only where the reference's top-2 margin is within that bound).  In
the port: decode step by step against its own ``forward`` with f32 compute
(DECODE_RTOL, the reference's ``test_decode_matches_forward``), the batch
prefill's rows against solo prefills, solo = packed = mid-flight =
``kv_layout="paged"`` (dense slots) = snapshot-restored tokens, a decode
state of the same bytes at any ``max_seq``, the launcher, and the
refusals (the paged cache, training).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401  (fixtures)
    _assert_tokens_match, bf16_ulp, one_torch_thread, reference_kernels)
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import FinishEvent, Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.usefixtures("one_torch_thread")
LOGIT_ULPS = 8          # as tests/test_torch_model.py
BLOCK_ULPS = 2          # mamba2_block's output (measured 0.004-0.5 whole-sequence, 0 decode)
STATE_RTOL = 1e-6       # the decode's f32 state, of its largest magnitude (measured 1.1e-7)
DECODE_RTOL = 2e-3      # decode against forward, f32 compute (the reference's bound)
B, S, MAX_SEQ = 2, 12, 64
RNG = np.random.default_rng(30)
# prompt lengths and budgets: solo admission left-pads them to 8, 8 and 32
STREAM = [(RNG.integers(0, 512, n).astype(np.int32), m)
          for n, m in [(3, 6), (7, 4), (20, 6)]]


def _cfgs():
    return jget("mamba2_2p7b", smoke=True, fused=True), tget("mamba2_2p7b", smoke=True)


def _max_ulps(ref, got):
    return float(np.abs(ref - got).max()) / bf16_ulp(np.abs(ref).max())


# ------------------------------------------------------------ the config


def test_config_and_registry():
    jfull, full = jget("mamba2-2.7b"), tget("mamba2-2.7b")
    fields = ("name", "family", "n_layers", "d_model", "vocab", "padded_vocab", "ssm_state",
              "ssm_expand", "ssm_headdim", "ssm_chunk", "ssm_groups", "conv_width", "d_inner",
              "ssm_heads", "sub_quadratic", "tie_embeddings", "norm_eps")
    assert {f: getattr(full, f) for f in fields} == {f: getattr(jfull, f) for f in fields}
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_heads, full.ssm_headdim,
            full.ssm_state, full.ssm_groups, full.ssm_chunk, full.conv_width, full.vocab,
            full.padded_vocab) == (64, 2560, 5120, 80, 64, 128, 1, 256, 4, 50280, 50432)
    _, cfg = _cfgs()
    jcfg = jget("mamba2_2p7b", smoke=True)
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert full.sub_quadratic and not tget("smollm-360m").sub_quadratic
    with pytest.raises(ValueError, match="ssm_headdim dividing d_inner"):
        full.replace(ssm_headdim=48)
    with pytest.raises(ValueError, match="ssm_groups dividing the heads"):
        full.replace(ssm_groups=3)


# ------------------------------------------------------------ the block


@pytest.fixture(scope="module")
def block():
    """The reference's block with its biases, gated norm and conv bias
    drawn away from their init (zeros), so every term is exercised."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    jp = JM.init_mamba2_block(jax.random.PRNGKey(1), jcfg)
    jp = dict(jp, **{k: jnp.asarray(rng.normal(m, s, jp[k].shape), jnp.float32)
                     for k, m, s in (("dt_bias", -1.0, 1.0), ("norm_w", 0.0, 0.1),
                                     ("conv_b", 0.0, 0.1), ("D", 1.0, 0.3))})
    tp = {k: torch.from_numpy(np.array(v)).to(torch.float32 if k in TT._F32_LEAVES
                                             else torch.bfloat16) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("seq", [128, 96])
def test_block_matches_reference(block, seq):
    """Whole-sequence: two chunks of 64 at S = 128; at S = 96 the chunk
    rule ``while S % Q: Q -= 1`` picks 48."""
    jcfg, tcfg, jp, tp = block
    x = RNG.standard_normal((2, seq, tcfg.d_model)).astype(np.float32)
    with reference_kernels():
        ref = np.asarray(JM.mamba2_block(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
                         .astype(jnp.float32))
    got = TM.mamba2_block(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16
    ulps = _max_ulps(ref, got.float().numpy())
    print(f"S = {seq}: {ulps:.3g} bf16 ulps of max|y|")
    assert ulps <= BLOCK_ULPS


def test_scan_add_is_associative_scans():
    x = torch.from_numpy(RNG.standard_normal((37, 3, 5)).astype(np.float32))
    ref = jax.lax.associative_scan(jnp.add, jnp.asarray(x.numpy()), axis=0)
    np.testing.assert_array_equal(TM._scan_add(x).numpy(), np.asarray(ref))
    np.testing.assert_allclose(TM._scan_add(x).numpy(), torch.cumsum(x, 0).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_decode_matches_reference(block):
    jcfg, tcfg, jp, tp = block
    x = RNG.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    jst = JM.init_mamba2_state(jcfg, 2)
    conv, h = TM.init_mamba2_state(tcfg, 2, "cpu")
    assert (tuple(conv.shape), tuple(h.shape)) == ((2, 3, 256 + 2 * 16), (2, 8, 16, 32))
    worst = {"y": 0.0, "h": 0.0}
    with reference_kernels():
        for t in range(6):
            xt = x[:, t:t + 1]
            ro, jst = JM.mamba2_block(jp, jnp.asarray(xt).astype(jnp.bfloat16), jcfg, jst,
                                      decode=True)
            go, (conv, h) = TM.mamba2_block(tp, torch.from_numpy(xt).to(torch.bfloat16), tcfg,
                                            (conv, h), decode=True)
            assert h.dtype == torch.float32 and conv.dtype == torch.bfloat16
            np.testing.assert_array_equal(conv.float().numpy(),
                                          np.asarray(jst[0].astype(jnp.float32)))
            jh = np.asarray(jst[1])
            worst["y"] = max(worst["y"], _max_ulps(np.asarray(ro.astype(jnp.float32)),
                                                   go.float().numpy()))
            worst["h"] = max(worst["h"], float(np.abs(h.numpy() - jh).max() / np.abs(jh).max()))
    print(f"decode: {worst['y']:.3g} bf16 ulps of max|y|, state {worst['h']:.3g} of max|h|")
    assert worst["y"] <= BLOCK_ULPS and worst["h"] <= STATE_RTOL


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def model():
    """Reference and port: forward's logits and the scanned prefill's (one
    left-padded row); the reference engine's tokens for STREAM (solo
    admission), in one scope of the reference's kernels."""
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
    """The prefill is a decode step a position, the state gated until each
    row's start."""
    cfg, _, _, _, _, ref, got, _ = model
    ulps = _max_ulps(ref[..., :cfg.vocab], got[..., :cfg.vocab])
    print(f"prefill: {ulps:.3g} bf16 ulps")
    assert np.isfinite(got).all() and ulps <= LOGIT_ULPS


def test_param_tree_and_cache(model):
    cfg, _, _, tp, _, _, _, _ = model
    lay = tp["layers"][0]
    assert sorted(lay) == ["ln1", "ssm"]
    assert lay["ssm"]["A_log"].dtype == torch.float32
    assert lay["ssm"]["in_proj"].dtype == torch.bfloat16
    assert tuple(lay["ssm"]["in_proj"].shape) == (128, 2 * 256 + 2 * 16 + 8)
    w = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")["layers"][1]["ssm"]
    np.testing.assert_allclose(w["A_log"].numpy(), np.log(np.arange(1, 9)), rtol=1e-6)
    assert sorted(w) == sorted(lay["ssm"])
    cache = TT.init_cache(cfg, 3, 40, device="cpu")
    assert tuple(cache["layers"]["conv"].shape) == (2, 3, 3, 288)
    assert tuple(cache["layers"]["h"].shape) == (2, 3, 8, 16, 32)
    assert cache["layers"]["h"].dtype == torch.float32
    assert [t.shape for t in TT.cache_leaves(cache)] == [cache["layers"]["conv"].shape,
                                                         cache["layers"]["h"].shape]


def test_decode_state_size_is_independent_of_max_seq():
    """The long_500k property (``sub_quadratic``): the cache at max_seq
    524288 has exactly the bytes it has at 512."""
    cfg = tget("mamba2-2.7b").replace(n_layers=1)
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in TT.cache_leaves(c))
    small = TT.init_cache(cfg, 1, 512, device="meta")
    assert nbytes(TT.init_cache(cfg, 1, 524288, device="meta")) == nbytes(small)
    assert nbytes(small) == 3 * 5376 * 2 + 80 * 128 * 64 * 4


def test_decode_matches_forward_with_f32_compute(monkeypatch):
    """Decode step by step reproduces the whole-sequence forward (the
    chunked SSD) with f32 compute, as the reference's own test checks."""
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    _, cfg = _cfgs()
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                            dtype=torch.float32)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 32)).astype(np.int32))
    full = TL.logits(params["head"], TT.forward(params, cfg.replace(remat="none"),
                                                {"tokens": toks})).float()
    cache = TT.init_cache(cfg, 2, 32, device="cpu", dtype=torch.float32)
    steps = []
    for i in range(32):
        lg, cache = TT.decode_step(params, cfg, cache, toks[:, i:i + 1],
                                   torch.full((2,), i, dtype=torch.int32))
        steps.append(lg.float())
    err = float((torch.cat(steps, 1) - full).abs().max())
    scale = float(full.abs().max())
    print(f"decode vs forward: {err / scale:.3g} of max|logit|")
    assert err / scale < DECODE_RTOL


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


def test_refusals(model):
    """What the ssm family refuses: a paged cache (its state does not grow
    with the context), a paged decode, the concatenated pack (its packs lie
    on the batch axis) and training (the next slice)."""
    cfg, _, _, tp, _, _, _, _ = model
    with pytest.raises(ValueError, match="no pageable KV cache"):
        TT.init_paged_cache(cfg, 4, 16, device="cpu")
    z = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no paged KV cache layout"):
        TT.decode_step(tp, cfg, TT.init_cache(cfg, 1, 8, device="cpu"), z,
                       torch.zeros(1, dtype=torch.int32), block_tables=z)
    with pytest.raises(NotImplementedError, match="batch axis"):
        z8 = torch.zeros(1, 8, dtype=torch.int32)
        TT.prefill_packed(tp, cfg, z8, TT.init_cache(cfg, 1, 8, device="cpu"), z8, z8,
                          torch.tensor([7]), 8)
    with pytest.raises(NotImplementedError, match="ssm family.*ROADMAP"):
        TT.train_loss(tp, cfg, {"tokens": torch.zeros(1, 8, dtype=torch.int32)})


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
    _assert_tokens_match(jcfg, jp, STREAM, ref, outs, MAX_SEQ)


def test_solo_packed_and_midflight_bit_identical(served):
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


def test_paged_layout_falls_back_to_dense_slots(served):
    """``kv_layout="paged"`` serves the ssm family from dense slots, with
    the dense engine's tokens (the reference's
    ``test_paged_recurrent_families_fall_back``)."""
    cfg, _, _, tp, _, _, outs = served
    paged = ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ, kv_layout="paged",
                                             block_size=8, packed_prefill=True), device="cpu")
    assert not paged._paged
    got = paged.serve([Request(p, max_new=m) for p, m in STREAM])
    for a, b in zip(outs, got):
        np.testing.assert_array_equal(a, b)
    assert paged.last_serve_stats["kv_layout"] == "dense"


def test_snapshot_restore_gives_the_same_tokens(served):
    cfg, _, _, tp, _, _, outs = served
    make = lambda: ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ,
                                                    packed_prefill=True), device="cpu")
    eng = make()
    for p, m in STREAM:
        eng.submit(Request(p, max_new=m))
    stream = eng.serve_stream()
    before = [next(stream) for _ in range(6)]
    snap = eng.snapshot()
    assert snap["cache"]["layers"]["h"].device.type == "cpu"
    assert snap["cache"]["layers"]["h"].dtype == torch.float32
    other = make()
    other.restore(snap)
    done = {ev.rid: ev.result.tokens for ev in before + list(other.serve_stream())
            if isinstance(ev, FinishEvent)}
    assert sorted(done) == list(range(len(STREAM)))
    for rid, toks in done.items():
        np.testing.assert_array_equal(toks, outs[rid])


def test_launcher_serves_mamba2_smoke(capsys):
    got = serve_main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu", "--requests",
                      "3", "--batch", "2", "--max-new", "3", "--max-seq", "32",
                      "--kv-layout", "paged", "--packed-prefill"])
    assert len(got["outputs"]) == 3 and all(1 <= len(o) <= 3 for o in got["outputs"])
    assert got["stats"]["kv_layout"] == "dense"
    assert "# continuous: 3 requests" in capsys.readouterr().out
