"""Serving from a posit KV cache (``NumericsConfig.kv_cache_format``) on the
CPU (K12's twin rounds every K/V row).

* the format must fit a 32-bit word, with the reference's message;
* the smoke SmolLM (posit16 and posit8 caches) and the smoke OLMoE (posit8)
  give the reference engine's greedy tokens (dense slots; a difference is
  allowed only where the reference's top-2 margin is within the model
  test's logit bound, as in tests/test_torch_serve.py);
* the paged pool with packed prefill gives the dense slots' tokens and
  shares no prefix (hit rate 0, no lookups), as the reference's engine
  turns sharing off under the format;
* every cache row written is a fixed point of the rounding, and the format
  changes what is cached.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_ulp, bits, one_torch_thread, reference_kernels  # noqa: F401  (fixture)
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.numerics import NumericsConfig as JNumerics
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.core.posit import PositFormat
from repro_torch.models import transformer as TT
from repro_torch.numerics import NumericsConfig
from repro_torch.numerics.quant import posit_round_value
from repro_torch.serve import Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOGIT_ULPS = 8      # as tests/test_torch_model.py
MAX_SEQ = 64
RNG = np.random.default_rng(31)
# _PA spans two blocks of 8 and more; _PB shares its first two blocks
_PA = RNG.integers(0, 512, 19).astype(np.int32)
_PB = np.concatenate([_PA[:16], [99, 98, 97]]).astype(np.int32)
STREAM = [(_PA, 5), (RNG.integers(0, 512, 3).astype(np.int32), 3), (_PB, 4),
          (RNG.integers(0, 512, 9).astype(np.int32), 4), (_PA.copy(), 3)]


def test_kv_cache_format_must_fit_a_word():
    NumericsConfig(kv_cache_format="posit16").validate()
    NumericsConfig(kv_cache_format="posit8").validate()
    with pytest.raises(ValueError) as got:
        NumericsConfig(kv_cache_format="posit64").validate()
    with pytest.raises(ValueError) as want:
        JNumerics(kv_cache_format="posit64").validate()
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="unknown posit format"):
        NumericsConfig(kv_cache_format="posit12").validate()
    cfg = tget("smollm_360m", smoke=True).with_numerics(kv_cache_format="posit8")
    assert cfg.numerics == dataclasses.replace(NumericsConfig(), kv_cache_format="posit8")


def _margin_ok(jcfg, jp, prompt, ref, got):
    """True where the port's tokens are the reference's, or first differ
    where the reference's top-2 margin is within the logit bound."""
    if np.array_equal(ref, got):
        return True
    j = int(np.flatnonzero(ref != got)[0])
    with reference_kernels():
        seq = jnp.asarray(np.concatenate([prompt, ref[:j]])[None])
        lg, _ = JT.prefill(jp, jcfg, {"tokens": seq}, JT.init_cache(jcfg, 1, MAX_SEQ))
    row = np.asarray(lg[0, -1, :jcfg.vocab].astype(jnp.float32))
    top2 = np.sort(row)[-2:]
    print(f"token {j} differs; reference top-2 margin {top2[1] - top2[0]:.4g}")
    return top2[1] - top2[0] <= LOGIT_ULPS * bf16_ulp(np.abs(row).max())


def _served(arch, fmt, stream, **sc):
    jcfg = jget(arch, smoke=True, fused=True).with_numerics(kv_cache_format=fmt)
    tcfg = tget(arch, smoke=True).with_numerics(kv_cache_format=fmt)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        jeng = JServeEngine(jcfg, jp, JServeConfig(max_batch=2, max_seq=MAX_SEQ, **sc))
        ref = [np.asarray(r) for r in jeng.serve([JRequest(p, max_new=m) for p, m in stream])]
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    eng = ServeEngine(tcfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ, **sc), device="cpu")
    outs = eng.serve([Request(p, max_new=m) for p, m in stream])
    return jcfg, jp, tcfg, tp, ref, outs


@pytest.fixture(scope="module")
def smollm16():
    return _served("smollm_360m", "posit16", STREAM)


@pytest.mark.parametrize("fmt", ["posit16", "posit8"])
def test_dense_engine_matches_reference(request, fmt):
    jcfg, jp, _, _, ref, outs = (request.getfixturevalue("smollm16") if fmt == "posit16"
                                 else _served("smollm_360m", fmt, STREAM[:3]))
    for (p, m), r, g in zip(STREAM, ref, outs):
        assert len(g) == m
        assert _margin_ok(jcfg, jp, p, r, g)


def test_moe_posit8_matches_reference():
    stream = [(p[:12], 3) for p, _ in STREAM[:2]]
    jcfg, jp, _, _, ref, outs = _served("olmoe_1b_7b", "posit8", stream, packed_prefill=True)
    for (p, m), r, g in zip(stream, ref, outs):
        assert len(g) == m
        assert _margin_ok(jcfg, jp, p, r, g)


def test_paged_packed_equals_dense_without_sharing(smollm16):
    _, _, cfg, tp, _, dense = smollm16
    sc = ServeConfig(max_batch=2, max_seq=MAX_SEQ, kv_layout="paged", block_size=8,
                     packed_prefill=True)
    eng = ServeEngine(cfg, tp, sc, device="cpu")
    outs = eng.serve([Request(p, max_new=m) for p, m in STREAM])
    st = eng.last_serve_stats
    for a, b in zip(outs, dense):
        np.testing.assert_array_equal(a, b)
    assert st["prefix_hit_rate"] == 0 and st["prefix_hit_tokens"] == 0
    assert st["prefix_lookups"] == 0 and st["shared_blocks"] == 0
    assert st["packed_packs"] >= 1
    # without the format the same stream does share _PA's blocks
    plain = ServeEngine(tget("smollm_360m", smoke=True), tp, sc, device="cpu")
    plain.serve([Request(p, max_new=m) for p, m in STREAM])
    assert plain.last_serve_stats["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("fmt", ["posit16", "posit8"])
def test_cached_rows_are_posit_grid_values(smollm16, fmt):
    _, _, cfg, tp, _, _ = smollm16
    cfg = cfg.with_numerics(kv_cache_format=fmt)
    toks = torch.from_numpy(STREAM[0][0][None].astype(np.int64))
    S = toks.shape[1]
    cache = TT.init_cache(cfg, 1, MAX_SEQ, device="cpu")
    lg, cache = TT.prefill(tp, cfg, toks, cache)
    pos = torch.tensor([S], dtype=torch.int32)
    TT.decode_step(tp, cfg, cache, torch.tensor([[7]]), pos)
    rows = torch.cat([cache["k"][:, :, :S + 1], cache["v"][:, :, :S + 1]]).float()
    again = posit_round_value(PositFormat(int(fmt[5:])), rows)
    np.testing.assert_array_equal(bits(again), bits(rows))
    plain = tget("smollm_360m", smoke=True)
    ref = TT.prefill(tp, plain, toks, TT.init_cache(plain, 1, MAX_SEQ, device="cpu"))[1]
    changed = int((ref["k"][:, :, :S] != cache["k"][:, :, :S]).sum())
    if fmt == "posit8":       # posit16 holds most bf16 values exactly
        assert changed > 0
    assert torch.isfinite(lg).all()
