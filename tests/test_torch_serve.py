"""The port's serve engine on the CPU (smoke config, 2 slots).

Greedy tokens are the same bits solo, in a static batch (generate) and
admitted mid-flight, and match the reference engine's, a difference being
allowed only where the reference's top-2 margin is within the model test's
logit bound.  At ``div_format="posit64"`` (every RMSNorm and attention
divide on the two-word datapath) and at ``"posit32"`` the prefill and
decode logits are within that bound of the reference's fused forward and
the greedy tokens are the reference engine's (by the same rule); at
posit64 another plan's paged and packed engines serve the dense engine's
tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401  (fixtures)
    LOGIT_ULPS, _assert_tokens_match, bf16_ulp, one_torch_thread, reference_kernels)
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.serve import FinishReason, Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(3)
STREAM = [(RNG.integers(0, 512, n).astype(np.int32), m)
          for n, m in [(3, 6), (7, 2), (12, 4), (5, 5), (9, 3)]]


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("smollm_360m", smoke=True, fused=True)
    tcfg = tget("smollm_360m", smoke=True, fused=True)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        ref = JServeEngine(jcfg, jp, JServeConfig(max_batch=2, max_seq=64)).serve(
            [JRequest(p, max_new=m) for p, m in STREAM])
        ref = [np.asarray(r) for r in ref]
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    eng = ServeEngine(tcfg, tp, ServeConfig(max_batch=2, max_seq=64), device="cpu")
    mid = eng.serve([Request(p, max_new=m) for p, m in STREAM])
    return jcfg, jp, eng, ref, mid


def test_solo_static_and_midflight_bit_identical(setup):
    _, _, eng, _, mid = setup
    assert eng.last_serve_stats["admissions"] == len(STREAM)
    for (p, m), out in zip(STREAM, mid):
        assert len(out) == m
        np.testing.assert_array_equal(eng.serve([Request(p, max_new=m)])[0], out)
        np.testing.assert_array_equal(eng.generate([p], max_new=m)[0], out)
    static = eng.generate([STREAM[0][0], STREAM[2][0]], max_new=4)
    np.testing.assert_array_equal(static[0], mid[0][:4])
    np.testing.assert_array_equal(static[1], mid[2][:4])


def test_matches_reference_engine(setup):
    jcfg, jp, _, ref, mid = setup
    _assert_tokens_match(jcfg, jp, STREAM, ref, mid, 64)


def test_sampled_requests_reproduce(setup):
    _, _, eng, _, _ = setup
    reqs = [Request(p, max_new=m, temperature=0.8, seed=100 + i)
            for i, (p, m) in enumerate(STREAM)]
    batched = eng.serve(reqs)
    for r, out in zip(reqs, batched):
        np.testing.assert_array_equal(eng.serve([r])[0], out)
    assert all(len(o) == r.max_new for r, o in zip(reqs, batched))


def test_eos_shed_and_strict(setup):
    _, _, eng, _, mid = setup
    first = int(mid[0][0])
    outs = eng.serve([Request(STREAM[0][0], max_new=6, eos_id=first),
                      Request(np.zeros(0, np.int32)),
                      Request(np.ones(64, np.int32))])
    assert outs[0].tolist() == [first]
    assert [r.finish for r in eng.last_results] == [
        FinishReason.EOS, FinishReason.SHED, FinishReason.SHED]
    with pytest.raises(ValueError, match="empty"):
        eng.serve([Request(np.zeros(0, np.int32))], strict=True)
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate([STREAM[0][0]] * 3, strict=True)
    assert eng.generate([STREAM[0][0]] * 3, max_new=2)[2].size == 0
    assert eng.last_results[2].finish is FinishReason.SHED


def test_engine_defaults_to_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, eng, _, _ = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(eng.cfg, eng.params)


def test_non_finite_logits_are_quarantined(setup):
    """A NaN anywhere in the datapath shows in logits_health: the request
    finishes FAULT at admission and nothing is emitted for it."""
    _, _, eng, _, _ = setup
    params = dict(eng.params, ln_f=torch.full_like(eng.params["ln_f"], float("nan")))
    bad = ServeEngine(eng.cfg, params, eng.sc, device="cpu")
    outs = bad.serve([Request(p, max_new=m) for p, m in STREAM[:2]])
    assert [o.size for o in outs] == [0, 0]
    assert all(r.finish is FinishReason.FAULT for r in bad.last_results)
    assert bad.last_serve_stats["faults"] == 2


P64_STREAM = [(RNG.integers(0, 512, n).astype(np.int32), m) for n, m in [(3, 4), (7, 3), (5, 4)]]


@pytest.fixture(scope="module")
def posit64():
    """The smoke config at posit64: the reference engine's tokens and its
    prefill / decode logits, the port's on the same weights."""
    return _format_run("posit64", RNG)


@pytest.fixture(scope="module")
def posit32():
    """The same at posit32 srt_r4_cs_of_fr (one-word residual)."""
    return _format_run("posit32", np.random.default_rng(32))


def _format_run(div_format, rng):
    jcfg = jget("smollm_360m", smoke=True, fused=True).with_numerics(div_format=div_format)
    tcfg = tget("smollm_360m", smoke=True, fused=True).with_numerics(div_format=div_format)
    toks = rng.integers(0, tcfg.vocab, (2, 9)).astype(np.int32)
    nxt = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
    start = np.array([0, 3], np.int32)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        ref = JServeEngine(jcfg, jp, JServeConfig(max_batch=2, max_seq=32)).serve(
            [JRequest(p, max_new=m) for p, m in P64_STREAM])
        ref = [np.asarray(r) for r in ref]
        lg, c = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           JT.init_cache(jcfg, 2, 32), jnp.asarray(start))
        jl = [np.asarray(lg.astype(jnp.float32))]
        lg, _ = JT.decode_step(jp, jcfg, c, jnp.asarray(nxt), jnp.full((2,), 9, jnp.int32),
                               jnp.asarray(start))
        jl.append(np.asarray(lg.astype(jnp.float32)))
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    st = torch.from_numpy(start)
    lg, c = TT.prefill(tp, tcfg, torch.from_numpy(toks),
                       TT.init_cache(tcfg, 2, 32, device="cpu"), st)
    tl = [lg.float().numpy()]
    lg, _ = TT.decode_step(tp, tcfg, c, torch.from_numpy(nxt),
                           torch.full((2,), 9, dtype=torch.int32), st)
    tl.append(lg.float().numpy())
    eng = ServeEngine(tcfg, tp, ServeConfig(max_batch=2, max_seq=32), device="cpu")
    got = eng.serve([Request(p, max_new=m) for p, m in P64_STREAM])
    return jcfg, jp, tcfg, tp, ref, got, jl, tl


@pytest.mark.parametrize("check", ["logits", "tokens"])
def test_posit64_matches_reference(posit64, check):
    jcfg, jp, cfg, tp, ref, got, jl, tl = posit64
    if check == "logits":
        _assert_logits_match(cfg, jl, tl)
        return
    _assert_tokens_match(jcfg, jp, P64_STREAM, ref, got, 32)
    # K4 / K5 are built for every posit64 plan: srt_r2_cs_of_fr serves from
    # the paged pool and with packed admission, and its divides are exact,
    # so its tokens are the default plan's dense engine's, bit for bit
    cfg_r2 = cfg.with_numerics(div_algo="srt_r2_cs_of_fr")
    for paged, packed in (("paged", False), ("dense", True)):
        sc = ServeConfig(max_batch=2, max_seq=32, kv_layout=paged, packed_prefill=packed)
        ServeEngine(cfg, tp, sc, device="cpu")
        out = ServeEngine(cfg_r2, tp, sc, device="cpu").serve(
            [Request(p, max_new=m) for p, m in P64_STREAM])
        for a, b in zip(out, got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("check", ["logits", "tokens"])
def test_posit32_matches_reference(posit32, check):
    """Posit32 (K3 and K2 on the one-word residual): logits and the
    reference engine's tokens; its paged and packed engines are accepted."""
    jcfg, jp, cfg, tp, ref, got, jl, tl = posit32
    if check == "logits":
        _assert_logits_match(cfg, jl, tl)
        return
    _assert_tokens_match(jcfg, jp, P64_STREAM, ref, got, 32)
    for paged, packed in (("paged", False), ("dense", True)):
        sc = ServeConfig(max_batch=2, max_seq=32, kv_layout=paged, packed_prefill=packed)
        ServeEngine(cfg, tp, sc, device="cpu")


def _assert_logits_match(cfg, jl, tl):
    for r, g in zip(jl, tl):
        r, g = r[..., :cfg.vocab], g[..., :cfg.vocab]
        assert np.isfinite(g).all()
        assert float(np.abs(r - g).max()) <= LOGIT_ULPS * bf16_ulp(np.abs(r).max())
