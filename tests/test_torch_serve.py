"""The port's serve engine on the CPU (smoke config, 2 slots).

Greedy tokens are the same bits solo, in a static batch (generate) and
admitted mid-flight, and match the reference engine's, a difference being
allowed only where the reference's top-2 margin is within the model test's
logit bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_ulp, reference_kernels
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.serve import FinishReason, Request, ServeConfig, ServeEngine

LOGIT_ULPS = 8      # as tests/test_torch_model.py
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
    for (p, _), r, g in zip(STREAM, ref, mid):
        if np.array_equal(r, g):
            continue
        j = int(np.flatnonzero(r != g)[0])      # first differing token
        with reference_kernels():
            seq = jnp.asarray(np.concatenate([p, r[:j]])[None])
            lg, _ = JT.prefill(jp, jcfg, {"tokens": seq},
                               JT.init_cache(jcfg, 1, 64))
        row = np.asarray(lg[0, -1, :jcfg.vocab].astype(jnp.float32))
        top2 = np.sort(row)[-2:]
        print(f"token {j} differs; reference top-2 margin {top2[1] - top2[0]:.4g}")
        assert top2[1] - top2[0] <= LOGIT_ULPS * bf16_ulp(np.abs(row).max())


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
