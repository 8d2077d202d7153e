"""The port's dense model against the reference on the smoke config.

Both run the same weights (the reference's ``T.init_params`` at PRNGKey(0),
handed to the port through ``params_from_numpy``) and the same tokens.
Prefill logits and three teacher-forced decode steps agree within
LOGIT_ULPS bf16 ulps of max|logit| (the bf16 products and the f32 means
round in another order); greedy tokens agree wherever the reference's
top-2 margin exceeds that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_ulp, reference_kernels
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as TT

LOGIT_ULPS = 8
B, S, MAX_SEQ = 2, 12, 32


@pytest.fixture(scope="module")
def runs():
    """Reference and port logits: prefill, then 3 teacher-forced steps."""
    rng = np.random.default_rng(0)
    jcfg = jget("smollm_360m", smoke=True, fused=True)
    tcfg = tget("smollm_360m", smoke=True, fused=True)
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    nxt = rng.integers(0, tcfg.vocab, (3, B, 1)).astype(np.int32)
    start = np.array([0, 4], np.int32)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        lg, c = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           JT.init_cache(jcfg, B, MAX_SEQ), jnp.asarray(start))
        ref = [np.asarray(lg.astype(jnp.float32))]
        for i in range(3):
            lg, c = JT.decode_step(jp, jcfg, c, jnp.asarray(nxt[i]),
                                   jnp.full((B,), S + i, jnp.int32), jnp.asarray(start))
            ref.append(np.asarray(lg.astype(jnp.float32)))
    tp = TT.params_from_numpy(tree, tcfg, device="cpu")
    st = torch.from_numpy(start)
    lg, c = TT.prefill(tp, tcfg, torch.from_numpy(toks),
                       TT.init_cache(tcfg, B, MAX_SEQ, device="cpu"), st)
    got = [lg.float().numpy()]
    for i in range(3):
        lg, c = TT.decode_step(tp, tcfg, c, torch.from_numpy(nxt[i]),
                               torch.full((B,), S + i, dtype=torch.int32), st)
        got.append(lg.float().numpy())
    return tcfg, ref, got


def _bound(ref):
    return LOGIT_ULPS * bf16_ulp(np.abs(ref).max())


@pytest.mark.parametrize("step", [0, 1, 2, 3], ids=["prefill", "decode1", "decode2",
                                                     "decode3"])
def test_logits_within_bound(runs, step):
    cfg, ref, got = runs
    r, g = ref[step][..., :cfg.vocab], got[step][..., :cfg.vocab]
    err = float(np.abs(r - g).max())
    print(f"step {step}: max|port - reference| = {err:.4g}, bound {_bound(r):.4g}")
    assert np.isfinite(g).all()
    assert err <= _bound(r)


@pytest.mark.parametrize("step", [0, 1, 2, 3], ids=["prefill", "decode1", "decode2",
                                                     "decode3"])
def test_greedy_tokens_agree_where_margin_exceeds_bound(runs, step):
    cfg, ref, got = runs
    r, g = ref[step][:, -1, :cfg.vocab], got[step][:, -1, :cfg.vocab]
    top2 = np.sort(r, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    clear = margin > _bound(r)
    differ = r.argmax(-1) != g.argmax(-1)
    assert not (differ & clear).any()
    if differ.any():
        print(f"step {step}: greedy token differs in rows {np.flatnonzero(differ)} "
              f"with reference margins {margin[differ]}")


def test_entry_points_default_to_cuda():
    """Without device= every entry point asks for the card, and raises
    without one; only device='cpu' runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tget("smollm_360m", smoke=True, fused=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(cfg, torch.Generator().manual_seed(0))
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["layers"][0]["wq"].device.type == "cpu"


def test_config_registry():
    cfg = tget("smollm-360m", fused=True)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab) == (32, 960, 15, 5, 64, 2560, 49152)
    assert cfg.numerics.div_format == "posit16"
    assert cfg.numerics.div_algo == "srt_r4_cs_of_fr"
    assert (cfg.serve_max_batch, cfg.serve_max_seq) == (8, 512)
    assert tget("smollm_360m", max_batch=3, max_seq=64).serve_max_batch == 3
    with pytest.raises(KeyError, match="not ported"):
        tget("granite_8b")
    assert tget("smollm_360m") == cfg
    with pytest.raises(NotImplementedError, match="fused"):
        tget("smollm_360m", fused=False)
