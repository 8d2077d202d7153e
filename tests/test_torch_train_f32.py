"""The gradient gap of tests/test_torch_train.py is bf16 rounding, not the
kernels: with the compute dtype f32 in both packages the port's loss and
gradients come within F32_LOSS_RTOL (1e-5) and F32_GRAD_REL_L2 (2^-10, one
posit16 step) of the reference's (observed worst leaves 2.8e-5-1.9e-4 and
loss errors below 2.5e-6 over seeds 0-2), at posit16 and posit64.  Also
AdamW and the schedules against the reference's (within 1e-6 relative: the
same f32 formulas) and the synthetic batches (bit-equal: the same numpy
code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from _torch_train import F32_GRAD_REL_L2, F32_LOSS_RTOL, _vs_reference, smoke_cfg  # noqa: F401
from repro.configs import get_config as jget
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models import layers as JL
from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import layers as L
from repro_torch.optim import adamw as A
from repro_torch.optim import schedule as S
from repro_torch.optim.tree import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("remat,masked", [("full", False), ("none", True)],
                         ids=["remat_full", "remat_none_loss_mask"])
def test_f32_compute_grads_match_reference(monkeypatch, remat, masked, seed):
    """The gradient gap of the bf16 test is bf16 rounding, not the kernels:
    with the compute dtype f32 in both packages (their ``COMPUTE_DTYPE``,
    read where the embedding casts), the gap falls a hundredfold, to what
    posit16 quantization flips leave."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    rel, errs, _, grads = _vs_reference(remat, masked, seed)
    assert grads["layers"][0]["wq"].dtype == torch.float32
    assert rel <= F32_LOSS_RTOL
    assert max(errs.values()) <= F32_GRAD_REL_L2, errs


def test_posit64_f32_compute_grads_match_reference(monkeypatch):
    """Posit64 on the two-layer smoke config with both packages' compute
    dtype f32: the posit64 training path (the K6 + K7/K8 twins' two-word
    p = e / l, K2's at W = 2) leaves only f32 rounding, so the bf16 test's
    gap at posit64 is bf16 rounding, not the two-word datapath."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    rel, errs, _, _ = _vs_reference("full", False, div_format="posit64")
    assert rel <= F32_LOSS_RTOL
    assert max(errs.values()) <= F32_GRAD_REL_L2, errs


def _tree(rng):
    return {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
            "b": rng.normal(0, 1, (3,)).astype(np.float32),
            "layers": [{"u": rng.normal(0, 1, (2, 5)).astype(np.float32)}]}


def test_adamw_and_schedule_match_reference():
    rng = np.random.default_rng(2)
    params, grads = _tree(rng), [_tree(rng) for _ in range(3)]
    jcfg = JA.AdamWConfig(lr=1e-2, schedule=JS.cosine_schedule(2, 10), grad_clip=0.5)
    tcfg = A.AdamWConfig(lr=1e-2, schedule=S.cosine_schedule(2, 10), grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    js = JA.adamw_init(jp)
    to_t = lambda t: {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                          [{n: torch.from_numpy(a) for n, a in d.items()} for d in v])
                      for k, v in t.items()}
    tp = to_t(params)
    ts = A.adamw_init(tp)
    for g in grads:
        jp, js, jm = JA.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = A.adamw_update(tcfg, tp, to_t(g), ts)
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for t, j in zip(tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["cosine_schedule", "wsd_schedule"])
def test_schedules_match_reference(name):
    jf, tf = getattr(JS, name)(5, 40), getattr(S, name)(5, 40)
    steps = np.arange(0, 45, dtype=np.int32)
    np.testing.assert_allclose(tf(torch.from_numpy(steps)).numpy(),
                               np.asarray(jf(jnp.asarray(steps))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_synthetic_batches_bit_equal_reference(smoke_cfg, hosts):
    jcfg = jget("smollm_360m", smoke=True)
    for host in range(hosts):
        ref = JDataset(JDataConfig(8, 64, seed=3), jcfg, host, hosts)
        got = SyntheticLMDataset(DataConfig(8, 64, seed=3), smoke_cfg, host, hosts)
        for step in (0, 1, 7, 1000):
            np.testing.assert_array_equal(got.batch_at(step)["tokens"],
                                          ref.batch_at(step)["tokens"])
