"""The port's training path on the CPU against the reference: the loss and
its gradients on the smoke config, AdamW and the schedules, the synthetic
data, and the trainer's loop, microbatching and checkpoints.

Bounds:
  * ``train_loss`` within LOSS_RTOL (1e-3) relative of the reference's, and
    each gradient leaf within GRAD_REL_L2 (2e-2) relative L2 error: both run
    bf16 products and posit16 divisions, whose roundings fall at other
    places (the attention tiles and the bf16 sums differ; a one-ulp change
    before a posit16 quantization moves it a whole posit step).  Observed
    worst leaves 1.76-1.81e-2 over seeds 0-2 (the test runs seed 0);
  * with the compute dtype f32 in both packages, the loss within
    F32_LOSS_RTOL (1e-5) and each leaf within F32_GRAD_REL_L2 (2^-10, one
    posit16 step): only posit16 quantization flips are left.  Observed
    worst leaves 2.8e-5-1.9e-4 and loss errors below 2.5e-6 over seeds
    0-2, so the bf16 gap is bf16 rounding, not the kernels;
  * AdamW and the schedules within 1e-6 relative (the same f32 formulas);
  * synthetic batches bit-equal (the same numpy code).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import reference_kernels
from repro.configs import get_config as jget
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.optim import schedule as S
from repro_torch.optim.tree import tree_items, tree_leaves
from repro_torch.train import CheckpointManager, StragglerMonitor, TrainConfig, Trainer
from repro_torch.train.trainer import init_train_state, loss_and_grads

LOSS_RTOL = 1e-3
GRAD_REL_L2 = 2e-2
F32_LOSS_RTOL = 1e-5
F32_GRAD_REL_L2 = 2.0 ** -10
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module")
def smoke_cfg():
    return get_config("smollm-360m", smoke=True)


def _batch(cfg, masked: bool, seed: int = 0):
    rng = np.random.default_rng(11 + seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)}
    if masked:
        mask = np.ones((BATCH, SEQ), np.int32)
        mask[1, : SEQ // 2] = 0
        batch["loss_mask"] = mask
    return batch


def _vs_reference(remat, masked, seed=0):
    """The port's ``train_loss`` and gradients against the reference's on
    the reference's weights (``PRNGKey(seed)``) and one batch: returns
    ``(rel, errs, metrics, grads)``, with the loss's relative error and each
    gradient leaf's relative L2 error by key."""
    jcfg = jget("smollm_360m", smoke=True, fused=True).replace(remat=remat)
    cfg = get_config("smollm_360m", smoke=True).replace(remat=remat)
    batch = _batch(cfg, masked, seed)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
        (jloss, _), jgrad = jax.value_and_grad(JT.train_loss, has_aux=True)(
            jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
        tree = jax.tree.map(np.asarray, jp)
        gtree = jax.tree.map(np.asarray, jgrad)
    params = T.params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    ref_grads = T.params_from_numpy(gtree, cfg, device="cpu", dtype=torch.float32)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, metrics), grads = loss_and_grads(params, cfg, tbatch)
    rel = abs(float(loss) - float(jloss)) / abs(float(jloss))
    errs = {}
    for (key, g), r in zip(tree_items(grads), tree_leaves(ref_grads)):
        errs[key] = float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r))
    worst = max(errs, key=errs.get)
    print(f"remat={remat} seed={seed}: loss rel error {rel:.3g}; worst gradient leaf "
          f"{worst} rel L2 {errs[worst]:.3g}")
    return rel, errs, metrics, grads


@pytest.mark.parametrize("remat,masked", [("full", False), ("none", True)],
                         ids=["remat_full", "remat_none_loss_mask"])
def test_train_loss_and_grads_match_reference(remat, masked):
    rel, errs, metrics, grads = _vs_reference(remat, masked)
    assert rel <= LOSS_RTOL
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    assert max(errs.values()) <= GRAD_REL_L2, errs
    assert set(metrics) == {"nll", "zloss", "tokens", "acc"}
    assert float(metrics["tokens"]) == (SEQ - 1) * BATCH - (SEQ // 2 - 1 if masked else 0)


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


def test_loss_decreases(smoke_cfg):
    ds = SyntheticLMDataset(DataConfig(8, 64), smoke_cfg)
    tc = TrainConfig(steps=25, microbatches=1, lr=1e-3, warmup=5, log_every=5)
    res = Trainer(smoke_cfg, tc, ds, device="cpu").run()
    losses = [h["loss"] for h in res["history"]]
    print(f"smoke losses every 5 steps: {losses}")
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.slow
def test_microbatching_equivalent(smoke_cfg):
    """2 microbatches == 1 big batch (same grads up to accumulation order)."""
    ds = SyntheticLMDataset(DataConfig(8, 64), smoke_cfg)
    outs = []
    for mb in (1, 2):
        tc = TrainConfig(steps=3, microbatches=mb, lr=1e-3, warmup=1)
        tr = Trainer(smoke_cfg, tc, ds, device="cpu")
        tr.run()
        outs.append(torch.cat([p.reshape(-1) for p in tree_leaves(tr.state["params"])]))
    # bf16 forward + Adam nonlinearity amplify reduction-order differences;
    # 3 optimizer steps stay within a few 1e-3 absolute (the reference's bound)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0, atol=5e-3)


def test_checkpoint_atomic_resume(smoke_cfg):
    ds = SyntheticLMDataset(DataConfig(4, 32), smoke_cfg)
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(steps=4, ckpt_every=2, lr=1e-3)
        tr = Trainer(smoke_cfg, tc, ds, CheckpointManager(d), device="cpu")
        tr.run()
        assert CheckpointManager(d).all_steps() == [2, 4]
        # a crash after the save: a new trainer resumes with identical state
        tr2 = Trainer(smoke_cfg, tc, ds, CheckpointManager(d), device="cpu")
        assert tr2.start_step == 4
        for (ka, a), (kb, b) in zip(tree_items(tr.state), tree_items(tr2.state)):
            assert ka == kb and a.dtype == b.dtype
            assert torch.equal(a, b), ka


def test_checkpoint_rejects_mismatched_tree(smoke_cfg):
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        state = init_train_state(smoke_cfg, TrainConfig(), device="cpu")
        mgr.save(state, 1)
        wider = init_train_state(smoke_cfg.replace(d_ff=256), TrainConfig(), device="cpu")
        with pytest.raises(ValueError, match="shape mismatch"):
            mgr.restore(1, like=wider)
        deeper = init_train_state(smoke_cfg.replace(n_layers=3), TrainConfig(), device="cpu")
        with pytest.raises(ValueError, match="tree mismatch"):
            mgr.restore(1, like=deeper)


def test_checkpoint_gc_keeps_last(smoke_cfg):
    state = init_train_state(smoke_cfg, TrainConfig(), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in range(1, 6):
            mgr.save(state, step)
        mgr.close()
        assert mgr.all_steps() == [4, 5]
        restored = mgr.restore(5, like=state)
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            assert torch.equal(a, b)


def test_interrupted_save_is_invisible():
    """A .tmp dir from a crashed save must not be picked up on restore."""
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "step_00000099.tmp"))
        assert CheckpointManager(d).all_steps() == []


def test_straggler_monitor():
    m = StragglerMonitor(factor=3.0)
    for i in range(10):
        m.record(i, 0.1)
    assert m.record(10, 1.0)      # 10x median -> flagged
    assert not m.record(11, 0.12)


def test_launcher_trains_on_the_cpu(capsys):
    res = launch_train.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                             "--steps", "3", "--global-batch", "2", "--seq-len", "16"])
    assert res["final_step"] == 3
    assert np.isfinite(res["history"][-1]["loss"])
    assert "final: step 2" in capsys.readouterr().out


def test_training_entry_points_default_to_cuda(smoke_cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(smoke_cfg, TrainConfig())
    ds = SyntheticLMDataset(DataConfig(2, 8), smoke_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(smoke_cfg, TrainConfig(), ds)


def test_config_training_fields(smoke_cfg):
    assert smoke_cfg.remat == "full"
    with pytest.raises(NotImplementedError, match="dots"):
        smoke_cfg.replace(remat="dots")
    with pytest.raises(ValueError, match="remat"):
        smoke_cfg.replace(remat="some")
    # one attention backward (the reference's attn_bwd="fused"): no A/B field
    with pytest.raises(TypeError, match="attn_bwd"):
        smoke_cfg.replace(attn_bwd="reference")


def test_f32_masters_train_and_bf16_serving_weights_unchanged(smoke_cfg):
    """Training keeps f32 master weights (cast to bf16 at use); the serving
    default stays bf16."""
    state = init_train_state(smoke_cfg, TrainConfig(), device="cpu")
    assert state["params"]["layers"][0]["wq"].dtype == torch.float32
    assert state["opt"]["m"]["layers"][0]["wq"].dtype == torch.float32
    served = T.init_params(smoke_cfg, torch.Generator().manual_seed(0), device="cpu")
    assert served["layers"][0]["wq"].dtype == torch.bfloat16
    batch = {"tokens": torch.from_numpy(_batch(smoke_cfg, False)["tokens"])}
    (loss, _), grads = loss_and_grads(state["params"], smoke_cfg, batch)
    assert torch.isfinite(loss)
    assert grads["layers"][1]["wq"].dtype == torch.float32
    assert float(grads["layers"][1]["wq"].abs().max()) > 0
