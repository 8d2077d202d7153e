"""The port's training loop on the CPU: the trainer's loss falls, its
microbatching, checkpoints (atomic resume, mismatched trees, garbage
collection, an interrupted save), the straggler monitor, the launcher, the
entry points' device default, the config's training fields and the f32
master weights.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from _torch_train import _batch, smoke_cfg  # noqa: F401
from _torch_port import one_torch_thread  # noqa: F401
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim.tree import tree_items, tree_leaves
from repro_torch.train import CheckpointManager, StragglerMonitor, TrainConfig, Trainer
from repro_torch.train.trainer import init_train_state, loss_and_grads

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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
