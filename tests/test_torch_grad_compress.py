"""Posit gradient compression and the trainer's step on the hybrid family,
against the reference on the CPU.

  * ``compress_gradients`` gives the reference's bits at posit8, posit16 and
    posit32 on seeded trees holding zeros, values past maxpos and below
    minpos, subnormals, infinities and NaN (both infinities and NaN become
    NaR, so NaN, in both; NaN compared by value: torch's
    CPU and CUDA NaN bits differ, ROADMAP section 3); posit64 is refused
    with the reference's message;
  * one ``Trainer`` step (f32 masters, AdamW, remat "full") on the hybrid
    smoke config cut to one RG-LRU and one attention layer, 2 x 96 tokens,
    against the reference's ``make_train_step``, plain and with
    ``grad_compress_format="posit16"``: the loss within LOSS_RTOL, the
    gradient norm and the first moment (0.1 g, every leaf) within
    GRAD_REL_L2 relative, the second moment (0.05 g^2) within twice that
    (the square doubles a relative error), and every parameter within two
    learning rates (Adam's first step moves each by lr times the sign of
    its gradient, and a gradient near zero may take the other sign).  The
    compressed step is AdamW on the port's own gradients rounded by
    ``compress_gradients``, bit for bit: compression sits after the
    gradients and before AdamW, where the reference's trainer puts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, reference_kernels  # noqa: F401
from _torch_train import GRAD_REL_L2, LOSS_RTOL
from repro.configs import get_config as jget
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.numerics.formats import NumericsConfig as JNumerics
from repro.optim.grad_compress import compress_gradients as jcompress
from repro.train import trainer as JTR
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import transformer as T
from repro_torch.numerics import NumericsConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, compress_gradients
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.tree import tree_items, tree_leaves, tree_map
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import loss_and_grads

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SPECIALS = [0.0, -0.0, 1e30, -1e30, 3e38, 1e-30, -1e-30, 1e-44, -3e-39, np.inf, -np.inf,
            np.nan, 1.0, -1.5, 2.0 ** 120, 2.0 ** -120]


def _tree(seed):
    """A gradient-shaped tree: nested dicts and a list, log-uniform
    magnitudes over most of f32's range, and the specials."""
    rng = np.random.default_rng(seed)
    leaf = lambda *s: (rng.standard_normal(s) * np.exp(rng.uniform(-60, 60, s))).astype(
        np.float32)
    specials = np.array(SPECIALS, np.float32)
    return {"tok": leaf(64, 8), "ln_f": specials,
            "layers": [{"wq": leaf(8, 16), "rec": {"lam": leaf(16), "conv_b": np.zeros(5,
                                                                                  np.float32)}},
                       {"w1": np.concatenate([leaf(100), specials])}]}


@pytest.mark.parametrize("fmt", ["posit8", "posit16", "posit32"])
def test_compress_gradients_matches_reference(fmt):
    tree = _tree(int(fmt[5:]))
    ref = jax.tree.map(np.asarray, jcompress(jax.tree.map(jnp.asarray, tree), fmt))
    got = compress_gradients(tree_map(torch.from_numpy, tree), fmt)
    n = 0
    for (key, g), r in zip(tree_items(got), jax.tree_util.tree_leaves(ref)):
        assert g.dtype == torch.float32 and g.shape == r.shape, key
        g = g.numpy()
        nan = np.isnan(r)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=key)
        np.testing.assert_array_equal(g[~nan].view(np.int32), r[~nan].view(np.int32),
                                      err_msg=key)
        n += nan.sum()
    assert n == 6   # NaN and both infinities of each specials block: NaR, then NaN


def test_compress_refuses_posit64():
    with pytest.raises(ValueError, match="grad_compress_format='posit64' is a storage/wire"):
        NumericsConfig(grad_compress_format="posit64").validate()
    with pytest.raises(ValueError, match="grad_compress_format='posit64' is a storage/wire"):
        JNumerics(grad_compress_format="posit64").validate()
    with pytest.raises(ValueError, match="n <= 32"):
        compress_gradients({"w": torch.ones(3)}, "posit64")


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("compress", [None, "posit16"], ids=["plain", "posit16"])
def test_hybrid_trainer_step_matches_reference(compress):
    cut = dict(n_layers=2, attn_period=2)
    jcfg = jget("recurrentgemma_2b", smoke=True, fused=True).replace(**cut).with_numerics(
        grad_compress_format=compress)
    cfg = get_config("recurrentgemma_2b", smoke=True).replace(**cut).with_numerics(
        grad_compress_format=compress)
    lr = 1e-3
    jtc = JTR.TrainConfig(steps=4, lr=lr, warmup=1)
    tc = TrainConfig(steps=4, lr=lr, warmup=1, log_every=1)
    jbatch = JDataset(JDataConfig(2, 96, seed=0), jcfg).batch_at(0)
    ds = SyntheticLMDataset(DataConfig(2, 96, seed=0), cfg)
    with reference_kernels():
        jstate = JTR.init_train_state(jcfg, jtc, jax.random.PRNGKey(0))
        params0 = jax.tree.map(np.asarray, jstate["params"])
        jnew, jm = JTR.make_train_step(jcfg, jtc)(
            jstate, {k: jnp.asarray(v) for k, v in jbatch.items()})
        jnew = jax.tree.map(np.asarray, jnew)
    to_port = lambda tree: T.params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    params = to_port(params0)
    trainer = Trainer(cfg, tc, ds, state={"params": params, "opt": adamw_init(params)},
                      device="cpu")
    res = trainer.run(1)
    new = trainer.state
    m = res["history"][0]
    assert abs(m["loss"] - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert abs(m["grad_norm"] - float(jm["grad_norm"])) <= GRAD_REL_L2 * float(jm["grad_norm"])
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    for name, bound in (("m", GRAD_REL_L2), ("v", 2 * GRAD_REL_L2)):
        ref = tree_leaves(to_port(jnew["opt"][name]))
        for (key, got), want in zip(tree_items(new["opt"][name]), ref):
            assert _rel(got, want) <= bound, (name, key, _rel(got, want))
    for (key, got), want in zip(tree_items(new["params"]), tree_leaves(to_port(jnew["params"]))):
        assert float((got - want).abs().max()) <= 2 * lr * 1.001, key
    if compress:
        # the step is AdamW on the port's own gradients rounded by
        # compress_gradients, bit for bit
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}
        _, grads = loss_and_grads(params, cfg, batch)
        opt_cfg = AdamWConfig(lr=lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
                              schedule=cosine_schedule(tc.warmup, tc.steps))
        want, opt, _ = adamw_update(opt_cfg, params, compress_gradients(grads, compress),
                                    adamw_init(params))
        for (key, got), w in zip(tree_items(new), tree_leaves({"params": want, "opt": opt})):
            assert torch.equal(got, w), key
