"""Shared helpers of the port's training tests (tests/test_torch_train*.py):
the smoke config, its batches, and the loss and gradients of the port
against the reference's ``jax.value_and_grad`` on the reference's weights.

Bounds (each test file states what it holds):
  * ``train_loss`` within LOSS_RTOL (1e-3) relative of the reference's, and
    each gradient leaf within GRAD_REL_L2 (2e-2) relative L2 error: both run
    bf16 products and posit16 divisions, whose roundings fall at other
    places (the attention tiles and the bf16 sums differ; a one-ulp change
    before a posit16 quantization moves it a whole posit step).  Observed
    worst leaves 1.76-1.81e-2 over seeds 0-2 (the test runs seed 0);
  * with the compute dtype f32 in both packages, the loss within
    F32_LOSS_RTOL (1e-5) and each leaf within F32_GRAD_REL_L2 (2^-10, one
    posit16 step): only posit16 quantization flips are left.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import reference_kernels
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.optim.tree import tree_items, tree_leaves
from repro_torch.train.trainer import loss_and_grads

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


def _vs_reference(remat, masked, seed=0, div_format="posit16", **cut):
    """The port's ``train_loss`` and gradients against the reference's on
    the reference's weights (``PRNGKey(seed)``) and one batch, with the
    smoke config at ``div_format`` (``cut`` replaces config fields): returns
    ``(rel, errs, metrics, grads)``, with the loss's relative error and each
    gradient leaf's relative L2 error by key."""
    jcfg = jget("smollm_360m", smoke=True, fused=True).replace(remat=remat, **cut)
    cfg = get_config("smollm_360m", smoke=True).replace(remat=remat, **cut)
    jcfg = jcfg.with_numerics(div_format=div_format)
    cfg = cfg.with_numerics(div_format=div_format)
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
    print(f"{div_format} remat={remat} seed={seed}: loss rel error {rel:.3g}; worst "
          f"gradient leaf {worst} rel L2 {errs[worst]:.3g}")
    return rel, errs, metrics, grads
