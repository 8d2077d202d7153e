"""The port's training loss and its gradients on the smoke config against
the reference's ``jax.value_and_grad`` (bf16 compute, posit16 and posit64
division; the bounds: tests/_torch_train.py).

  * ``train_loss`` within LOSS_RTOL (1e-3) relative of the reference's, and
    each gradient leaf within GRAD_REL_L2 (2e-2) relative L2 error.  Observed
    worst leaves 1.76-1.81e-2 over seeds 0-2 (the test runs seed 0);
  * posit64 division (K1's two-word frame): the same bounds, on the smoke
    config cut to one layer.  The bf16 gap grows with depth: at two layers
    its worst leaf is 1.64-2.11e-2 over seeds 0-2 and the masked case
    (posit16: 1.76-1.81e-2), at one layer 0.85-0.96e-2 (posit16 too); with
    f32 compute at two layers the posit64 loss is exact and the worst leaf
    1.5e-6 (tests/test_torch_train_f32.py).
"""

import pytest
import torch

from _torch_train import BATCH, GRAD_REL_L2, LOSS_RTOL, SEQ, _vs_reference
from repro_torch.optim.tree import tree_leaves


@pytest.mark.parametrize("remat,masked,div_format,cut",
                         [("full", False, "posit16", {}), ("none", True, "posit16", {}),
                          ("full", False, "posit64", {"n_layers": 1})],
                         ids=["remat_full", "remat_none_loss_mask", "remat_full_posit64"])
def test_train_loss_and_grads_match_reference(remat, masked, div_format, cut):
    """The smoke config (2 layers, d_model 96, 3/1 heads of 32, d_ff 192,
    vocab 512, batch 2 x 16); the posit64 case at one layer (about 40 s on
    one worker, the reference's two-word kernels in interpret mode)."""
    rel, errs, metrics, grads = _vs_reference(remat, masked, div_format=div_format, **cut)
    assert rel <= LOSS_RTOL
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    assert max(errs.values()) <= GRAD_REL_L2, errs
    assert set(metrics) == {"nll", "zloss", "tokens", "acc"}
    assert float(metrics["tokens"]) == (SEQ - 1) * BATCH - (SEQ // 2 - 1 if masked else 0)
