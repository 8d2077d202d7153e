"""Hybrid training (RecurrentGemma's RG-LRU blocks and local attention) and
``remat="dots"`` on the CPU, against the reference.

Held against the reference's ``jax.value_and_grad(train_loss)`` with its
fused backend in interpret mode, on its weights and one batch of 96 tokens
(past the smoke config's 64-key window, so K6 and the K7/K8 twins mask by
it):
  * with bf16 compute, ``train_loss`` within LOSS_RTOL and every gradient
    leaf (``lam``, ``conv_w``, ``conv_b``, ``wa``, ``wx`` included) within
    GRAD_REL_L2, at remat "full" and "dots", on the smoke config cut to one
    recurrent and one attention layer (``n_layers=2, attn_period=2``):
    worst leaves 1.64-1.94e-2 over seeds 0-2.  The three-layer smoke config
    sits at 2.2-3.6e-2 there (seeds 0-2, 16-96 tokens): both packages'
    bf16 roundings, not the port's arithmetic.  With f32 compute its worst
    leaf is 3.4e-4 (the next test), and on one RG-LRU block the port's bf16
    gradients are as close to the f32 gradients as the reference's are, or
    closer (``conv_b`` 7.3e-3 against the reference's 1.23e-2);
  * with f32 compute in both packages, the three-layer smoke config within
    F32_LOSS_RTOL and F32_GRAD_REL_L2 (one posit16 step).
In the port alone: "none", "full" and "dots" give the same loss and
gradients bit for bit (dense, moe and hybrid smoke configs); "dots"
recomputes no matrix product in the backward and K6 once an attention
layer, as the reference's ``checkpoint_dots`` and its flash custom_vjp; a
hybrid train state survives a ``CheckpointManager`` round trip.
"""

import collections
import tempfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from _torch_train import (F32_GRAD_REL_L2, F32_LOSS_RTOL, GRAD_REL_L2, LOSS_RTOL,
                          _vs_reference)
from repro_torch.configs import get_config
from repro_torch.kernels import posit_flash_attn as F
from repro_torch.optim.tree import tree_items, tree_leaves
from repro_torch.train import CheckpointManager, TrainConfig
from repro_torch.train.trainer import init_train_state, loss_and_grads

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCH, SEQ96 = "recurrentgemma_2b", 96
# one RG-LRU layer, then one local-attention layer
CUT = {"n_layers": 2, "attn_period": 2}


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_hybrid_loss_and_grads_match_reference(remat):
    rel, errs, metrics, grads = _vs_reference(remat, False, arch=ARCH, seq=SEQ96, **CUT)
    assert {"layers/0/rec/lam", "layers/0/rec/conv_w", "layers/0/rec/conv_b",
            "layers/0/rec/wa", "layers/0/rec/wx", "layers/1/wq"} <= set(errs)
    assert rel <= LOSS_RTOL
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    assert max(errs.values()) <= GRAD_REL_L2, errs
    assert float(metrics["tokens"]) == (SEQ96 - 1) * 2


def test_hybrid_f32_compute_grads_match_reference(monkeypatch):
    """The three-layer smoke config (two RG-LRU layers, one attention layer)
    with both packages' compute dtype f32: only posit16 quantization flips
    are left."""
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro_torch.models import layers as L

    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    rel, errs, _, _ = _vs_reference("full", False, arch=ARCH, seq=SEQ96)
    assert len([k for k in errs if "/rec/" in k]) == 16
    assert rel <= F32_LOSS_RTOL
    assert max(errs.values()) <= F32_GRAD_REL_L2, errs


def _loss_and_grads(arch, remat, seq=80):
    cfg = get_config(arch, smoke=True).replace(remat=remat)
    state = init_train_state(cfg, TrainConfig(seed=0), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    (loss, _), grads = loss_and_grads(state["params"], cfg, {"tokens": torch.from_numpy(toks)})
    return loss, grads


@pytest.mark.parametrize("arch", ["smollm_360m", "olmoe_1b_7b", ARCH])
def test_remat_policies_give_the_same_bits(arch):
    """``"none"``, ``"full"`` and ``"dots"`` recompute the same ops on the
    same inputs, so the loss and every gradient leaf are the same bits."""
    loss0, g0 = _loss_and_grads(arch, "none")
    for remat in ("full", "dots"):
        loss, g = _loss_and_grads(arch, remat)
        assert torch.equal(loss.view(torch.int32), loss0.view(torch.int32)), remat
        for (key, a), b in zip(tree_items(g), tree_leaves(g0)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (remat, key)


class _Products(TorchDispatchMode):
    """Counts the matrix products that reach the kernels (the selective
    checkpoint's cache answers a saved one before this mode sees it)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)
        return func(*args, **(kwargs or {}))


def test_dots_saves_products_and_recomputes_flash(monkeypatch):
    """Under ``"dots"`` the backward reruns no matrix product (the count of
    ``"none"``, where ``"full"`` reruns every block's), and the flash
    forward (K6) twice an attention layer: the backward's recompute runs it
    again, as under ``"full"``."""
    calls = collections.Counter()
    fwd = F.posit_flash_attention_fwd

    def counted(*a, **kw):
        calls["K6"] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(F, "posit_flash_attention_fwd", counted)
    products = {}
    for remat in ("none", "full", "dots"):
        calls.clear()
        with _Products() as mode:
            _loss_and_grads(ARCH, remat, seq=24)
        products[remat] = mode.n
        assert calls["K6"] == (1 if remat == "none" else 2), remat   # one attention layer
    assert products["dots"] == products["none"] < products["full"], products


def test_checkpoint_round_trip_hybrid_state():
    """A hybrid train state (the ``rec`` sub-trees of the layer list, f32
    masters, AdamW moments) saved and restored: the same keys, dtypes and
    bits."""
    cfg = get_config(ARCH, smoke=True)
    state = init_train_state(cfg, TrainConfig(seed=1), device="cpu")
    state["opt"]["m"]["layers"][0]["rec"]["lam"] += 0.5
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(state, 3, wait=True)
        like = init_train_state(cfg, TrainConfig(seed=2), device="cpu")
        got, step = mgr.restore_latest(like=like)
        mgr.close()
    assert step == 3
    keys = [k for k, _ in tree_items(state)]
    assert "params/layers/0/rec/conv_w" in keys and "opt/v/layers/2/wq" in keys
    for (ka, a), (kb, b) in zip(tree_items(state), tree_items(got)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b), ka
