"""The port's MoE training path on the CPU against the reference (OLMoE's
smoke config: 2 layers, d_model 128, 4/4 heads of 32, 8 experts top-2,
d_ff 128, vocab 512), with the reference's Pallas kernels in interpret mode.

Bounds:
  * ``posit_softmax``'s gradient (K9 forward, the reference's
    ``_softmax_bwd`` in plain torch) within SOFTMAX_GRAD_REL_L2 (1e-5)
    relative L2 of ``jax.grad`` through the reference's fused softmax at
    posit16 and posit64: the two libraries' ``exp`` and sums differ by f32
    ulps, and a posit16 quotient ``y`` moves a step in the rare rows where
    that crosses a rounding boundary.  Observed 1.9-2.0e-7 in both formats;
  * ``moe_block``'s gradients within BLOCK_GRAD_REL_L2 relative L2 of the
    reference's (its ``.at[].add`` dispatch), on the same routes, bits
    held by tests/test_torch_moe.py;
  * ``train_loss`` within LOSS_RTOL (1e-3) relative and every gradient
    leaf within GRAD_REL_L2 (2e-2) relative L2, the dense family's bounds
    (tests/test_torch_train.py), at S = 16 with capacity drops
    (``capacity_factor`` 0.5: C = 2 rows an expert for 32 choices over 8
    experts).  Observed at seed 0: loss 4.2-4.6e-4, worst leaf 1.6-1.8e-2.
    Top-k is a step function, and a bf16 rounding at another place in XLA
    and torch moves a router logit by an ulp; where two experts'
    probabilities nearly tie (seed 1: layer 1, token (1, 9); seed 2 with
    f32 compute: a 0.157 / 0.157 pair in layer 1) that flips one choice or
    the order of two, the capacity ranks behind it change, and the
    gradients of layer 1 move by 40-55%: a different function, not an
    error of the port.  So the port follows the reference's routes
    (``repro_torch.models.routes``; it computes the gates at those experts
    and the capacity ranks itself), and a token whose own experts differ
    must be a near-tie, its probabilities within ``routes.NEAR_TIE`` (2^-6)
    of each other; the test names any other with its gap;
  * with both packages' compute dtype f32, loss within F32_LOSS_RTOL and
    every leaf within F32_GRAD_REL_L2 (2^-10): observed 7.3e-6 and 2.9e-4
    at seed 0, 7.2e-7 and 9.3e-5 at seed 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, one_torch_thread, ref_kernels, reference_kernels  # noqa: F401
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.numerics import posit_ops as JP
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.models.routes import NEAR_TIE, followed_routes, recorded_routes
from repro_torch.numerics import posit_ops as TP
from repro_torch.optim.tree import tree_items, tree_leaves
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import loss_and_grads

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-3
GRAD_REL_L2 = 2e-2
F32_LOSS_RTOL = 1e-5
F32_GRAD_REL_L2 = 2.0 ** -10
SOFTMAX_GRAD_REL_L2 = 1e-5
BLOCK_GRAD_REL_L2 = 2e-2
SOFTMAX_ROWS_POSIT64 = 256
BATCH, SEQ, CF = 2, 16, 0.5
RNG = np.random.default_rng(26)


def _cfgs(**kw):
    j = jget("olmoe_1b_7b", smoke=True, fused=True).replace(capacity_factor=CF, **kw)
    t = get_config("olmoe_1b_7b", smoke=True).replace(capacity_factor=CF, **kw)
    return j, t


def _rel_l2(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float32)
    want = torch.as_tensor(np.asarray(want), dtype=torch.float32)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


# ------------------------------------------------------------- softmax STE


@pytest.mark.parametrize("div_format", ["posit16", "posit64"])
def test_softmax_grad_matches_reference(ref_kernels, div_format):
    """The router's width (64 experts) with a random cotangent, at a
    training step's 2048 rows (posit64 at SOFTMAX_ROWS_POSIT64: the
    reference's two-word kernel is slow in interpret mode): ``dx``
    against ``jax.grad`` of the reference's fused ``posit_softmax``; the
    rows with -1e30 entries give those entries a zero gradient in both."""
    jcfg, tcfg = _cfgs()
    jnm = jcfg.with_numerics(div_format=div_format).numerics
    tnm = tcfg.with_numerics(div_format=div_format).numerics
    rows = 2048 if div_format == "posit16" else SOFTMAX_ROWS_POSIT64
    x = (RNG.standard_normal((rows, 64)) * 3).astype(np.float32)
    x[0, ::5] = -1e30
    g = RNG.standard_normal((rows, 64)).astype(np.float32)
    jdx = np.asarray(jax.grad(lambda v: jnp.sum(JP.posit_softmax(v, jnm) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = TP.posit_softmax(xt, tnm)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    err = _rel_l2(dx, jdx)
    print(f"{div_format}: softmax gradient rel L2 {err:.3g}")
    assert err <= SOFTMAX_GRAD_REL_L2
    assert dx[0, ::5].abs().max() == 0 and jdx[0, ::5].max() == jdx[0, ::5].min() == 0


def test_softmax_grad_is_the_reference_formula_on_other_axes():
    """Along a middle axis (moved to the last and back under autograd) the
    gradient is ``p * (g - sum(g * y))`` with the posit ``y`` of the
    forward and ``p`` the float softmax, bit for bit."""
    _, tcfg = _cfgs()
    x = torch.from_numpy(RNG.standard_normal((3, 64, 5)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(RNG.standard_normal((3, 64, 5)).astype(np.float32))
    y = TP.posit_softmax(x, tcfg.numerics, axis=1)
    (dx,) = torch.autograd.grad(y, x, g)
    xt, gt, yt = (t.detach().movedim(1, -1) for t in (x, g, y))
    e = torch.exp(xt - xt.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    want = p * (gt - (gt * yt).sum(-1, keepdim=True))
    np.testing.assert_array_equal(bits(dx.movedim(1, -1)), bits(want))


# --------------------------------------------------------------- moe_block


def _block_case(dtype):
    jcfg, tcfg = _cfgs()
    jp = JL.init_moe(jax.random.PRNGKey(5), jcfg)
    x = RNG.standard_normal((BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    ct = RNG.standard_normal((BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    tp = {n: torch.from_numpy(np.array(w, np.float32)).requires_grad_() for n, w in jp.items()}
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    return jcfg, tcfg, jp, tp, x, ct, xt


def test_moe_block_grads_match_reference(ref_kernels):
    """Gradients of ``sum(moe_block(x) * ct)`` for x and every weight (the
    router through K2's and K9's straight-through backwards) against
    ``jax.grad`` of the reference's block on bf16 activations and f32
    weights, with capacity drops."""
    jcfg, tcfg, jp, tp, x, ct, xt = _block_case(torch.bfloat16)
    f = lambda p, v: jnp.sum(JL.moe_block(p, v, jcfg).astype(jnp.float32) * ct)
    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, jnp.asarray(x).astype(jnp.bfloat16))
    _, _, keep, _, _ = TL.moe_route(tp, xt.detach(), tcfg)
    assert not keep.all(), "the case must drop choices"
    out = TL.moe_block(tp, xt, tcfg).float()
    names = list(tp)
    grads = torch.autograd.grad(out, [tp[n] for n in names] + [xt], torch.from_numpy(ct))
    errs = {n: _rel_l2(g, np.asarray(jgp[n], np.float32)) for n, g in zip(names, grads)}
    errs["x"] = _rel_l2(grads[-1], np.asarray(jgx.astype(jnp.float32)))
    print(f"moe_block gradient rel L2: {errs}")
    assert max(errs.values()) <= BLOCK_GRAD_REL_L2, errs


def test_dropped_choice_contributes_no_expert_gradient():
    """f32 throughout: the experts' gradients equal those of an explicit sum
    over the kept (token, choice) pairs alone, and a token whose every
    choice is dropped gets an exactly zero gradient (its rows land in the
    sink, whose gradient is zero, and its gates are multiplied by 0)."""
    _, tcfg, _, tp, x, ct, xt = _block_case(torch.float32)
    gate, eid, keep, _, _ = TL.moe_route(tp, xt.detach(), tcfg)
    out = TL.moe_block(tp, xt, tcfg)
    w = ("w1", "w3", "w2")
    got = torch.autograd.grad(out, [tp[n] for n in w] + [xt], torch.from_numpy(ct))
    silu = torch.nn.functional.silu
    rows = []
    for b in range(BATCH):
        for s in range(SEQ):
            y = torch.zeros(tcfg.d_model)
            for c in range(tcfg.experts_per_token):
                if keep[b, s, c]:
                    ex = int(eid[b, s, c])
                    h = silu(xt[b, s] @ tp["w1"][ex]) * (xt[b, s] @ tp["w3"][ex])
                    y = y + gate[b, s, c].detach() * (h @ tp["w2"][ex])
            rows.append(y)
    ys = torch.stack(rows).reshape(out.shape)
    want = torch.autograd.grad(ys, [tp[n] for n in w], torch.from_numpy(ct))
    for n, a, b in zip(w, got[:3], want):
        assert _rel_l2(a, b) <= 1e-5, n
    dropped = (~keep).all(-1)
    assert dropped.any(), "the case must drop every choice of some token"
    assert float(out.detach()[dropped].abs().max()) == 0.0
    # the dropped tokens' gradient comes only through other tokens' routes,
    # which are discrete: exactly zero
    assert float(got[3][dropped].abs().max()) == 0.0


# --------------------------------------------------------------- train_loss


def _batch(cfg, masked: bool, seed: int):
    rng = np.random.default_rng(11 + seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)}
    if masked:
        mask = np.ones((BATCH, SEQ), np.int32)
        mask[1, : SEQ // 2] = 0
        batch["loss_mask"] = mask
    return batch


# (remat, loss mask, compute dtype f32) of each comparison with the reference
CASES = {"remat_full": ("full", False, False), "remat_none_loss_mask": ("none", True, False),
         "f32_compute": ("none", False, True)}


@pytest.fixture(scope="module")
def reference():
    """``jax.value_and_grad`` of the reference's ``train_loss`` for every
    case of CASES on the reference's weights (``PRNGKey(0)``), in one
    ``reference_kernels()`` scope so that the cases share its compiled
    kernels, each with its routes captured through ``jax.debug.callback``
    inside the scanned layers: case -> (weights, gradients, loss, routes),
    the trees as numpy."""
    out = {}
    jmoe = JL.moe_block
    with reference_kernels(), pytest.MonkeyPatch.context() as mp:
        for name, (remat, masked, f32) in CASES.items():
            jcfg, cfg = _cfgs(remat=remat)
            routes = []

            def record(p, v, c, routes=routes):
                lg = jnp.einsum("bsd,de->bse", v, p["router"].astype(v.dtype)).astype(
                    jnp.float32)
                _, eid = jax.lax.top_k(JL._softmax(lg, c, axis=-1), c.experts_per_token)
                jax.debug.callback(lambda e, l_: routes.append((np.asarray(e), np.asarray(l_))),
                                   eid, lg)
                return jmoe(p, v, c)

            mp.setattr(JL, "moe_block", record)
            mp.setattr(JL, "COMPUTE_DTYPE", jnp.float32 if f32 else jnp.bfloat16)
            jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
            batch = _batch(cfg, masked, 0)
            (jloss, _), jgrad = jax.value_and_grad(JT.train_loss, has_aux=True)(
                jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
            out[name] = (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jgrad),
                         float(jloss), routes)
    return out


def _vs_reference(reference, name, monkeypatch):
    """The port's ``train_loss`` and gradients for case ``name`` against the
    reference's, the port following the reference's routes (its forward's,
    then under remat "full" the recompute's, layers in reverse): returns
    ``(rel, errs, metrics)``; fails naming every (router call, token) whose
    own experts differ where that is not a near-tie (``routes.NEAR_TIE``)."""
    remat, masked, f32 = CASES[name]
    tree, gtree, jloss, jroutes = reference[name]
    _, cfg = _cfgs(remat=remat)
    if f32:
        monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    L_ = cfg.n_layers
    assert len(jroutes) >= L_
    follow = [e for e, _ in jroutes[:L_]]
    if remat == "full":
        follow += follow[::-1]
    params = T.params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    ref_grads = T.params_from_numpy(gtree, cfg, device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, masked, 0).items()}
    calls, flips = [], []
    with recorded_routes(calls), followed_routes(follow, flips):
        (loss, metrics), grads = loss_and_grads(params, cfg, batch)
    assert len(calls) == len(follow)
    far = [f for f in flips if f[2] > NEAR_TIE]
    assert not far, (f"the port's own experts leave the reference's beyond a near-tie "
                     f"(router call, token, relative probability gap): {far}")
    rel = abs(float(loss) - jloss) / abs(jloss)
    errs = {key: _rel_l2(g, r) for (key, g), r in zip(tree_items(grads), tree_leaves(ref_grads))}
    worst = max(errs, key=errs.get)
    print(f"moe {name}: loss rel error {rel:.3g}; worst gradient leaf {worst} rel L2 "
          f"{errs[worst]:.3g}; near-tie flips followed: {flips}")
    return rel, errs, metrics


@pytest.mark.parametrize("name", ["remat_full", "remat_none_loss_mask"])
def test_moe_train_loss_and_grads_match_reference(reference, monkeypatch, name):
    """Batch 2 x 16 with capacity drops (the reference's three runs about
    60 s on one worker together)."""
    rel, errs, metrics = _vs_reference(reference, name, monkeypatch)
    masked = CASES[name][1]
    assert rel <= LOSS_RTOL
    assert max(errs.values()) <= GRAD_REL_L2, errs
    assert float(metrics["tokens"]) == (SEQ - 1) * BATCH - (SEQ // 2 - 1 if masked else 0)


def test_moe_f32_compute_grads_match_reference(reference, monkeypatch):
    """With both packages' compute dtype f32 the gap falls about a
    hundredfold: what is left of the bf16 test's is bf16 rounding."""
    rel, errs, _ = _vs_reference(reference, "f32_compute", monkeypatch)
    assert rel <= F32_LOSS_RTOL
    assert max(errs.values()) <= F32_GRAD_REL_L2, errs


def test_moe_trainer_lowers_the_loss():
    """``Trainer`` on the smoke moe config (f32 masters, AdamW, remat
    "full"): finite losses, the last below the first, every state leaf
    finite, the expert weights and the router moved."""
    cfg = get_config("olmoe_1b_7b", smoke=True)
    ds = SyntheticLMDataset(DataConfig(2, 32), cfg)
    tc = TrainConfig(steps=4, lr=3e-3, warmup=1, log_every=1)
    tr = Trainer(cfg, tc, ds, device="cpu")
    before = {k: v.clone() for k, v in tree_items(tr.state["params"])}
    losses = [h["loss"] for h in tr.run()["history"]]
    print(f"moe smoke losses: {losses}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(torch.isfinite(t).all() for t in tree_leaves(tr.state))
    after = dict(tree_items(tr.state["params"]))
    for key in ("layers/0/router", "layers/0/w1", "layers/1/w2"):
        assert after[key].dtype == torch.float32
        assert not torch.equal(after[key], before[key]), key
