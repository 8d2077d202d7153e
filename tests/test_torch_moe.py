"""The port's MoE serving path against the reference on the smoke config.

Held against the reference, with its Pallas kernels in interpret mode:
the fixed-order row sum (bit-identical), the fused posit softmax's twin
(K9; bit-identical wherever the two libraries' ``exp`` agree, within one
posit16 step elsewhere), the router (the same expert ids and gate bits,
ties included), ``moe_block`` (the same kept tokens and destinations,
output within LOGIT_ULPS bf16 ulps), the scanned prefill and decode logits
(LOGIT_ULPS), and the engine's greedy tokens (a difference allowed only
where the reference's top-2 margin is within that bound).  In the port,
solo, packed-batch and mid-flight admission give the same tokens.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401  (fixtures)
    bf16_ulp, bits, one_torch_thread, ref_kernels, reference_kernels)
from repro.configs import get_config as jget
from repro.core.posit import PositFormat as JFmt
from repro.core.quire import fixed_order_rowsum as j_rowsum
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.numerics.posit_ops import posit_router_norm as j_router_norm
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.core.posit import POSIT16, PositFormat, float_to_posit
from repro_torch.core.quire import fixed_order_rowsum
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JO = importlib.import_module("repro.kernels.ops")
LOGIT_ULPS = 8          # as tests/test_torch_model.py
# K9's twin against the reference: the share of rows with the same bits,
# at least (measured 0.9998-1.0: the libraries' exp differ in 9% of
# elements by one f32 ulp, which a posit16 rounding mostly absorbs)
SOFTMAX_SAME_ROWS = 0.99
B, S, MAX_SEQ = 2, 12, 32
RNG = np.random.default_rng(14)
STREAM = [(RNG.integers(0, 512, n).astype(np.int32), m) for n, m in [(3, 4), (7, 2), (12, 4)]]


def _cfgs(**kw):
    j = jget("olmoe_1b_7b", smoke=True, fused=True)
    t = tget("olmoe_1b_7b", smoke=True)
    return (j.replace(**kw), t.replace(**kw)) if kw else (j, t)


def _steps(a, b):
    """Posit16 steps between two float32 arrays (0 where both are NaR)."""
    pa = float_to_posit(POSIT16, torch.from_numpy(np.array(a, np.float32)))
    pb = float_to_posit(POSIT16, torch.from_numpy(np.array(b, np.float32)))
    sa = torch.where(pa >= 2 ** 15, pa - 2 ** 16, pa)   # two's-complement order
    sb = torch.where(pb >= 2 ** 15, pb - 2 ** 16, pb)
    return (sa - sb).abs().numpy()


# ------------------------------------------------------------ quire, K9


@pytest.mark.parametrize("shape,axis", [((5, 64), -1), ((3, 7, 33), -1), ((40, 6), 0),
                                        ((2, 9, 4), 1)])
def test_fixed_order_rowsum_bit_identical(shape, axis):
    x = (RNG.standard_normal(shape) * np.exp(RNG.uniform(-20, 20, shape))).astype(np.float32)
    ref = j_rowsum(jnp.asarray(x), axis=axis)
    got = fixed_order_rowsum(torch.from_numpy(x), axis=axis)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(bits(ref), bits(got))


def _softmax_rows(shape):
    """Random logits with the special rows: -1e30 entries (the xla decode
    mask's value), a row of equal values, a NaN row, a +inf entry."""
    x = (RNG.standard_normal(shape) * 4).astype(np.float32)
    x[0, ::3] = -1e30
    x[1] = 0.75
    x[2, 5] = np.nan
    x[3, 1] = np.inf
    return x


@pytest.mark.parametrize("shape,variant", [((8, 64), "srt_r4_cs_of_fr"),
                                           ((37, 1000), "srt_r4_cs_of_fr"),
                                           ((16, 64), "nrd"), ((16, 64), "srt_r4_scaled")])
def test_softmax_twin_matches_reference_kernel(ref_kernels, shape, variant):
    x = _softmax_rows(shape)
    xj = jnp.asarray(x)
    ref = np.asarray(JO.posit_softmax_fused(JFmt(16), xj, variant=variant))
    e_ref = np.asarray(jnp.exp(xj - jnp.max(xj, axis=-1, keepdims=True)))
    xt = torch.from_numpy(x)
    got = TO.posit_softmax_fused(PositFormat(16), xt, variant)
    e_got = torch.exp(xt - torch.amax(xt, dim=-1, keepdim=True))
    same_e = (bits(e_ref) == bits(e_got)).all(-1)
    same = (bits(ref) == bits(got)).all(-1)
    print(f"{shape}: exp bits agree in {same_e.mean():.3f} of rows, outputs in "
          f"{same.mean():.4f}")
    assert same[same_e].all()
    assert _steps(ref, got.numpy()).max() <= 1
    assert same.mean() >= SOFTMAX_SAME_ROWS
    assert np.isnan(got[2].numpy()).all() and not np.isnan(got[4:].numpy()).any()
    assert (got[1].numpy() == got[1, 0].item()).all()


def _exp_agreeing_rows(shape):
    """Logits whose ``exp(x - max)`` has the same bits in XLA and torch: each
    row's max is 0 (so ``x - max`` is ``x``, exactly) and every other entry
    comes from values whose exp the two libraries round alike; row 0 holds
    -1e30 entries, row 1 equal values, row 2 a NaN.  At posit64 the quotient
    keeps a one-ulp difference of ``e`` that a posit16 rounding mostly
    absorbs, so the twin's bits are held on these rows."""
    pool = -np.abs(RNG.standard_normal(4096) * 4).astype(np.float32)
    same = bits(jnp.exp(jnp.asarray(pool))) == bits(torch.exp(torch.from_numpy(pool)))
    x = RNG.choice(pool[same], shape).astype(np.float32)
    x[:, 0] = 0.0
    x[0, 1::3] = -1e30
    x[1] = 0.75
    x[2, 5] = np.nan
    return x


@pytest.mark.parametrize("shape", [(8, 64), (12, 300)])
def test_softmax_posit64_twin_matches_reference_kernel(ref_kernels, shape):
    """K9's twin at posit64 srt_r4_cs_of_fr (the two-word frame) against the
    reference's kernel, at the router's width and at a row wider than the
    reference's 128-column tile: the same bits in every row but the NaN
    one, which is NaN alone."""
    x = _exp_agreeing_rows(shape)
    ref = np.asarray(JO.posit_softmax_fused(JFmt(64), jnp.asarray(x)))
    got = TO.posit_softmax_fused(PositFormat(64), torch.from_numpy(x)).numpy()
    nan_rows = np.isnan(ref).any(-1)
    assert nan_rows.tolist() == np.isnan(got).any(-1).tolist() == [i == 2 for i in
                                                                     range(shape[0])]
    assert np.isnan(got[2]).all()
    np.testing.assert_array_equal(bits(ref[~nan_rows]), bits(got[~nan_rows]))
    assert (got[1] == got[1, 0]).all()


@pytest.mark.parametrize("n,variant,shape", [(8, "srt_r4_cs_of_fr", (8, 64)),
                                             (8, "srt_r4_cs_of_fr", (12, 300)),
                                             (32, "srt_r4_cs_of_fr", (8, 64)),
                                             (32, "srt_r4_cs_of_fr", (12, 300)),
                                             (32, "srt_r4_scaled", (8, 64))])
def test_softmax_posit8_posit32_twin_matches_reference_kernel(ref_kernels, n, variant, shape):
    """K9's twin at posit8 and posit32 (srt_r4_scaled on the two-word frame)
    against the reference's kernel, on rows whose ``exp`` the two libraries
    round alike: the same bits in every row but the NaN one."""
    x = _exp_agreeing_rows(shape)
    ref = np.asarray(JO.posit_softmax_fused(JFmt(n), jnp.asarray(x), variant=variant))
    got = TO.posit_softmax_fused(PositFormat(n), torch.from_numpy(x), variant).numpy()
    nan_rows = np.isnan(ref).any(-1)
    assert nan_rows.tolist() == np.isnan(got).any(-1).tolist() == [i == 2 for i in
                                                                     range(shape[0])]
    np.testing.assert_array_equal(bits(ref[~nan_rows]), bits(got[~nan_rows]))
    assert (got[1] == got[1, 0]).all()


@pytest.mark.parametrize("variant", ["srt_r2_cs_of_fr", "nrd"])
def test_softmax_posit64_radix2_twin_matches_reference_kernel(ref_kernels, variant):
    """K9's twin at two posit64 radix-2 plans (the NRD baseline, 63
    non-restoring iterations on the two-word frame, and srt_r2_cs_of_fr)
    against the reference's kernel at the router's width: the same bits in
    every row but the NaN one."""
    x = _exp_agreeing_rows((8, 64))
    ref = np.asarray(JO.posit_softmax_fused(JFmt(64), jnp.asarray(x), variant=variant))
    got = TO.posit_softmax_fused(PositFormat(64), torch.from_numpy(x), variant).numpy()
    nan_rows = np.isnan(ref).any(-1)
    assert nan_rows.tolist() == np.isnan(got).any(-1).tolist() == [i == 2 for i in range(8)]
    np.testing.assert_array_equal(bits(ref[~nan_rows]), bits(got[~nan_rows]))


def test_softmax_moves_other_axes():
    _, tcfg = _cfgs()
    x = torch.from_numpy(RNG.standard_normal((4, 6, 5)).astype(np.float32))
    got = TL._softmax(x, tcfg, axis=1)
    want = TL._softmax(x.transpose(1, 2), tcfg).transpose(1, 2)
    np.testing.assert_array_equal(bits(got), bits(want))


# --------------------------------------------------------------- router


def _jroute(params, x, cfg):
    """The reference's routing, as ``repro.models.layers.moe_block`` does it."""
    Bx, Sx, _ = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = max(int(np.ceil(Sx * k / E * cfg.capacity_factor)), 1)
    logits = jnp.einsum("bsd,de->bse", x, params["router"].astype(x.dtype)).astype(
        jnp.float32)
    gate, eid = _jgates(logits, cfg)
    onehot = jax.nn.one_hot(eid, E, dtype=jnp.int32)
    flat_oh = onehot.reshape(Bx, Sx * k, E)
    csum = jax.lax.associative_scan(jnp.add, flat_oh, axis=1)
    rank = ((csum - flat_oh).reshape(Bx, Sx, k, E) * onehot).sum(-1)
    keep = rank < C
    return gate, eid, keep, jnp.where(keep, eid * C + rank, E * C)


def _jgates(logits, cfg):
    gate, eid = jax.lax.top_k(JL._softmax(logits, cfg, axis=-1), cfg.experts_per_token)
    return j_router_norm(gate, cfg.numerics), eid


def test_top_k_breaks_ties_as_lax():
    x = torch.tensor([[0.5, .25, .25, .25, .125, .25]])
    vals, idx = TL.top_k(x, 3)
    assert idx.tolist() == [[0, 1, 2]] and vals.tolist() == [[0.5, .25, .25]]


def test_router_gates_bit_identical_ties_included(ref_kernels):
    """OLMoE's router width (64 experts, top 8): random rows, rows drawn
    from four values (exact ties) and rows of one value."""
    jcfg, tcfg = _cfgs(n_experts=64, experts_per_token=8)
    logits = (RNG.standard_normal((24, 64)) * 2).astype(np.float32)
    logits[8:16] = RNG.choice(np.float32([-1.0, 0.5, 1.25, 2.0]), (8, 64))
    logits[16:18] = 0.3
    gj, ej = jax.jit(lambda x: _jgates(x, jcfg))(jnp.asarray(logits))
    gt, et = TL.router_gates(torch.from_numpy(logits), tcfg)
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_array_equal(bits(gj), bits(gt))
    assert et[16].tolist() == list(range(8))


def test_router_gates_posit64_bit_identical(ref_kernels):
    """The router at posit64 (K9's softmax and K2's renormalization on the
    two-word frame), OLMoE's width: random rows, rows drawn from four values
    (exact ties) and a row of one value, on logits whose exp the two
    libraries round alike."""
    jcfg, tcfg = _cfgs(n_experts=64, experts_per_token=8)
    jcfg = jcfg.with_numerics(div_format="posit64")
    tcfg = tcfg.with_numerics(div_format="posit64")
    logits = _exp_agreeing_rows((24, 64))
    logits[2, 5] = logits[2, 6]              # no NaN row here
    logits[8:16, 1:] = RNG.choice(logits[3, 1:5], (8, 63))
    logits[16] = 0.3
    gj, ej = jax.jit(lambda x: _jgates(x, jcfg))(jnp.asarray(logits))
    gt, et = TL.router_gates(torch.from_numpy(logits), tcfg)
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_array_equal(bits(gj), bits(gt))
    assert et[16].tolist() == list(range(8))


def _moe_case(S_, cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jp = JL.init_moe(jax.random.PRNGKey(5), jcfg)
    tp = {n: torch.from_numpy(np.array(w)) for n, w in jp.items()}
    x = RNG.standard_normal((B, S_, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("S_,cf", [(1, 1.25), (16, 0.5)], ids=["decode", "drops"])
def test_moe_block_matches_reference(ref_kernels, S_, cf):
    jcfg, tcfg, jp, tp, x = _moe_case(S_, cf)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    (gj, ej, kj, dj), ref = jax.jit(lambda p, x: (_jroute(p, x, jcfg),
                                                  JL.moe_block(p, x, jcfg)))(jp, xj)
    gt, et, kt, dt, _ = TL.moe_route(tp, xt, tcfg)
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(bits(gj), bits(gt))
    if S_ > 1:
        assert not kt.all(), "the case must drop tokens"
    else:
        assert kt.all()
    ref = np.asarray(ref.astype(jnp.float32))
    got = TL.moe_block(tp, xt, tcfg).float().numpy()
    err = float(np.abs(ref - got).max())
    print(f"S={S_}: max|port - reference| = {err:.4g}")
    assert err <= LOGIT_ULPS * bf16_ulp(np.abs(ref).max())


# posit64 gates against the reference's: the libraries' exp differ by one f32
# ulp in about 9% of elements, which a posit64 quotient keeps (posit16's
# rounding absorbs it), so the gates differ by a few f32 ulps
GATE64_RTOL = 2.0 ** -20


def test_moe_block_posit64_matches_reference(ref_kernels):
    """``moe_block`` at S = 1 with posit64 division (the router's K9 and K2
    on the two-word frame): the reference's experts, kept tokens and
    destinations, gates within GATE64_RTOL, output within LOGIT_ULPS bf16
    ulps."""
    jcfg, tcfg, jp, tp, x = _moe_case(1, 1.25)
    jcfg = jcfg.with_numerics(div_format="posit64")
    tcfg = tcfg.with_numerics(div_format="posit64")
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    (gj, ej, kj, dj), ref = jax.jit(lambda p, x: (_jroute(p, x, jcfg),
                                                  JL.moe_block(p, x, jcfg)))(jp, xj)
    gt, et, kt, dt, _ = TL.moe_route(tp, xt, tcfg)
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    gerr = float(np.abs(np.asarray(gj) - gt.numpy()).max() / np.abs(np.asarray(gj)).max())
    ref = np.asarray(ref.astype(jnp.float32))
    got = TL.moe_block(tp, xt, tcfg).float().numpy()
    err = float(np.abs(ref - got).max())
    print(f"posit64: gates max rel diff {gerr:.3g}; max|port - reference| = {err:.4g}")
    assert gerr <= GATE64_RTOL
    assert err <= LOGIT_ULPS * bf16_ulp(np.abs(ref).max())


# ---------------------------------------------------------------- model


@pytest.fixture(scope="module")
def model():
    """Reference and port logits: scanned prefill, then 3 forced steps."""
    jcfg, tcfg = _cfgs()
    toks = RNG.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    nxt = RNG.integers(0, tcfg.vocab, (3, B, 1)).astype(np.int32)
    start = np.array([0, 4], np.int32)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        lg, c = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           JT.init_cache(jcfg, B, MAX_SEQ), jnp.asarray(start))
        ref = [np.asarray(lg.astype(jnp.float32))]
        step = jax.jit(lambda p, c, t, pos, s: JT.decode_step(p, jcfg, c, t, pos, s))
        for i in range(3):
            lg, c = step(jp, c, jnp.asarray(nxt[i]), jnp.full((B,), S + i, jnp.int32),
                         jnp.asarray(start))
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
    return tcfg, jcfg, jp, tp, toks, start, ref, got


@pytest.mark.parametrize("step", [0, 1, 2, 3], ids=["prefill", "decode1", "decode2",
                                                     "decode3"])
def test_logits_within_bound(model, step):
    cfg, _, _, _, _, _, ref, got = model
    r, g = ref[step][..., :cfg.vocab], got[step][..., :cfg.vocab]
    err = float(np.abs(r - g).max())
    print(f"step {step}: max|port - reference| = {err:.4g}")
    assert np.isfinite(g).all()
    assert err <= LOGIT_ULPS * bf16_ulp(np.abs(r).max())


def test_param_tree_and_init_scale(model):
    cfg, _, _, tp, _, _, _, _ = model
    lay = tp["layers"][0]
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert (tuple(lay["router"].shape), tuple(lay["w1"].shape), tuple(lay["w2"].shape)) == (
        (D, E), (E, D, F), (E, F, D))
    full = tget("olmoe_1b_7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab, full.n_experts, full.experts_per_token) == (
        16, 2048, 16, 16, 128, 1024, 50304, 64, 8)
    # the reference's rule 1/sqrt(shape[0]) puts the experts at 1/sqrt(E)
    w = TT.init_params(cfg.replace(n_layers=1, d_model=256, d_ff=512),
                       torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)["layers"][0]
    assert abs(float(w["w1"].std()) - E ** -0.5) < 0.01
    assert abs(float(w["router"].std()) - 0.02) < 0.002


def test_scanned_suffix_prefill_is_full_prefill(model):
    cfg, _, _, tp, toks, _, _, got = model
    t = torch.from_numpy(toks)
    full = TT.init_cache(cfg, B, MAX_SEQ, device="cpu")
    lg_full, full = TT.prefill(tp, cfg, t, full)
    part = TT.init_cache(cfg, B, MAX_SEQ, device="cpu")
    _, part = TT.prefill(tp, cfg, t[:, :5], part)
    lg_suf, part = TT.prefill(tp, cfg, t, part, t0=5)
    np.testing.assert_array_equal(bits(lg_full.float()), bits(lg_suf.float()))
    assert torch.equal(full["k"], part["k"]) and torch.equal(full["v"], part["v"])


def test_unported_moe_paths_raise(model):
    """What the moe family still refuses: the concatenated pack (its packs
    lie on the batch axis), and what no family has: the encdec family.  The
    paged layout and training serve the moe family
    (tests/test_torch_moe_paged.py, tests/test_torch_moe_train.py), and
    ``remat="dots"`` trains it (tests/test_torch_hybrid_train.py)."""
    cfg, _, _, tp, toks, _, _, _ = model
    t = torch.from_numpy(toks)
    zeros = torch.zeros_like(t)
    with pytest.raises(NotImplementedError, match="batch axis"):
        TT.prefill_packed(tp, cfg, t, TT.init_cache(cfg, 1, 2 * S, device="cpu"), zeros,
                          zeros, torch.tensor([S - 1]), S)
    with pytest.raises(NotImplementedError, match="family"):
        tget("smollm_360m", smoke=True).replace(family="encdec")
    assert cfg.replace(remat="dots").remat == "dots"
    assert TT.init_paged_cache(cfg, 4, 16, device="cpu")["k"].shape[:3] == (cfg.n_layers, 4, 16)


# --------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def served(model):
    cfg, jcfg, jp, tp, _, _, _, _ = model
    with reference_kernels():
        jeng = JServeEngine(jcfg, jp, JServeConfig(max_batch=2, max_seq=MAX_SEQ,
                                                   packed_prefill=True))
        ref = [np.asarray(r) for r in jeng.serve([JRequest(p, max_new=m)
                                                  for p, m in STREAM])]
    packed = ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ,
                                              packed_prefill=True), device="cpu")
    outs = packed.serve([Request(p, max_new=m) for p, m in STREAM])
    return cfg, jcfg, jp, tp, packed, ref, outs


def test_engine_matches_reference_engine(served):
    cfg, jcfg, jp, _, packed, ref, outs = served
    st = packed.last_serve_stats
    assert st["packed_packs"] >= 1 and st["admissions"] == len(STREAM)
    for (p, _), r, g in zip(STREAM, ref, outs):
        if np.array_equal(r, g):
            continue
        j = int(np.flatnonzero(r != g)[0])      # first differing token
        with reference_kernels():
            seq = jnp.asarray(np.concatenate([p, r[:j]])[None])
            lg, _ = JT.prefill(jp, jcfg, {"tokens": seq}, JT.init_cache(jcfg, 1, MAX_SEQ))
        row = np.asarray(lg[0, -1, :jcfg.vocab].astype(jnp.float32))
        top2 = np.sort(row)[-2:]
        print(f"token {j} differs; reference top-2 margin {top2[1] - top2[0]:.4g}")
        assert top2[1] - top2[0] <= LOGIT_ULPS * bf16_ulp(np.abs(row).max())


def test_solo_packed_and_midflight_bit_identical(served):
    cfg, _, _, tp, packed, _, outs = served
    solo = ServeEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=MAX_SEQ), device="cpu")
    mid = solo.serve([Request(p, max_new=m) for p, m in STREAM])
    st = solo.last_serve_stats
    assert st["packed_packs"] == 0
    # solo admissions prefill their bucket one position a forward
    assert st["prefill_forwards"] == sum(max(8, 1 << (len(p) - 1).bit_length())
                                         for p, _ in STREAM)
    for (p, m), a, b in zip(STREAM, outs, mid):
        assert len(a) == m
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(solo.serve([Request(p, max_new=m)])[0], a)
    static = solo.generate([STREAM[0][0], STREAM[2][0]], max_new=2)
    np.testing.assert_array_equal(static[0], outs[0][:2])
    np.testing.assert_array_equal(static[1], outs[2][:2])
