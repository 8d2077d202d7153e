"""The port's MoE family served from the paged, prefix-shared pool on the
CPU (OLMoE's smoke config), against its dense slots and the reference.

In the port, a moe request's greedy tokens are the same bits from dense
slots and from the pool: solo (the scan from ``t0`` after a shared
prefix), packed (``prefill_batch_ragged``: N right-padded rows at start
0, each row's logits from its own last step), with a prefix hit, through
``generate`` and under a posit16 KV cache.  Against the reference (its
Pallas kernels in interpret mode): ``prefill_batch_ragged``'s logits within
LOGIT_ULPS bf16 ulps and its cache rows within the same bound (bit for bit
against the port's solo prefill of each row), and the reference's paged
packed moe engine's tokens, a difference allowed only where the
reference's top-2 margin is within that bound.  Top-k routing is a step
function: where the two packages' bf16 products put two router logits of
the smoke config's 8 experts an ulp apart on either side of a tie, a row
routes otherwise from there on.  Both comparisons capture the routes and
hold such a row only to its first flip being a near-tie.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_ulp, bits, one_torch_thread, reference_kernels  # noqa: F401  (fixture)
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOGIT_ULPS = 8          # as tests/test_torch_moe.py
MAX_SEQ, BS = 64, 8
RNG = np.random.default_rng(26)
PREFIX = RNG.integers(0, 512, BS).astype(np.int32)
OWN = [RNG.integers(0, 512, n).astype(np.int32) for n in (3, 6, 11)]
CHAT = [np.concatenate([PREFIX, RNG.integers(0, 512, n)]).astype(np.int32) for n in (2, 5)]
# the first chat request is admitted in a pack; the second finds the
# prefix registered by then (admitted solo, prefilled from t0 = BS)
STREAM = [(CHAT[0], 4), (OWN[0], 3), (OWN[1], 4), (OWN[2], 2), (CHAT[1], 4)]


def _reqs(stream=STREAM):
    return [Request(p, max_new=m) for p, m in stream]


def _engine(cfg, tp, **kw):
    sc = dict(max_batch=2, max_seq=MAX_SEQ, block_size=BS)
    sc.update(kw)
    return ServeEngine(cfg, tp, ServeConfig(**sc), device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = jget("olmoe_1b_7b", smoke=True, fused=True)
    tcfg = tget("olmoe_1b_7b", smoke=True)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
    tp = TT.params_from_numpy(tree, tcfg, device="cpu")
    dense = _engine(tcfg, tp).serve(_reqs())
    return jcfg, tcfg, jp, tp, dense


def _same(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


# -------------------------------------------------- prefill_batch_ragged


def _first_flip(jroutes, troutes, row: int):
    """The first (forward, layer) entry where ``row``'s experts differ
    between the two runs' routes (one ``(eid, router logits)`` per layer
    of each forward, in order), and the reference's smallest gap between
    adjacent router logits among its top k + 1 there; None when they
    agree throughout."""
    for n, ((je, jlg), (te, _)) in enumerate(zip(jroutes, troutes)):
        if not np.array_equal(je[row], te[row]):
            k = je.shape[-1]
            top = np.sort(jlg[row].reshape(-1))[::-1][:k + 1]
            return n, float(np.min(top[:-1] - top[1:])), float(np.abs(jlg[row]).max())
    return None


@contextlib.contextmanager
def _captured_routes():
    """Within the block, every moe block of either package appends its
    (experts, f32 router logits) to the lists yielded, ``(reference's,
    port's)``: the reference's through ``jax.debug.callback`` inside its
    scans, in the order of its forwards and layers, as the port's."""
    jroutes, troutes = [], []
    jmoe, tmoe = JL.moe_block, TL.moe_block

    def jrecord(p, v, c):
        lg = jnp.einsum("bsd,de->bse", v, p["router"].astype(v.dtype)).astype(jnp.float32)
        _, eid = jax.lax.top_k(JL._softmax(lg, c, axis=-1), c.experts_per_token)
        jax.debug.callback(lambda e, l_: jroutes.append((np.asarray(e), np.asarray(l_))),
                           eid, lg)
        return jmoe(p, v, c)

    def trecord(p, v, c):
        lg = torch.matmul(v, p["router"].to(v.dtype)).float()
        troutes.append((TL.moe_route(p, v, c)[1].numpy(), lg.numpy()))
        return tmoe(p, v, c)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "moe_block", jrecord)
        mp.setattr(TL, "moe_block", trecord)
        yield jroutes, troutes


def _near_tie(gap: float, top: float) -> bool:
    """A router logits' gap within LOGIT_ULPS bf16 ulps of their largest."""
    return gap <= LOGIT_ULPS * bf16_ulp(top)


def test_prefill_batch_ragged_matches_reference(model):
    """Five right-padded rows (5-16 tokens, width 16) and a zero dummy row:
    each row's logits from its own last step, bit for bit those of the
    port's solo scan of the row, cache rows [0, plen) too; against the
    reference's ``prefill_batch_ragged``, logits and cache rows within
    LOGIT_ULPS.  Both runs' routes are captured: a row whose experts differ
    somewhere is held to that first flip being a near-tie of the
    reference's router logits, and its logits are not compared (top-k is a
    step function: on the smoke config's 8 experts such flips are common);
    at least one row routes alike and is compared."""
    jcfg, tcfg, jp, tp, _ = model
    lens, W = [0, 5, 8, 11, 13, 16], 16
    N = len(lens)
    toks = np.zeros((N, W), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = RNG.integers(0, tcfg.vocab, n)
    last = np.array([0] + [n - 1 for n in lens[1:]], np.int32)
    with _captured_routes() as (jroutes, troutes):
        with reference_kernels():
            jlg, jc = JT.prefill_batch_ragged(jp, jcfg, jnp.asarray(toks),
                                              JT.init_cache(jcfg, N, W),
                                              jnp.zeros(N, jnp.int32), jnp.asarray(last))
            jlg = np.asarray(jlg.astype(jnp.float32))
            jk = np.asarray(jc["layers"]["k"].astype(jnp.float32))    # (L, N, W, KV, hd)
        lg, cache = TT.prefill_batch_ragged(tp, tcfg, torch.from_numpy(toks),
                                            TT.init_cache(tcfg, N, W, device="cpu"),
                                            torch.zeros(N, dtype=torch.int32),
                                            torch.from_numpy(last))
    assert tuple(lg.shape) == (N, 1, tcfg.padded_vocab)
    assert len(jroutes) == len(troutes) == W * tcfg.n_layers
    held = 0
    for i, n in enumerate(lens[1:], 1):
        slg, solo = TT.prefill(tp, tcfg, torch.from_numpy(toks[i:i + 1, :n]),
                               TT.init_cache(tcfg, 1, W, device="cpu"))
        np.testing.assert_array_equal(bits(slg.float()), bits(lg[i:i + 1].float()))
        for name in ("k", "v"):
            assert torch.equal(solo[name][:, 0, :n], cache[name][:, i, :n])
        flip = _first_flip(jroutes[:n * tcfg.n_layers], troutes, i)
        if flip is not None:
            at, gap, top = flip
            print(f"row {i}: experts differ first at forward {at // tcfg.n_layers}, layer "
                  f"{at % tcfg.n_layers}; the reference's router logits' adjacent gap "
                  f"{gap:.4g} (max |logit| {top:.4g})")
            assert _near_tie(gap, top)
            continue
        r, g = jlg[i, 0, :tcfg.vocab], lg[i, 0, :tcfg.vocab].float().numpy()
        err = float(np.abs(r - g).max())
        print(f"row {i} ({n} tokens): max|port - reference| = {err:.4g}")
        assert err <= LOGIT_ULPS * bf16_ulp(np.abs(r).max())
        kr, kg = jk[:, i, :n], cache["k"][:, i, :n].float().numpy()
        assert np.abs(kr - kg).max() <= LOGIT_ULPS * bf16_ulp(np.abs(kr).max())
        held += 1
    assert held >= 1, "no row routes alike: nothing compared"


# ------------------------------------------------------- paged = dense


def test_paged_solo_matches_dense(model):
    """Solo paged admission: the scan from t0 after a matched prefix, with
    its forwards counted per scanned position."""
    _, cfg, _, tp, dense = model
    eng = _engine(cfg, tp, kv_layout="paged")
    _same(eng.serve(_reqs()), dense)
    st = eng.last_serve_stats
    assert st["prefix_hit_tokens"] == BS and st["packed_packs"] == 0
    assert st["prefill_forwards"] == st["prefill_tokens"] == sum(
        len(p) for p, _ in STREAM) - BS


def test_paged_packed_matches_dense_and_solo(model):
    """Batch-axis packs into the pool: the dense run's tokens, bit for bit;
    a pack of width W counts W forwards; the later chat request hits the
    prefix the first registered."""
    _, cfg, _, tp, dense = model
    eng = _engine(cfg, tp, kv_layout="paged", packed_prefill=True)
    widths, packed_tokens = [], []
    ragged = eng._prefill_ragged

    def recorded(toks, last):
        widths.append(toks.shape[1])
        packed_tokens.append(int((last + 1)[(toks != 0).any(1)].sum()))
        return ragged(toks, last)

    eng._prefill_ragged = recorded
    _same(eng.serve(_reqs()), dense)
    st = eng.last_serve_stats
    solo = st["admissions"] - st["packed_segments"]
    assert st["packed_packs"] == len(widths) > 0 and solo >= 1
    assert st["prefix_hit_tokens"] == BS * solo
    # a pack scans its width; a solo admission its positions from t0
    assert st["prefill_forwards"] == sum(widths) + st["prefill_tokens"] - sum(packed_tokens)
    assert all(w % BS == 0 for w in widths)


def test_paged_packed_shared_prefix_same_pack(model):
    """The reference's ``test_packed_shared_prefix_same_pack``: base and a
    fork of its first block pack together (no sharing within a pack);
    base again lands in a later sweep and is admitted solo on the prefix
    the pack registered.  Packed = solo, bit for bit."""
    _, cfg, _, tp, _ = model
    base = RNG.integers(1, 100, 2 * BS).astype(np.int32)
    fork = np.concatenate([base[:BS], RNG.integers(1, 100, 5)]).astype(np.int32)
    stream = [(base, 5), (fork, 4), (base.copy(), 3)]
    solo = _engine(cfg, tp, kv_layout="paged").serve(_reqs(stream))
    eng = _engine(cfg, tp, kv_layout="paged", packed_prefill=True)
    _same(eng.serve(_reqs(stream)), solo)
    st = eng.last_serve_stats
    assert st["prefix_hit_tokens"] > 0 and st["shared_blocks"] >= 1
    assert st["packed_segments"] == 2 and st["admissions"] == 3


def test_paged_generate_matches_dense(model):
    """``generate`` on the paged layout: the dense scan prefill laid out
    blockwise, then K4-path decode; the dense ``generate``'s tokens."""
    _, cfg, _, tp, _ = model
    prompts = [OWN[0], OWN[2], CHAT[1]]
    want = _engine(cfg, tp).generate(prompts, max_new=3)
    _same(_engine(cfg, tp, kv_layout="paged").generate(prompts, max_new=3), want)


def test_paged_posit16_kv_cache_matches_dense(model):
    """Under ``kv_cache_format="posit16"`` (rows rounded before caching) the
    pool pages without sharing: no lookup hits, the dense run's tokens (the
    stream's three requests without the shared prefix, which it would not
    share)."""
    _, cfg, _, tp, _ = model
    kcfg = cfg.with_numerics(kv_cache_format="posit16")
    stream = STREAM[1:4]
    want = _engine(kcfg, tp).serve(_reqs(stream))
    eng = _engine(kcfg, tp, kv_layout="paged", packed_prefill=True)
    _same(eng.serve(_reqs(stream)), want)
    st = eng.last_serve_stats
    assert st["prefix_hit_tokens"] == 0 and st["prefix_lookups"] == 0
    assert st["packed_packs"] > 0


# --------------------------------------------------------------- reference


def test_paged_packed_engine_matches_reference_engine(model):
    """The reference's paged packed moe engine on the same requests: a
    token may differ only where the reference's top-2 margin is within
    LOGIT_ULPS bf16 ulps, or after a routing flip at a near-tie (both
    packages' solo prefill of the prompt and the tokens before it, routes
    captured: the first flip named with its router logits' gap)."""
    jcfg, cfg, jp, tp, _ = model
    sc = dict(max_batch=2, max_seq=MAX_SEQ, kv_layout="paged", block_size=BS,
              packed_prefill=True)
    with reference_kernels():
        jeng = JServeEngine(jcfg, jp, JServeConfig(**sc))
        ref = [np.asarray(r) for r in jeng.serve([JRequest(p, max_new=m)
                                                  for p, m in STREAM])]
    eng = ServeEngine(cfg, tp, ServeConfig(**sc), device="cpu")
    outs = eng.serve(_reqs())
    assert eng.last_serve_stats["packed_packs"] > 0
    for (p, _), r, g in zip(STREAM, ref, outs):
        assert len(r) == len(g)
        if np.array_equal(r, g):
            continue
        j = int(np.flatnonzero(r != g)[0])
        seq = np.concatenate([p, r[:j]]).astype(np.int32)[None]
        with _captured_routes() as (jroutes, troutes):
            with reference_kernels():
                lg, _ = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(seq)},
                                   JT.init_cache(jcfg, 1, MAX_SEQ))
            TT.prefill(tp, cfg, torch.from_numpy(seq), TT.init_cache(cfg, 1, MAX_SEQ,
                                                                     device="cpu"))
        flip = _first_flip(jroutes, troutes, 0)
        if flip is not None:
            at, gap, top = flip
            print(f"token {j} differs after the experts differ at forward "
                  f"{at // cfg.n_layers}, layer {at % cfg.n_layers}: the reference's "
                  f"router logits' adjacent gap {gap:.4g} (max |logit| {top:.4g})")
            assert _near_tie(gap, top)
            continue
        row = np.asarray(lg[0, -1, :jcfg.vocab].astype(jnp.float32))
        top2 = np.sort(row)[-2:]
        print(f"token {j} differs; reference top-2 margin {top2[1] - top2[0]:.4g}")
        assert top2[1] - top2[0] <= LOGIT_ULPS * bf16_ulp(np.abs(row).max())
