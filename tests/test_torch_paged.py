"""The port's paged KV cache on the CPU (smoke config): K4's twin against
the reference's paged kernel, the block allocator against the reference's,
and the paged engine's tokens against the dense engine's (bit for bit) and
the reference engine's (paged, under test_torch_serve's margin rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401  (fixtures)
    bf16_ulp, bits, one_torch_thread, ref_kernels, reference_kernels)
from repro.configs import get_config as jget
from repro.core.posit import PositFormat as JFmt
from repro.kernels.posit_flash_attn import posit_flash_attention as jflash
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import BlockAllocator as JBlockAllocator
from repro_torch.configs import get_config as tget
from repro_torch.core.posit import PositFormat
from repro_torch.kernels.posit_flash_attn import gather_pages, posit_flash_attention
from repro_torch.models import transformer as TT
from repro_torch.serve import FinishReason, Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import BlockAllocator

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLASH_TOL = 2e-3    # K3's twin against the reference (test_torch_flash_attn.py)
LOGIT_ULPS = 8      # as tests/test_torch_model.py
RNG = np.random.default_rng(29)
# _PA spans more than two blocks of 8; _PB shares _PA's first two full
# blocks and diverges at the block boundary; _PS fits in one block
_PA = np.array([11, 13, 2, 9, 4, 6, 8, 1, 12, 14, 15, 9, 2, 4, 21, 22, 31, 7], np.int32)
_PB = np.concatenate([_PA[:16], [99, 98, 97]]).astype(np.int32)
_PS = np.array([3, 5, 7], np.int32)
STREAM = [(_PA, 5), (_PS, 2), (_PB, 4), (_PA.copy(), 3)]
SC = dict(max_batch=2, max_seq=64)


# ------------------------------------------------------------------ K4 twin


def _paged_inputs(B=3, bs=8, max_blocks=8, H=3, KV=1, hd=32):
    NB = B * max_blocks + 1
    q = RNG.standard_normal((B, 1, H, hd)).astype(np.float32)
    pk = RNG.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    pv = RNG.standard_normal((NB, bs, KV, hd)).astype(np.float32)
    bt = (1 + RNG.permutation(NB - 1)[:B * max_blocks]).reshape(B, max_blocks)
    bt[1, :2] = bt[0, :2]          # shared pages
    bt[2, 5:] = 0                  # rows past the sequence's end: the sink
    return q, pk, pv, bt.astype(np.int32)


DECODE = {"q_pos": [40, 63, 37], "kv_len": [41, 64, 38], "kv_start": [0, 9, 30]}


def test_paged_twin_matches_reference_kernel(ref_kernels):
    q, pk, pv, bt = _paged_inputs()
    ref = jflash(JFmt(16), jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), True,
                 block_tables=jnp.asarray(bt),
                 **{n: jnp.asarray(np.array(x, np.int32)) for n, x in DECODE.items()})
    got = posit_flash_attention(PositFormat(16), *map(torch.from_numpy, (q, pk, pv)), True,
                                block_tables=torch.from_numpy(bt),
                                **{n: torch.tensor(x, dtype=torch.int32)
                                   for n, x in DECODE.items()})
    err = float(np.abs(np.asarray(ref) - got.numpy()).max())
    print(f"K4 twin: max|port - reference| = {err:.3g} (tolerance {FLASH_TOL})")
    assert err <= FLASH_TOL
    assert np.isfinite(got.numpy()).all()


def test_paged_twin_is_dense_twin_on_gathered_cache():
    q, pk, pv, bt = (torch.from_numpy(a) for a in _paged_inputs())
    kw = {n: torch.tensor(x, dtype=torch.int32) for n, x in DECODE.items()}
    o = posit_flash_attention(PositFormat(16), q, pk, pv, True, block_tables=bt, **kw)
    d = posit_flash_attention(PositFormat(16), q, gather_pages(pk, bt), gather_pages(pv, bt),
                              True, **kw)
    np.testing.assert_array_equal(bits(o), bits(d))


# ------------------------------------------------------------ the allocator


def _refcount_park(A):
    a = A(num_blocks=5, block_size=2)
    b0, b1 = a.alloc(), a.alloc()
    a.register_prefix([1, 2, 3, 4], [b0, b1])
    a.decref(b1)
    out = [b1 in a.cached, b1 in a.free, a.match_prefix([1, 2, 3, 4])]
    a.incref(b1)
    out += [b1 in a.cached, int(a.refcount[b1])]
    orphan = a.alloc()
    a.decref(orphan)
    return out + [orphan in a.free, orphan in a.cached]


def _lru_reclaim(A):
    a = A(num_blocks=3, block_size=2)
    b0, b1 = a.alloc(), a.alloc()
    a.register_prefix([1, 2], [b0])
    a.register_prefix([7, 8], [b1])
    a.decref(b0)
    a.decref(b1)
    return [a.alloc(), a.match_prefix([1, 2]), a.match_prefix([7, 8])]


def _cow_boundary(A):
    a = A(num_blocks=8, block_size=4)
    toks = list(range(1, 13))
    ids = [a.alloc() for _ in range(3)]
    a.register_prefix(toks, ids)
    fork = toks[:8] + [99, 98, 97, 96]
    out = [a.match_prefix(fork)]
    own = a.alloc()
    a.register_prefix(fork, ids[:2] + [own])
    return out + [own in ids, a.match_prefix(toks), a.match_prefix(fork), a.hits, a.lookups]


def _exhaustion(A):
    a = A(num_blocks=3, block_size=8)
    out = [a.alloc(), a.alloc()]
    for make in (a.alloc, lambda: A(num_blocks=1, block_size=8)):
        with pytest.raises(ValueError) as e:
            make()
        out.append(str(e.value))
    return out


def _hash_collision(A):
    a = A(num_blocks=8, block_size=2, hasher=lambda x: 0)
    b0, b1 = a.alloc(), a.alloc()
    a.register_prefix([1, 2], [b0])
    a.register_prefix([3, 4], [b1])
    return [a.match_prefix([1, 2]), a.match_prefix([3, 4]), a.match_prefix([5, 6])]


@pytest.mark.parametrize("scenario", [_refcount_park, _lru_reclaim, _cow_boundary,
                                      _exhaustion, _hash_collision],
                         ids=lambda f: f.__name__.strip("_"))
def test_allocator_matches_reference(scenario):
    """The reference's five allocator scenarios (tests/test_paged_kv.py)
    give the same results through both allocators."""
    assert scenario(BlockAllocator) == scenario(JBlockAllocator)


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engines():
    tcfg = tget("smollm_360m", smoke=True, fused=True)
    jcfg = jget("smollm_360m", smoke=True, fused=True)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
        ref = JServeEngine(jcfg, jp, JServeConfig(kv_layout="paged", block_size=8, **SC)).serve(
            [JRequest(p, max_new=m) for p, m in STREAM])
        ref = [np.asarray(r) for r in ref]
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    dense = ServeEngine(tcfg, tp, ServeConfig(**SC), device="cpu")
    paged = ServeEngine(tcfg, tp, ServeConfig(kv_layout="paged", block_size=8, **SC),
                        device="cpu")
    return jcfg, jp, dense, paged, ref


def test_generate_paged_matches_dense(engines):
    """Static batches decode the same bits from the pool as from dense slots."""
    _, _, dense, paged, _ = engines
    for prompts in ([_PS], [_PA], [_PS, _PA]):
        for a, b in zip(dense.generate(prompts, max_new=4), paged.generate(prompts, max_new=4)):
            np.testing.assert_array_equal(a, b)


def test_serve_prefix_shared_matches_solo(engines):
    """Mid-flight admission with prefix sharing (an exact repeat, a fork at a
    block boundary) gives each request its dense and its solo tokens, and
    pages were shared, not recomputed."""
    _, _, dense, paged, _ = engines
    reqs = [Request(p, max_new=m) for p, m in STREAM]
    douts, pouts = dense.serve(reqs), paged.serve(reqs)
    for r, a, b in zip(reqs, douts, pouts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(dense.generate([r.tokens], max_new=r.max_new)[0], b)
    st = paged.last_serve_stats
    assert st["kv_layout"] == "paged"
    assert st["prefix_hit_tokens"] > 0 and st["prefix_hit_rate"] > 0
    assert st["prefill_tokens"] + st["prefix_hit_tokens"] == st["prompt_tokens"]
    assert st["shared_blocks"] >= 2          # _PB reused _PA's two full blocks
    assert st["owned_blocks"] > 0 and st["prefix_matches"] >= 2


def test_serve_prefix_shared_posit64_matches_dense(engines):
    """At posit64 srt_r4_cs_of_fr (K4 / K5 built for it), the paged pool with
    prefix sharing and packed prefill gives every request the tokens of a
    posit64 dense solo-admission engine."""
    _check_paged_format(engines, "posit64")


@pytest.mark.parametrize("div_format", ["posit8", "posit32"])
def test_serve_prefix_shared_posit8_posit32_matches_dense(engines, div_format):
    """The same at posit8 and posit32 (K4 / K5 built for every plan of
    both)."""
    _check_paged_format(engines, div_format)


def _check_paged_format(engines, div_format):
    _, _, dense, _, _ = engines
    cfg = dense.cfg.with_numerics(div_format=div_format)
    reqs = [Request(p, max_new=m) for p, m in STREAM]
    douts = ServeEngine(cfg, dense.params, ServeConfig(**SC), device="cpu").serve(reqs)
    paged = ServeEngine(cfg, dense.params, ServeConfig(kv_layout="paged", block_size=8,
                                                       packed_prefill=True, **SC),
                        device="cpu")
    for a, b in zip(douts, paged.serve(reqs)):
        np.testing.assert_array_equal(a, b)
    st = paged.last_serve_stats
    assert st["prefix_hit_tokens"] > 0 and st["packed_packs"] >= 1


def test_reserved_blocks_scale_with_tokens(engines):
    _, _, _, paged, _ = engines
    paged.serve([Request(_PS, max_new=2)])
    st = paged.last_serve_stats
    assert st["peak_blocks_in_use"] == 1     # 4 rows, one block of 8
    assert st["pool_blocks"] == paged.sc.max_batch * 8


def test_pool_exhaustion_raises_or_sheds(engines):
    _, _, _, paged, _ = engines
    sc = ServeConfig(max_batch=1, max_seq=64, kv_layout="paged", block_size=8, num_blocks=2)
    with pytest.raises(ValueError, match="num_blocks"):
        ServeEngine(paged.cfg, paged.params, sc, device="cpu").serve(
            [Request(_PA, max_new=8)], strict=True)
    eng = ServeEngine(paged.cfg, paged.params, sc, device="cpu")
    outs = eng.serve([Request(_PA, max_new=8), Request(_PS, max_new=1)])
    assert outs[0].size == 0 and eng.last_results[0].finish is FinishReason.SHED
    assert "num_blocks" in eng.last_results[0].detail
    assert eng.last_results[1].finish is FinishReason.MAX_NEW   # one block is enough
    assert eng.last_serve_stats["shed"] == 1


def test_config_validation(engines):
    _, _, dense, _, _ = engines
    make = lambda **kw: ServeEngine(dense.cfg, dense.params, ServeConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        make(kv_layout="pagd")
    with pytest.raises(ValueError, match="block_size"):
        make(kv_layout="paged", block_size=12)
    with pytest.raises(ValueError, match="block_size"):
        make(kv_layout="paged", block_size=256)
    with pytest.raises(ValueError, match="multiple of block_size"):
        make(kv_layout="paged", max_seq=100, block_size=16)
    with pytest.raises(ValueError, match="num_blocks"):
        make(kv_layout="paged", num_blocks=1)
    make(kv_layout="paged", block_size=128, max_seq=128)


def test_paged_matches_reference_engine(engines):
    """Paged tokens equal the reference's paged engine's, a difference being
    allowed only where the reference's top-2 margin is within the model
    test's logit bound (tests/test_torch_serve.py)."""
    jcfg, jp, _, paged, ref = engines
    outs = paged.serve([Request(p, max_new=m) for p, m in STREAM])
    for (p, _), r, g in zip(STREAM, ref, outs):
        if np.array_equal(r, g):
            continue
        j = int(np.flatnonzero(r != g)[0])
        with reference_kernels():
            seq = jnp.asarray(np.concatenate([p, r[:j]])[None])
            lg, _ = JT.prefill(jp, jcfg, {"tokens": seq}, JT.init_cache(jcfg, 1, 64))
        row = np.asarray(lg[0, -1, :jcfg.vocab].astype(jnp.float32))
        top2 = np.sort(row)[-2:]
        print(f"token {j} differs; reference top-2 margin {top2[1] - top2[0]:.4g}")
        assert top2[1] - top2[0] <= LOGIT_ULPS * bf16_ulp(np.abs(row).max())


def test_paged_cache_helpers_round_trip(engines):
    """scatter_dense_to_pool, mini_cache_with_prefix and write_cache_blocks
    move rows, never change them."""
    _, _, dense, _, _ = engines
    cfg = dense.cfg
    g = torch.Generator().manual_seed(0)
    d = {n: torch.randn((cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim), generator=g)
         .to(torch.bfloat16) for n in ("k", "v")}
    pool = TT.init_paged_cache(cfg, 9, 8, device="cpu")
    bt = torch.tensor([[4, 2, 7, 1], [3, 8, 6, 5]], dtype=torch.int32)
    TT.scatter_dense_to_pool(cfg, pool, d, bt)
    mini = TT.mini_cache_with_prefix(cfg, pool, [3, 8, 6], 32)
    for n in ("k", "v"):
        assert torch.equal(mini[n][:, 0, :24], d[n][:, 1, :24])
        assert not mini[n][:, 0, 24:].any()
    TT.write_cache_blocks(cfg, pool, mini, [1, 2], 1)
    for n in ("k", "v"):
        assert torch.equal(pool[n][:, 1], d[n][:, 1, 8:16])
        assert torch.equal(pool[n][:, 2], d[n][:, 1, 16:24])
