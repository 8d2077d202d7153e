"""Layers of the serving and training paths: RMSNorm, RoPE, GQA attention,
MLP, and the MoE block of the moe family.

Port of the dense and MoE pieces of the reference package's
``models/layers.py``.
Compute dtype is bf16 (``COMPUTE_DTYPE``); the projections, the MLP and the
logits are plain bf16 ``torch.matmul`` products, as the reference leaves
its einsums to XLA.  Every weight is cast to the activations' dtype at its
use, as the reference casts: training keeps f32 master weights, serving
keeps bf16 copies (the cast is then a no-op and holds the same values).
cuBLAS reduces the bf16 products in f32: the entry points turn its
reduced-precision bf16 reductions off when they resolve a CUDA device
(``transformer.resolve_device``).

The divisions (RMSNorm's ``x / rms``, attention's ``o / l``, the MoE
router's softmax and its top-k renormalization) run on the posit SRT
kernels (K2, and K9 for the router softmax); under
``numerics.kv_cache_format`` the serving paths round every K/V row to the
posit grid through K12 (one launch a layer for K and V) before caching
it; attention runs on the posit
flash kernels: K3 when serving
from a dense cache (and for a prefix-sharing suffix prefill), K4 when
decoding from a paged block pool, K5 for a packed multi-prompt prefill, and
through :func:`posit_flash_attention_ste` (K6 forward, K7/K8 backward) in
:func:`attention_block`, the training path.  This is the
reference's ``fused=True`` path; its float-division and chunked jnp
attention paths are not ported.

Unlike the reference's pure functions, the cache-writing layers update the
cache tensors they are given in place (no copy of the multi-layer cache per
step).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from repro_torch.kernels.ops import posit_round_kv
from repro_torch.kernels.posit_flash_attn import (
    posit_flash_attention,
    posit_flash_attention_ste,
)
from repro_torch.numerics.formats import resolve_format
from repro_torch.numerics.posit_ops import (
    posit_rmsnorm_div,
    posit_router_norm,
    posit_softmax,
)
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16


def rmsnorm(x, w, cfg: ModelConfig):
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = posit_rmsnorm_div(xf, torch.sqrt(ms + cfg.norm_eps), cfg.numerics)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, heads, head_dim); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x, w, heads: int):
    """``einsum("bsd,dhk->bshk")`` with the weight stored as (d, h*k)."""
    B, S, _ = x.shape
    return torch.matmul(x, w.to(x.dtype)).reshape(B, S, heads, -1)


def _qkv(p, x, cfg: ModelConfig, positions):
    q = apply_rope(_proj(x, p["wq"], cfg.n_heads), positions, cfg.rope_theta)
    k = apply_rope(_proj(x, p["wk"], cfg.n_kv_heads), positions, cfg.rope_theta)
    v = _proj(x, p["wv"], cfg.n_kv_heads)
    return q, k, v


def _kv_round(k, v, cfg: ModelConfig):
    """Under ``numerics.kv_cache_format``, K/V rounded to that posit grid
    before they are cached or attended (in f32, then back to their dtype),
    as the reference rounds at insertion; the cache keeps the compute dtype
    and holds posit-grid values.  On CUDA tensors one launch of K12's round
    kernel rounds K and V in their dtype."""
    name = cfg.numerics.kv_cache_format
    if not name:
        return k, v
    return posit_round_kv(resolve_format(name), k, v)


def wo_project(o, wo):
    """Attention output projection ``einsum("bshk,hkd->bsd", o, wo)``."""
    B, S = o.shape[:2]
    return torch.matmul(o.reshape(B, S, -1), wo.to(o.dtype))


def attention_block(p, x, cfg: ModelConfig, positions, causal: bool = True,
                    window: int = 0):
    """Whole-sequence attention with no cache (the training path): the
    posit flash kernels through the straight-through wrapper (K6 forward,
    K7/K8 recompute backward; the reference's ``attn_bwd="fused"``)."""
    q, k, v = _qkv(p, x, cfg, positions)
    nm = cfg.numerics
    o = posit_flash_attention_ste(nm.div_fmt.n, nm.div_algo, causal, window, 0, 0.0,
                                  q, k, v)
    return wo_project(o.to(x.dtype), p["wo"])


def prefill_attention(p, x, cache_k, cache_v, cfg: ModelConfig, positions,
                      start=None, seg_q=None, seg_kv=None, seg_len: int = 0):
    """Whole-prompt attention filling cache rows [0, S) of ``cache_k`` /
    ``cache_v`` in place; ``start`` masks per-sequence pad prefixes.

    ``seg_q``/``seg_kv``/``seg_len`` switch on packed multi-prompt prefill
    (K5): (B, S) int32 per-position segment ids (query pads -2, key pads -1)
    make the concatenated sequence attend block-diagonally, each segment's
    rows the bits of its solo prefill."""
    dt = x.dtype
    q, k, v = _qkv(p, x, cfg, positions)
    k, v = _kv_round(k, v, cfg)
    S = x.shape[1]
    cache_k[:, :S] = k.to(cache_k.dtype)
    cache_v[:, :S] = v.to(cache_v.dtype)
    nm = cfg.numerics
    o = posit_flash_attention(nm.div_fmt, q, k, v, True, variant=nm.div_algo,
                              kv_start=start, seg_q=seg_q, seg_kv=seg_kv, seg_len=seg_len)
    return wo_project(o.to(dt), p["wo"])


def prefill_suffix_attention(p, x, cache_k, cache_v, cfg: ModelConfig, positions,
                             start, t0: int):
    """Prefix-sharing prefill: the suffix tokens ``[t0, t0 + S)`` attend a
    cache whose rows ``[0, t0)`` already hold a shared prefix.

    The suffix's K/V land at cache rows ``[t0, t0 + S)`` and the queries
    (offset ``t0``) attend rows ``[0, t0 + S)`` through K3: the same keys,
    in the same order and tiles, as a full prefill of the prompt, so the
    suffix's rows are its bits (the prefix rows come from an unpadded
    start-0 prefill in the cache's dtype, the compute dtype).  With
    ``t0 == 0`` this is :func:`prefill_attention`."""
    if t0 == 0:
        return prefill_attention(p, x, cache_k, cache_v, cfg, positions, start)
    dt = x.dtype
    q, k, v = _qkv(p, x, cfg, positions)
    k, v = _kv_round(k, v, cfg)
    end = t0 + x.shape[1]
    cache_k[:, t0:end] = k.to(cache_k.dtype)
    cache_v[:, t0:end] = v.to(cache_v.dtype)
    nm = cfg.numerics
    o = posit_flash_attention(nm.div_fmt, q, cache_k[:, :end].to(dt),
                              cache_v[:, :end].to(dt), True, q_offset=t0,
                              variant=nm.div_algo, kv_start=start)
    return wo_project(o.to(dt), p["wo"])


def _decode_qkv(p, x, pos, start, cfg: ModelConfig):
    positions = pos[:, None] if start is None else (pos - start)[:, None]
    q, k, v = _qkv(p, x, cfg, positions)
    return (q,) + _kv_round(k, v, cfg)


def decode_attention(p, x, cache_k, cache_v, pos, cfg: ModelConfig, start=None):
    """Single-token attention against the (B, S, KV, hd) cache.

    ``pos`` is a per-slot (B,) int32 vector: slot b writes its K/V at cache
    row ``pos[b]`` (clamped in bounds) in place, ropes at ``pos[b] -
    start[b]`` and attends rows ``[start[b], pos[b]]`` through one launch of
    the posit flash kernel (``q_pos = pos``, ``kv_len = pos + 1``,
    ``kv_start = start``), reading the bf16 cache directly.
    """
    dt = x.dtype
    B, S = cache_k.shape[:2]
    q, k, v = _decode_qkv(p, x, pos, start, cfg)
    bidx = torch.arange(B, device=x.device)
    pos_c = torch.clamp(pos, max=S - 1).long()
    cache_k[bidx, pos_c] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, pos_c] = v[:, 0].to(cache_v.dtype)
    nm = cfg.numerics
    o = posit_flash_attention(nm.div_fmt, q, cache_k, cache_v, True,
                              variant=nm.div_algo, kv_start=start,
                              kv_len=pos + 1, q_pos=pos)
    return wo_project(o.to(dt), p["wo"])


def decode_attention_paged(p, x, pool_k, pool_v, block_tables, pos, cfg: ModelConfig,
                           start=None):
    """Single-token attention against a paged cache: block pools
    (num_blocks, block_size, KV, hd) shared by every slot and a (B,
    max_blocks) int32 table mapping slot b's logical row r to pool row
    ``(block_tables[b, r // block_size], r % block_size)``.

    Slot b writes its new K/V into the page of its row ``pos[b]`` in place
    (parked slots, all-zero table rows, write the block-0 sink) and attends
    through one launch of K4, which reads the pages in place: the output is
    :func:`decode_attention`'s on the equivalent dense cache."""
    dt = x.dtype
    bs = pool_k.shape[1]
    S = block_tables.shape[1] * bs
    q, k, v = _decode_qkv(p, x, pos, start, cfg)
    pos_c = torch.clamp(pos, max=S - 1).long()
    bid = torch.gather(block_tables.long(), 1, (pos_c // bs)[:, None])[:, 0]
    row = pos_c % bs
    pool_k[bid, row] = k[:, 0].to(pool_k.dtype)
    pool_v[bid, row] = v[:, 0].to(pool_v.dtype)
    nm = cfg.numerics
    o = posit_flash_attention(nm.div_fmt, q, pool_k, pool_v, True,
                              variant=nm.div_algo, kv_start=start,
                              kv_len=pos + 1, q_pos=pos, block_tables=block_tables)
    return wo_project(o.to(dt), p["wo"])


def mlp_block(p, x):
    dt = x.dtype
    h = torch.matmul(x, p["w1"].to(dt))
    g = torch.matmul(x, p["w3"].to(dt))
    return torch.matmul(Fn.silu(h) * g, p["w2"].to(dt))


def _softmax(x, cfg: ModelConfig, axis: int = -1):
    return posit_softmax(x, cfg.numerics, axis=axis)


def top_k(x, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last axis,
    with ``jax.lax.top_k``'s tie rule: among equal values the lower index
    comes first (``torch.topk`` does not promise an order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_gates(logits, cfg: ModelConfig, eid=None):
    """``(gate, eid)`` of f32 router logits (..., E): the posit softmax (K9),
    top-k with lax's tie rule, the posit router norm (K2).  Given ``eid``
    (..., k), the gates are taken at those experts instead of the top k
    (a run that follows another run's routes: :mod:`.routes`)."""
    probs = _softmax(logits, cfg)
    if eid is None:
        gate, eid = top_k(probs, cfg.experts_per_token)
    else:
        gate = torch.gather(probs, -1, eid)
    return posit_router_norm(gate, cfg.numerics), eid


def moe_dispatch(eid, cfg: ModelConfig):
    """``(keep, dest, C)`` of the experts ``eid`` (B, S, k) chosen in each
    batch row: capacity ``C = ceil(S * k / E * capacity_factor)``; each
    (token, choice) ranks within its expert in token-major order, is kept
    when its rank is below ``C`` and goes to row ``eid * C + rank`` of the
    dispatch buffer, a dropped one to the sink row ``E * C``."""
    B, S, k = eid.shape
    E = cfg.n_experts
    C = max(int(math.ceil(S * k / E * cfg.capacity_factor)), 1)
    onehot = Fn.one_hot(eid, E)                                 # (B, S, k, E)
    flat = onehot.reshape(B, S * k, E)
    rank = ((torch.cumsum(flat, dim=1) - flat).reshape(B, S, k, E) * onehot).sum(-1)
    keep = rank < C
    dest = torch.where(keep, eid * C + rank, E * C)
    return keep, dest, C


def moe_route(p, x, cfg: ModelConfig):
    """The router of :func:`moe_block`: ``(gate, eid, keep, dest, C)``.

    Router logits in the activations' dtype cast to f32, then
    :func:`router_gates` and :func:`moe_dispatch`."""
    logits = torch.matmul(x, p["router"].to(x.dtype)).to(torch.float32)
    gate, eid = router_gates(logits, cfg)                       # (B, S, k)
    return (gate, eid, *moe_dispatch(eid, cfg))


def moe_block(p, x, cfg: ModelConfig):
    """Top-k MoE with capacity-bounded dispatch per batch row, as the
    reference's ``moe_block``: tokens go to a (B, E * C + 1, D) buffer (a
    kept row receives exactly one token, so a plain indexed write is exact;
    the sink row is discarded), the experts run as three batched bf16
    products over (E, B * C) rows, and each token gathers its k outputs back,
    weighted by its gate, in a bf16 sum over k.  Under autograd each (token,
    choice) takes its row's gradient, zero at the sink, as the reference's
    ``.at[].add`` dispatch: a dropped choice adds nothing to the experts'
    gradients."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    dt = x.dtype
    gate, _, keep, dest, C = moe_route(p, x, cfg)
    bidx = torch.arange(B, device=x.device)[:, None]
    dflat = dest.reshape(B, S * k)
    buf = torch.zeros((B, E * C + 1, D), dtype=dt, device=x.device)
    buf[bidx, dflat] = x[:, :, None, :].expand(B, S, k, D).reshape(B, S * k, D)
    xe = buf[:, :E * C].reshape(B, E, C, D)
    h = torch.einsum("becd,edf->becf", xe, p["w1"].to(dt))
    g = torch.einsum("becd,edf->becf", xe, p["w3"].to(dt))
    ye = torch.einsum("becf,efd->becd", Fn.silu(h) * g, p["w2"].to(dt))
    yflat = torch.cat([ye.reshape(B, E * C, D), torch.zeros((B, 1, D), dtype=dt,
                                                              device=x.device)], dim=1)
    ytok = yflat[bidx, dflat].reshape(B, S, k, D)
    return (ytok * gate[..., None].to(dt) * keep[..., None]).sum(2)


def embed(tok, tokens):
    return tok.to(COMPUTE_DTYPE)[tokens]


def logits(head, x):
    return torch.matmul(x, head.to(x.dtype))
