"""Dense layers of the serving and training paths: RMSNorm, RoPE, GQA
attention, MLP.

Port of the dense pieces of the reference package's ``models/layers.py``.
Compute dtype is bf16 (``COMPUTE_DTYPE``); the projections, the MLP and the
logits are plain bf16 ``torch.matmul`` products, as the reference leaves
its einsums to XLA.  Every weight is cast to the activations' dtype at its
use, as the reference casts: training keeps f32 master weights, serving
keeps bf16 copies (the cast is then a no-op and holds the same values).
cuBLAS reduces the bf16 products in f32: the entry points turn its
reduced-precision bf16 reductions off when they resolve a CUDA device
(``transformer.resolve_device``).

The divisions (RMSNorm's ``x / rms`` and attention's ``o / l``) run on the
posit SRT kernels, and attention on the posit flash kernels: K3 when serving
from a cache, and through :func:`posit_flash_attention_ste` (K6 forward,
K7/K8 backward) in :func:`attention_block`, the training path.  This is the
reference's ``fused=True`` path; its float-division and chunked jnp
attention paths are not ported.

Unlike the reference's pure functions, the cache-writing layers update the
cache tensors they are given in place (no copy of the multi-layer cache per
step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.kernels.posit_flash_attn import (
    posit_flash_attention,
    posit_flash_attention_ste,
)
from repro_torch.numerics.posit_ops import posit_rmsnorm_div
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
                      start=None):
    """Whole-prompt attention filling cache rows [0, S) of ``cache_k`` /
    ``cache_v`` in place (the reference's ``prefill_suffix_attention`` at
    ``t0 = 0``); ``start`` masks per-sequence pad prefixes."""
    dt = x.dtype
    q, k, v = _qkv(p, x, cfg, positions)
    S = x.shape[1]
    cache_k[:, :S] = k.to(cache_k.dtype)
    cache_v[:, :S] = v.to(cache_v.dtype)
    nm = cfg.numerics
    o = posit_flash_attention(nm.div_fmt, q, k, v, True, variant=nm.div_algo,
                              kv_start=start)
    return wo_project(o.to(dt), p["wo"])


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
    positions = pos[:, None] if start is None else (pos - start)[:, None]
    q, k, v = _qkv(p, x, cfg, positions)
    bidx = torch.arange(B, device=x.device)
    pos_c = torch.clamp(pos, max=S - 1).long()
    cache_k[bidx, pos_c] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, pos_c] = v[:, 0].to(cache_v.dtype)
    nm = cfg.numerics
    o = posit_flash_attention(nm.div_fmt, q, cache_k, cache_v, True,
                              variant=nm.div_algo, kv_start=start,
                              kv_len=pos + 1, q_pos=pos)
    return wo_project(o.to(dt), p["wo"])


def mlp_block(p, x):
    dt = x.dtype
    h = torch.matmul(x, p["w1"].to(dt))
    g = torch.matmul(x, p["w3"].to(dt))
    return torch.matmul(Fn.silu(h) * g, p["w2"].to(dt))


def embed(tok, tokens):
    return tok.to(COMPUTE_DTYPE)[tokens]


def logits(head, x):
    return torch.matmul(x, head.to(x.dtype))
