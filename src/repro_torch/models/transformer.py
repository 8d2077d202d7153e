"""Dense decoder LM for serving: parameters, KV cache, prefill and decode.

Port of the dense-family serving entry points of the reference package's
``models/transformer.py``:

  init_params(cfg, generator, device)      -> params (random, from a seed)
  params_from_numpy(tree, cfg, device)     -> params from the reference's
                                              ``T.init_params`` pytree
  init_cache(cfg, batch, seq_len, device)  -> {"k", "v"}: (L, B, S, KV, hd)
  prefill(params, cfg, tokens, cache, start)     -> (logits, cache)
  decode_step(params, cfg, cache, token, pos, start, with_health)
  write_cache_slot(cfg, cache, mini, slot) -> cache
  logits_health(cfg, logits)               -> (B,) bool

Parameters are a dict: ``tok`` (padded_vocab, D) and ``head`` (D,
padded_vocab) in bf16, ``ln_f`` (D,) f32, and ``layers``, a list of per-layer
dicts of bf16 matrices (``wq`` (D, H*hd), ``wk``/``wv`` (D, KV*hd), ``wo``
(H*hd, D), ``w1``/``w3`` (D, d_ff), ``w2`` (d_ff, D)) and f32 ``ln1``/``ln2``.
The cache is updated in place and also returned.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  "(ROADMAP.md)")


def _tensor(w, device, dtype):
    return torch.from_numpy(np.array(w)).to(device=device, dtype=dtype)


def _layer_from(ln1, ln2, wq, wk, wv, wo, w1, w3, w2, device):
    bf = lambda w: _tensor(w, device, L.COMPUTE_DTYPE)
    f32 = lambda w: _tensor(w, device, torch.float32)
    D = wq.shape[0]
    return {"ln1": f32(ln1), "ln2": f32(ln2),
            "wq": bf(wq.reshape(D, -1)), "wk": bf(wk.reshape(D, -1)),
            "wv": bf(wv.reshape(D, -1)), "wo": bf(wo.reshape(-1, D)),
            "w1": bf(w1), "w3": bf(w3), "w2": bf(w2)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters with the reference's init scales, drawn from
    ``generator`` (on its own device) and stored on ``device``."""
    _require_dense(cfg)
    device = resolve_device(device)
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    gdev = generator.device

    def rnd(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
        return torch.randn(shape, generator=generator, device=gdev) * scale

    bf = lambda w: w.to(device=device, dtype=L.COMPUTE_DTYPE)
    zeros = lambda: torch.zeros(D, dtype=torch.float32, device=device)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": zeros(), "ln2": zeros(),
            "wq": bf(rnd((D, H * hd))), "wk": bf(rnd((D, KV * hd))),
            "wv": bf(rnd((D, KV * hd))),
            "wo": bf(rnd((H * hd, D), scale=1.0 / math.sqrt(H * hd))),
            "w1": bf(rnd((D, F))), "w3": bf(rnd((D, F))), "w2": bf(rnd((F, D))),
        })
    return {"tok": bf(rnd((cfg.padded_vocab, D), scale=0.02)),
            "head": bf(rnd((D, cfg.padded_vocab))),
            "ln_f": zeros(), "layers": layers}


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> Params:
    """Port's parameters from the reference's ``T.init_params`` pytree, given
    as numpy arrays (``jax.tree.map(np.asarray, params)``)."""
    _require_dense(cfg)
    device = resolve_device(device)
    blk = tree["blocks"]
    layers = [_layer_from(blk["ln1"][i], blk["ln2"][i],
                          blk["attn"]["wq"][i], blk["attn"]["wk"][i],
                          blk["attn"]["wv"][i], blk["attn"]["wo"][i],
                          blk["mlp"]["w1"][i], blk["mlp"]["w3"][i],
                          blk["mlp"]["w2"][i], device)
              for i in range(cfg.n_layers)]
    emb = tree["embed"]
    return {"tok": _tensor(emb["tok"], device, L.COMPUTE_DTYPE),
            "head": _tensor(emb["head"], device, L.COMPUTE_DTYPE),
            "ln_f": _tensor(tree["ln_f"], device, torch.float32), "layers": layers}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda",
               dtype=torch.bfloat16):
    """Decode cache of ``batch`` persistent slots of ``seq_len`` rows."""
    _require_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_cache_slot(cfg: ModelConfig, cache, mini, slot: int):
    """Copy a batch=1 ``mini`` cache into batch slot ``slot`` (admission)."""
    for name in ("k", "v"):
        cache[name][:, slot] = mini[name][:, 0]
    return cache


def logits_health(cfg: ModelConfig, lg) -> torch.Tensor:
    """(B,) bool: True where the last position's logits over the real vocab
    are all finite (a NaR anywhere in a slot's datapath shows up here)."""
    row = lg[:, -1, :cfg.vocab].to(torch.float32)
    return torch.isfinite(row).all(dim=-1)


def prefill(params: Params, cfg: ModelConfig, tokens, cache, start=None):
    """Fill the cache from whole prompts in one pass per layer.

    ``tokens``: (B, S) int; ``start``: optional (B,) int32 pad-prefix
    lengths of left-padded prompts (RoPE positions are relative to it and
    pads are masked).  Returns ``(logits at the last position, cache)``.
    """
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    if start is not None:
        positions = positions - start[:, None]
    x = L.embed(params["tok"], tokens)
    for i, p in enumerate(params["layers"]):
        a = L.rmsnorm(x, p["ln1"], cfg)
        x = x + L.prefill_attention(p, a, cache["k"][i], cache["v"][i], cfg,
                                    positions, start)
        a = L.rmsnorm(x, p["ln2"], cfg)
        x = x + L.mlp_block(p, a)
    x = L.rmsnorm(x[:, -1:], params["ln_f"], cfg)
    return L.logits(params["head"], x), cache


def decode_step(params: Params, cfg: ModelConfig, cache, token, pos,
                start=None, with_health: bool = False):
    """One-token decode. ``token``: (B, 1) int; ``pos``: per-slot (B,) int32
    positions; ``start``: optional (B,) int32 start offsets.

    Returns ``(logits, cache)``, plus the (B,) :func:`logits_health` probe
    when ``with_health``.
    """
    x = L.embed(params["tok"], token)
    for i, p in enumerate(params["layers"]):
        a = L.rmsnorm(x, p["ln1"], cfg)
        x = x + L.decode_attention(p, a, cache["k"][i], cache["v"][i], pos, cfg,
                                   start)
        a = L.rmsnorm(x, p["ln2"], cfg)
        x = x + L.mlp_block(p, a)
    x = L.rmsnorm(x, params["ln_f"], cfg)
    lg = L.logits(params["head"], x)
    if with_health:
        return lg, cache, logits_health(cfg, lg)
    return lg, cache
