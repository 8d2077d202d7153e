"""Decoder LMs, dense, MoE and hybrid: parameters, training loss, KV cache,
prefill, decode.

Port of the dense-, moe- and hybrid-family entry points of the reference
package's ``models/transformer.py``.  The dense and moe families serve
(dense slots or a paged pool, solo or packed prefill) and train.  The moe
and hybrid families' prefill is a scan of decode steps, so they pack on the
batch axis (``prefill`` on N left-padded rows into dense slots,
:func:`prefill_batch_ragged` on N right-padded rows at start 0);
``prefill_packed`` raises for them.  The hybrid family (RecurrentGemma:
RG-LRU blocks, and local attention every ``attn_period``-th layer) keeps
O(window) state a slot, so it has no paged layout; its ``forward`` attends
through K6 with ``window=cfg.local_window``, and its decode attends a ring
buffer of ``min(local_window, seq_len)`` rows with a float softmax (no posit
divide), as the reference's:

  init_params(cfg, generator, device, dtype)  -> params (random, from a seed)
  params_from_numpy(tree, cfg, device, dtype) -> params from the reference's
                                                 ``T.init_params`` pytree
  forward(params, cfg, batch)              -> final-norm hidden states
  train_loss(params, cfg, batch)           -> (loss, metrics)
  init_cache(cfg, batch, seq_len, device)  -> {"k", "v"}: (L, B, S, KV, hd);
                                              hybrid: {"layers_list": [...]}
  init_paged_cache(cfg, num_blocks, block_size, device)
                                           -> {"k", "v"}: (L, NB, bs, KV, hd)
  prefill(params, cfg, tokens, cache, start, t0) -> (logits, cache)
      (moe: one decode_step per prompt position, the reference's scan)
  prefill_packed(params, cfg, tokens, cache, positions, seg_ids, last_idx,
                 seg_len)                  -> ((N, 1, V) logits, cache)
  prefill_batch_ragged(params, cfg, tokens, cache, start, last_idx)
                                           -> ((N, 1, V) logits, cache)
  decode_step(params, cfg, cache, token, pos, start, block_tables,
              with_health)
  write_cache_slot(cfg, cache, mini, slot) -> cache
  write_cache_slots(cfg, cache, mini, slots) -> cache
  write_cache_slot_segments(cfg, cache, mini, slots, seg_len)
  write_cache_blocks(cfg, cache, mini, block_ids, first_block)
  mini_cache_with_prefix(cfg, cache, block_ids, rows)
  scatter_dense_to_pool(cfg, cache, dense, block_tables)
  scatter_segments_to_pool(cfg, cache, mini, block_ids, seg_len)
  logits_health(cfg, logits)               -> (B,) bool

Parameters are a dict: ``tok`` (padded_vocab, D), ``head`` (D,
padded_vocab), ``ln_f`` (D,) f32, and ``layers``, a list of per-layer dicts
of matrices (``wq`` (D, H*hd), ``wk``/``wv`` (D, KV*hd), ``wo`` (H*hd, D),
``w1``/``w3`` (D, d_ff), ``w2`` (d_ff, D)) and f32 ``ln1``/``ln2``; a moe
layer holds ``router`` (D, E), ``w1``/``w3`` (E, D, d_ff) and ``w2`` (E,
d_ff, D) in place of the MLP's matrices, and a hybrid recurrent layer
holds ``rec`` (:mod:`.rglru`'s ``in_x``, ``in_gate``, ``conv_w``,
``conv_b``, ``wa``, ``wx``, ``lam``, ``out``) in place of the attention's.
The matrices are bf16 for serving (the default ``dtype``) and f32 masters for
training; layers cast them to the compute dtype at use.  The cache is
updated in place and also returned.

The paged cache keeps one block pool per layer, stacked (L, num_blocks,
block_size, KV, hd); block ids form one id space across layers (a slot's
logical block j is the same pool index in every layer), so one (B,
max_blocks) int32 table serves all layers.  Block 0 is the write sink of
parked slots and is never handed out (``serve.engine.BlockAllocator``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import ModelConfig
from .rglru import init_rglru_block, init_rglru_state, rglru_block

Params = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (pass ``device="cpu"`` to run on the CPU).

    Every entry point resolves its device here, so a CUDA device also turns
    off cuBLAS's reduced-precision bf16 reductions and TF32: bf16 products
    then reduce in f32, as the reference's do and as the tests check."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the port on the CPU")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _tensor(w, device, dtype):
    return torch.from_numpy(np.array(w)).to(device=device, dtype=dtype)


def _layer_from(blk, i, device, dtype):
    """Layer ``i`` of the reference's stacked ``blocks`` pytree, or (``i``
    None) the reference's block ``blk`` of the hybrid family's
    ``blocks_list``."""
    pick = (lambda w: w) if i is None else (lambda w: w[i])
    mat = lambda w: _tensor(pick(w), device, dtype)
    f32 = lambda w: _tensor(pick(w), device, torch.float32)
    lay = {"ln1": f32(blk["ln1"]), "ln2": f32(blk["ln2"])}
    if "rec" in blk:
        lay["rec"] = {name: (f32 if name in ("conv_b", "lam") else mat)(w)
                      for name, w in blk["rec"].items()}
    else:
        attn = blk["attn"]
        D = attn["wq"].shape[-3]
        lay.update({"wq": mat(attn["wq"]).reshape(D, -1), "wk": mat(attn["wk"]).reshape(D, -1),
                    "wv": mat(attn["wv"]).reshape(D, -1), "wo": mat(attn["wo"]).reshape(-1, D)})
    ffn = blk["moe"] if "moe" in blk else blk["mlp"]
    lay.update({name: mat(w) for name, w in ffn.items()})
    return lay


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=L.COMPUTE_DTYPE) -> Params:
    """Random parameters with the reference's init scales, drawn from
    ``generator`` (on its own device) and stored on ``device``: matrices
    in ``dtype`` (bf16 to serve, f32 to train), norms in f32.

    The reference's rule ``1/sqrt(shape[0])`` holds for every matrix but the
    embedding, ``wo`` and the router, so the expert weights (E, ., .) are
    drawn at ``1/sqrt(E)``, as the reference's ``init_moe`` draws them."""
    device = resolve_device(device)
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    gdev = generator.device

    def rnd(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
        return torch.randn(shape, generator=generator, device=gdev) * scale

    mat = lambda w: w.to(device=device, dtype=dtype)
    zeros = lambda: torch.zeros(D, dtype=torch.float32, device=device)
    E = cfg.n_experts
    layers = []
    for i in range(cfg.n_layers):
        lay = {"ln1": zeros(), "ln2": zeros()}
        if cfg.is_attn_layer(i):
            lay.update(wq=mat(rnd((D, H * hd))), wk=mat(rnd((D, KV * hd))),
                       wv=mat(rnd((D, KV * hd))),
                       wo=mat(rnd((H * hd, D), scale=1.0 / math.sqrt(H * hd))))
        else:
            lay["rec"] = init_rglru_block(cfg, generator, device, dtype)
        if cfg.family == "moe":
            lay.update(router=mat(rnd((D, E), scale=0.02)), w1=mat(rnd((E, D, F))),
                       w3=mat(rnd((E, D, F))), w2=mat(rnd((E, F, D))))
        else:
            lay.update(w1=mat(rnd((D, F))), w3=mat(rnd((D, F))), w2=mat(rnd((F, D))))
        layers.append(lay)
    return {"tok": mat(rnd((cfg.padded_vocab, D), scale=0.02)),
            "head": mat(rnd((D, cfg.padded_vocab))),
            "ln_f": zeros(), "layers": layers}


def params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                      dtype=L.COMPUTE_DTYPE) -> Params:
    """Port's parameters from the reference's ``T.init_params`` pytree, given
    as numpy arrays (``jax.tree.map(np.asarray, params)``); matrices in
    ``dtype``."""
    device = resolve_device(device)
    if cfg.family == "hybrid":
        layers = [_layer_from(blk, None, device, dtype) for blk in tree["blocks_list"]]
    else:
        layers = [_layer_from(tree["blocks"], i, device, dtype) for i in range(cfg.n_layers)]
    emb = tree["embed"]
    return {"tok": _tensor(emb["tok"], device, dtype),
            "head": _tensor(emb["head"], device, dtype),
            "ln_f": _tensor(tree["ln_f"], device, torch.float32), "layers": layers}


def _ffn(p, h, cfg: ModelConfig):
    """The block's feed-forward: the experts of a moe layer, else the MLP."""
    return L.moe_block(p, h, cfg) if cfg.family == "moe" else L.mlp_block(p, h)


def _dense_block(p, x, cfg: ModelConfig, positions, window: int = 0):
    h = L.rmsnorm(x, p["ln1"], cfg)
    x = x + L.attention_block(p, h, cfg, positions, window=window)
    h = L.rmsnorm(x, p["ln2"], cfg)
    return x + _ffn(p, h, cfg)


def _rec_block(p, x, cfg: ModelConfig, positions, window: int = 0):
    """The hybrid family's recurrent block: RMSNorm, RG-LRU, RMSNorm, MLP
    (the recurrence takes no positions and no window)."""
    h = L.rmsnorm(x, p["ln1"], cfg)
    x = x + rglru_block(p["rec"], h, cfg)
    h = L.rmsnorm(x, p["ln2"], cfg)
    return x + _ffn(p, h, cfg)


def forward(params: Params, cfg: ModelConfig, batch):
    """Final-norm hidden states (B, S, D) of ``batch["tokens"]`` (B, S).

    With ``cfg.remat == "full"`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
    after the forward and recomputed in the backward, the reference's
    ``jax.checkpoint`` per block.  The recompute of a moe block routes
    every token as its forward did: K9, the top-k's tie rule and the
    fixed-order sums give the same bits on the same inputs.

    The hybrid family's attention layers attend a ``cfg.local_window``-key
    window (K6 with ``window``), its other layers run the RG-LRU scan.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed(params["tok"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    window = cfg.local_window if cfg.family == "hybrid" else 0
    for i, p in enumerate(params["layers"]):
        block = _dense_block if cfg.is_attn_layer(i) else _rec_block
        if cfg.remat == "full":
            x = checkpoint(block, p, x, cfg, positions, window, use_reentrant=False)
        else:
            x = block(p, x, cfg, positions, window)
    return L.rmsnorm(x, params["ln_f"], cfg)


def train_loss(params: Params, cfg: ModelConfig, batch):
    """Next-token cross-entropy plus a small z-loss, as the reference's
    ``train_loss``: returns ``(loss, metrics)`` with ``nll``, ``zloss``,
    ``tokens`` and ``acc``; an optional ``batch["loss_mask"]`` (B, S)
    weights the targets."""
    h = forward(params, cfg, batch)
    tokens = batch["tokens"]
    lg = L.logits(params["head"], h).to(torch.float32)
    targets = tokens[:, 1:].long()
    lg = lg[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = mask[:, 1:].to(torch.float32) if mask is not None else torch.ones_like(gold)
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    zloss = 1e-4 * ((lse * mask) ** 2).sum() / denom
    acc = ((lg.argmax(-1) == targets).to(torch.float32) * mask).sum() / denom
    metrics = {"nll": loss, "zloss": zloss, "tokens": denom, "acc": acc}
    return loss + zloss, metrics


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda",
               dtype=torch.bfloat16):
    """Decode cache of ``batch`` persistent slots of ``seq_len`` rows.

    The hybrid family's is ``{"layers_list": [...]}``, one entry a layer: a
    ring buffer ``{"k", "v"}`` (B, W, KV, hd) of ``W = min(local_window,
    seq_len)`` rows for an attention layer, the RG-LRU state ``{"conv",
    "h"}`` for a recurrent one; every leaf has the batch on axis 0."""
    device = resolve_device(device)
    if cfg.family == "hybrid":
        W = min(cfg.local_window, seq_len)
        ring = (batch, W, cfg.n_kv_heads, cfg.head_dim)
        caches = []
        for i in range(cfg.n_layers):
            if cfg.is_attn_layer(i):
                caches.append({"k": torch.zeros(ring, dtype=dtype, device=device),
                               "v": torch.zeros(ring, dtype=dtype, device=device)})
            else:
                conv, h = init_rglru_state(cfg, batch, device, dtype)
                caches.append({"conv": conv, "h": h})
        return {"layers_list": caches}
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_leaves(cache):
    """The tensors of a cache, in a fixed order (the dense and paged caches'
    ``k``, ``v``; the hybrid list's leaves layer by layer)."""
    if "layers_list" in cache:
        return [t for c in cache["layers_list"] for t in c.values()]
    return list(cache.values())


def map_cache(fn, cache):
    """A cache of the same structure with ``fn`` applied to every leaf."""
    if "layers_list" in cache:
        return {"layers_list": [{k: fn(t) for k, t in c.items()}
                                for c in cache["layers_list"]]}
    return {k: fn(t) for k, t in cache.items()}


def _no_pages(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"family {cfg.family!r} has no {what} (its recurrent state "
                         "and ring buffer are O(window) a slot); use init_cache")


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, device="cuda",
                     dtype=torch.bfloat16):
    """Paged decode cache: per layer one block pool of ``num_blocks`` pages
    of ``block_size`` rows shared by every slot, stacked over layers (the
    dense and moe families only)."""
    _no_pages(cfg, "pageable KV cache")
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_cache_slot(cfg: ModelConfig, cache, mini, slot: int):
    """Copy a batch=1 ``mini`` cache into batch slot ``slot`` (admission)."""
    return write_cache_slots(cfg, cache, mini, [slot])


def write_cache_slot_segments(cfg: ModelConfig, cache, mini, slots, seg_len: int):
    """Copy each ``seg_len``-wide segment of a packed batch=1 ``mini`` cache
    (L, 1, N * seg_len, KV, hd) into its slot ``slots[i]``, rows beyond the
    segment zeroed (as a solo admission's fresh mini cache leaves them).
    Writes go in pack order, so a later segment wins a shared slot (the
    engine points dummy segments at a real segment's slot, first)."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"family {cfg.family!r} has no packed-segment cache layout")
    for i, slot in enumerate(slots):
        for name in ("k", "v"):
            c = cache[name]
            c[:, slot] = 0
            c[:, slot, :seg_len] = mini[name][:, 0, i * seg_len:(i + 1) * seg_len]
    return cache


def write_cache_blocks(cfg: ModelConfig, cache, mini, block_ids, first_block: int):
    """Write whole blocks ``[first_block, first_block + len(block_ids))`` of a
    batch=1 dense ``mini`` cache (L, 1, rows, KV, hd) into the pool pages
    ``block_ids`` of a paged ``cache`` (paged admission: the owned blocks
    after a shared prefix)."""
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=cache["k"].device)
    nb = ids.numel()
    for name in ("k", "v"):
        pool = cache[name]
        L_, _, bs = pool.shape[:3]
        blocks = mini[name][:, 0].reshape(L_, -1, bs, *pool.shape[3:])
        pool[:, ids] = blocks[:, first_block:first_block + nb].to(pool.dtype)
    return cache


def mini_cache_with_prefix(cfg: ModelConfig, cache, block_ids, rows: int):
    """A batch=1 dense mini cache (L, 1, rows, KV, hd) holding the pool pages
    ``block_ids`` in its first rows and zeros beyond: the shared prefix a
    prefix-sharing admission extends (also the copy-on-write source of a
    partly shared last block, which then lands in an owned page)."""
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=cache["k"].device)
    out = {}
    for name in ("k", "v"):
        pool = cache[name]
        L_ = pool.shape[0]
        g = pool[:, ids].reshape(L_, 1, -1, *pool.shape[3:])
        m = torch.zeros((L_, 1, rows) + tuple(pool.shape[3:]), dtype=pool.dtype,
                        device=pool.device)
        m[:, :, :g.shape[2]] = g
        out[name] = m
    return out


def write_cache_slots(cfg: ModelConfig, cache, mini, slots):
    """Copy batch row ``i`` of an N-row ``mini`` cache (L, N, S, KV, hd) into
    slot ``slots[i]`` (the moe family's batch-axis packed admission; rows
    span the whole slot, so nothing of a previous occupant survives).
    Writes go in pack order, so a later row wins a shared slot (the engine
    points dummy rows at a real row's slot, first).  The stacked caches
    hold the batch on axis 1, the hybrid list's leaves on axis 0."""
    axis = 0 if cfg.family == "hybrid" else 1
    for i, slot in enumerate(slots):
        for c, m in zip(cache_leaves(cache), cache_leaves(mini)):
            c.select(axis, slot).copy_(m.select(axis, i))
    return cache


def scatter_dense_to_pool(cfg: ModelConfig, cache, dense, block_tables):
    """Lay a dense (L, B, S, KV, hd) cache out blockwise into the pools
    through ``block_tables`` (B, S // block_size): static-batch paged decode
    prefills densely, then decodes from the pages."""
    bt = torch.as_tensor(block_tables, dtype=torch.long, device=cache["k"].device)
    for name in ("k", "v"):
        pool = cache[name]
        L_, _, bs = pool.shape[:3]
        d = dense[name]
        B = d.shape[1]
        pool[:, bt] = d.reshape(L_, B, -1, bs, *pool.shape[3:]).to(pool.dtype)
    return cache


def scatter_segments_to_pool(cfg: ModelConfig, cache, mini, block_ids, seg_len: int):
    """Write each segment of a packed mini cache blockwise into the pool.

    The mini cache is the dense family's concatenated pack, batch=1 (L, 1,
    N * seg_len, KV, hd), or the moe family's batch-axis pack (L, N,
    seg_len, KV, hd) of :func:`prefill_batch_ragged`: both lay segment i's
    block j at flat block ``i * (seg_len // block_size) + j``.
    ``block_ids`` (N, seg_len // block_size) names the page of segment i's
    block j, with block 0 (the sink) wherever the segment owns no page
    (shared prefix blocks, blocks past its prompt, a faulted segment), so
    shared pages are never written."""
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=cache["k"].device)
    keep = ids.reshape(-1) > 0
    for name in ("k", "v"):
        pool = cache[name]
        L_, _, bs = pool.shape[:3]
        blocks = mini[name].reshape(L_, -1, bs, *pool.shape[3:])
        pool[:, ids.reshape(-1)[keep]] = blocks[:, keep].to(pool.dtype)
    return cache


def logits_health(cfg: ModelConfig, lg) -> torch.Tensor:
    """(B,) bool: True where the last position's logits over the real vocab
    are all finite (a NaR anywhere in a slot's datapath shows up here)."""
    row = lg[:, -1, :cfg.vocab].to(torch.float32)
    return torch.isfinite(row).all(dim=-1)


def prefill(params: Params, cfg: ModelConfig, tokens, cache, start=None, t0: int = 0):
    """Fill the cache from whole prompts in one pass per layer.

    ``tokens``: (B, S) int; ``start``: optional (B,) int32 pad-prefix
    lengths of left-padded prompts (RoPE positions are relative to it and
    pads are masked).  ``t0 > 0`` prefills only tokens ``[t0, S)`` after a
    shared prefix whose K/V already fill cache rows ``[0, t0)``
    (:func:`mini_cache_with_prefix`); the suffix's logits are those of the
    full prefill.  Returns ``(logits at the last position, cache)``.

    The moe and hybrid families run one :func:`decode_step` per position
    instead, as the reference scans: the moe family's expert capacity
    ``ceil(S * k / E * cf)`` depends on the number of tokens a forward sees,
    so one token per forward keeps a prompt's routing the same alone,
    batched or left-padded; the hybrid family's recurrent state stays at
    its init until ``pos >= start`` (:func:`_gate_state`), so left pads never
    enter it.
    """
    if cfg.family != "dense":
        return _prefill_scan(params, cfg, tokens, cache, start, t0)
    B, S = tokens.shape
    positions = torch.arange(t0, S, dtype=torch.int32, device=tokens.device).expand(B, S - t0)
    if start is not None:
        positions = positions - start[:, None]
    x = L.embed(params["tok"], tokens[:, t0:])
    for i, p in enumerate(params["layers"]):
        a = L.rmsnorm(x, p["ln1"], cfg)
        x = x + L.prefill_suffix_attention(p, a, cache["k"][i], cache["v"][i], cfg,
                                           positions, start, t0)
        a = L.rmsnorm(x, p["ln2"], cfg)
        x = x + L.mlp_block(p, a)
    x = L.rmsnorm(x[:, -1:], params["ln_f"], cfg)
    return L.logits(params["head"], x), cache


def _prefill_scan(params: Params, cfg: ModelConfig, tokens, cache, start, t0: int,
                  last_idx=None):
    """Prefill as ``S - t0`` decode steps, one position each (all rows at
    position ``i``, pads masked by ``start``); the last step's logits, or
    given ``last_idx`` (B,), row b's logits from its own step
    ``last_idx[b]``."""
    B, S = tokens.shape
    if S <= t0:
        raise ValueError(f"nothing to prefill: t0={t0} >= {S} tokens")
    pos = torch.arange(t0, S, dtype=torch.int32, device=tokens.device)
    pos = pos[:, None].expand(S - t0, B).contiguous()
    last = None if last_idx is None else torch.as_tensor(last_idx, device=tokens.device)
    lg = None
    for i in range(t0, S):
        step, cache = decode_step(params, cfg, cache, tokens[:, i:i + 1], pos[i - t0], start)
        lg = step if lg is None or last is None else torch.where(
            (last == i)[:, None, None], step, lg)
    return lg, cache


def prefill_packed(params: Params, cfg: ModelConfig, tokens, cache, positions, seg_ids,
                   last_idx, seg_len: int):
    """Packed admission prefill: N prompts concatenated into one (1, N *
    seg_len) sequence.

    Segment i takes positions ``[i * seg_len, (i + 1) * seg_len)`` with its
    own relative RoPE ``positions`` and id ``i`` on its real tokens (pads
    -1; as queries they become -2 and attend nothing).  Attention is
    block-diagonal (K5), so each segment's rows, and its cache rows in the
    batch=1 ``cache`` (L, 1, N * seg_len, KV, hd), are those of a solo
    prefill of width ``seg_len``.  ``last_idx`` (N,) names each segment's
    last real position; returns ``((N, 1, V) logits, cache)``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"prefill_packed serves the dense family only, not "
                                  f"{cfg.family!r}: the moe family packs on the batch "
                                  "axis (prefill, prefill_batch_ragged)")
    seg_q = torch.where(seg_ids < 0, torch.full_like(seg_ids, -2), seg_ids)
    x = L.embed(params["tok"], tokens)
    for i, p in enumerate(params["layers"]):
        a = L.rmsnorm(x, p["ln1"], cfg)
        x = x + L.prefill_attention(p, a, cache["k"][i], cache["v"][i], cfg, positions,
                                    seg_q=seg_q, seg_kv=seg_ids, seg_len=seg_len)
        a = L.rmsnorm(x, p["ln2"], cfg)
        x = x + L.mlp_block(p, a)
    idx = torch.as_tensor(last_idx, dtype=torch.long, device=x.device)
    x = L.rmsnorm(x[:, idx], params["ln_f"], cfg)             # (1, N, D)
    return L.logits(params["head"], x).transpose(0, 1), cache


def prefill_batch_ragged(params: Params, cfg: ModelConfig, tokens, cache, start,
                         last_idx):
    """The scanned families' packed admission of N RIGHT-padded rows of one
    width W, all at start 0, in one scan (the moe family's into the paged
    pool).

    :func:`_prefill_scan` runs :func:`decode_step` over positions ``[0,
    W)``, and row i keeps the logits of its own last real step
    ``last_idx[i]`` (its prompt length less one), so its first token comes
    from the logits its solo prefill returns.  The pad steps of
    a short row only write cache rows past its prompt (in its last owned
    page at most, which decode overwrites and masks).  ``cache`` is a dense
    (L, N, W, KV, hd) mini cache (the hybrid family's :func:`init_cache`
    of N rows, whose state the pad steps then advance past the prompt:
    admission takes only the logits from it); returns ``((N, 1, V) logits,
    cache)``, as the reference's ``prefill_batch_ragged``."""
    return _prefill_scan(params, cfg, tokens, cache, start, 0, last_idx)


def decode_step(params: Params, cfg: ModelConfig, cache, token, pos,
                start=None, block_tables=None, with_health: bool = False):
    """One-token decode. ``token``: (B, 1) int; ``pos``: per-slot (B,) int32
    positions; ``start``: optional (B,) int32 start offsets.

    ``block_tables`` (B, max_blocks) int32 switches ``cache`` to the paged
    layout of :func:`init_paged_cache` (K4 reads the pages in place); the
    logits are those of the dense layout holding the same rows.

    The hybrid family's attention layers write ring row ``min(pos % W, W -
    1)`` and attend their ring in age order (:func:`layers.ring_decode_attention`),
    its recurrent layers advance their ``(conv, h)`` state, kept at its old
    value for slots whose prompt has not started (``pos < start``).

    Returns ``(logits, cache)``, plus the (B,) :func:`logits_health` probe
    when ``with_health``.
    """
    if block_tables is not None:
        _no_pages(cfg, "paged KV cache layout")
    x = L.embed(params["tok"], token)
    for i, p in enumerate(params["layers"]):
        a = L.rmsnorm(x, p["ln1"], cfg)
        if cfg.family == "hybrid":
            o = _hybrid_decode(p, a, cache["layers_list"][i], i, pos, start, cfg)
        elif block_tables is None:
            o = L.decode_attention(p, a, cache["k"][i], cache["v"][i], pos, cfg, start)
        else:
            o = L.decode_attention_paged(p, a, cache["k"][i], cache["v"][i], block_tables,
                                         pos, cfg, start)
        x = x + o
        a = L.rmsnorm(x, p["ln2"], cfg)
        x = x + _ffn(p, a, cfg)
    x = L.rmsnorm(x, params["ln_f"], cfg)
    lg = L.logits(params["head"], x)
    if with_health:
        return lg, cache, logits_health(cfg, lg)
    return lg, cache


def _gate_state(new, old, pos, start):
    """Recurrent state frozen for slots whose prompt has not started: a
    left-padded row keeps its init state until ``pos >= start``, so its
    decode is the same alone or batched with longer prompts."""
    if start is None:
        return new
    act = pos >= start
    return {k: torch.where(act.reshape((-1,) + (1,) * (n.dim() - 1)), n, old[k])
            for k, n in new.items()}


def _hybrid_decode(p, x, c, i: int, pos, start, cfg: ModelConfig):
    """Layer ``i``'s token mixer in a hybrid decode step: the ring buffer's
    attention, or the RG-LRU advancing the layer's state ``c`` in place."""
    if cfg.is_attn_layer(i):
        return L.ring_decode_attention(p, x, c["k"], c["v"], pos, cfg, start)
    o, (conv, h) = rglru_block(p["rec"], x, cfg, (c["conv"], c["h"]), decode=True)
    c.update(_gate_state({"conv": conv, "h": h}, c, pos, start))
    return o
