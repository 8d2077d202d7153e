"""Mamba2 / SSD block (state-space duality, arXiv:2405.21060).

Port of the reference package's ``models/mamba2.py``.  The whole-sequence
form (:func:`mamba2_block`) runs the chunked SSD algorithm: within a chunk
of Q positions an attention-like quadratic product masked by the decays,
between chunks a linear scan of the (H, N, P) state, so O(S Q) work where
attention is O(S^2).  The decode form advances a per-slot state ``(conv,
h)`` one token, a constant size at any context.  The block has one
division, its gated RMSNorm over ``d_inner`` (K2, as every RMSNorm); the
rest is torch ops, as the reference computes it outside any Pallas kernel.

Every op keeps the reference's dtype and order: bf16 products rounded to
bf16 (each of a three-operand einsum's two pairwise products in the order
XLA contracts them), the decays, ``dt`` and the state in f32, the causal
conv summed tap by tap in bf16 and ``silu`` as ``x * (1 / (1 + exp(-x)))``
with each op rounded to bf16, as XLA evaluates ``jax.nn.silu`` on bf16.  The
chunk's cumulative sum runs in ``jax.lax.associative_scan``'s order
(:func:`_scan_add`).  So the port and the reference differ only where the
two libraries' ``exp`` or their products' summation orders round apart
(``tests/test_torch_ssm.py`` states the bounds).

The reference's ``constrain`` (a sharding hint) is dropped: the port has
no sharding.
"""

from __future__ import annotations

import math

import torch

from . import layers as L
from .config import ModelConfig
from .rglru import _conv1d as _conv_taps


def init_mamba2_block(cfg: ModelConfig, generator: torch.Generator, device,
                      dtype=torch.bfloat16) -> dict:
    """Random block parameters with the reference's init scales, drawn from
    ``generator`` (on its own device) and stored on ``device``: ``in_proj``
    (D, 2 d_inner + 2 G N + H), ``conv_w`` (K, d_inner + 2 G N) and
    ``out_proj`` (d_inner, D) in ``dtype``; ``conv_b``, ``A_log`` (log 1..H),
    ``dt_bias``, ``D`` and ``norm_w`` in f32."""
    d, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * G * N
    gdev = generator.device

    def mat(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
        t = torch.randn(shape, generator=generator, device=gdev) * scale
        return t.to(device=device, dtype=dtype)

    f32 = lambda t: t.to(device=device, dtype=torch.float32)
    return {
        "in_proj": mat((d, 2 * di + 2 * G * N + H)),
        "conv_w": mat((cfg.conv_width, conv_dim), scale=1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": f32(torch.zeros(conv_dim)),
        "A_log": f32(torch.log(torch.arange(1, H + 1, dtype=torch.float32))),
        "dt_bias": f32(torch.zeros(H)),
        "D": f32(torch.ones(H)),
        "norm_w": f32(torch.zeros(di)),
        "out_proj": mat((di, d)),
    }


def init_mamba2_state(cfg: ModelConfig, batch: int, device, dtype=torch.bfloat16):
    """Decode state of ``batch`` slots: the conv window (B, conv_width - 1,
    d_inner + 2 G N) in ``dtype`` and the SSM state (B, H, N, P) in f32.
    Every row is independent and position-free: the engine freezes a row
    until its left-padded prompt starts and replaces one row at admission
    while the other slots go on."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype, device=device)
    h = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                    dtype=torch.float32, device=device)
    return conv, h


def _split_proj(cfg: ModelConfig, zxbcdt):
    """``in_proj``'s output as the gate ``z``, the conv's input ``xBC`` (x,
    B, C) and the step sizes' logits ``dt``."""
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * G * N], zxbcdt[..., 2 * di + 2 * G * N:]


def _silu(x):
    """``jax.nn.silu`` as XLA evaluates it on bf16: ``x * (1 / (1 +
    exp(-x)))``, each op rounded to x's dtype (``F.silu`` rounds once, so
    many bf16 outputs get other bits)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _conv1d(x, w, b, state=None):
    """Causal depthwise conv then silu, in x's dtype; ``state`` (B, K - 1,
    C) is the decode window.  Returns ``(out, new_state)``."""
    out, new_state = _conv_taps(x, w, b, state)
    return _silu(out), new_state


def _scan_add(x):
    """Inclusive sum along axis 0 in ``jax.lax.associative_scan``'s order:
    adjacent pairs added, the halves scanned recursively, the even
    positions filled in from the odd prefixes."""
    n = x.shape[0]
    if n < 2:
        return x
    odd = _scan_add(x[0:-1:2] + x[1::2])
    even = torch.cat([x[:1], (odd[:-1] if n % 2 == 0 else odd) + x[2::2]])
    out = torch.empty_like(x)
    out[0::2] = even
    out[1::2] = odd
    return out


def _ssd_chunked(xh, Bm, Cm, dA, dt, cfg: ModelConfig):
    """The whole-sequence SSD.  xh (B, S, H, P), Bm / Cm (B, S, G, N), dA =
    dt A and dt (B, S, H).  Returns ``(y (B, S, H, P), final state (B, H,
    N, P) f32)``.  The chunk is the largest divisor of S at most
    ``cfg.ssm_chunk``.  The intra-chunk tensors are laid out (B, NC, H, Qi,
    Qj) so their products are batched matmuls; the values are the
    reference's (B, NC, Qi, Qj, H) ones."""
    Bsz, S, H, P = xh.shape
    G, N = cfg.ssm_groups, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    while S % Q:  # largest divisor <= the configured chunk (ragged lengths)
        Q -= 1
    NC = S // Q
    xdt = xh.dtype
    hpg = H // G
    # (B, NC, H, Q, .): heads before positions
    heads_first = lambda t, tail: t.reshape((Bsz, NC, Q) + tail).transpose(2, 3)
    x4 = heads_first(xh, (H, P))
    Bh = heads_first(Bm.repeat_interleave(hpg, dim=2), (H, N))
    Ch = heads_first(Cm.repeat_interleave(hpg, dim=2), (H, N))
    dtc = dt.reshape(Bsz, NC, Q, H).transpose(2, 3)                 # (B, NC, H, Q)
    cum = _scan_add(dA.reshape(Bsz, NC, Q, H).movedim(2, 0)).movedim(0, 3)  # (B, NC, H, Q)

    # intra-chunk: y_i = sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    # mask BEFORE exp, as the reference (its where(mask, exp(x), 0) had NaN
    # gradients at exp(inf))
    Lm = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], -1e30))
    CB = torch.matmul(Ch, Bh.transpose(-1, -2))                     # bf16 (.., Qi, Qj)
    W = (CB * Lm * dtc[..., None, :]).to(xdt)
    del Lm, CB
    y = torch.matmul(W, x4)                                         # (B, NC, H, Q, P)
    del W

    # chunk states: st = sum_j exp(cum_Q - cum_j) dt_j B_j (x) x_j, the
    # weights times B first (rounded to bf16), then the sum over j
    decay_out = torch.exp(cum[..., -1:] - cum)
    wB = (decay_out * dtc).to(xdt)[..., None] * Bh                  # (B, NC, H, Q, N)
    st = torch.matmul(wB.transpose(-1, -2), x4)                     # (B, NC, H, N, P)

    # inter-chunk scan over NC, emitting each chunk's PREVIOUS state
    chunk_decay = torch.exp(cum[..., -1])                           # (B, NC, H)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(NC):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + st[:, c].to(torch.float32)
    h_prev = torch.stack(prev, dim=1).to(xdt)                       # (B, NC, H, N, P)

    # y_inter = C_i . h_prev exp(cum_i): XLA contracts the einsum's cheaper
    # pair first, the scale into C where N < P (the smoke config), the
    # product with the state where N > P (Mamba2-2.7B)
    e = torch.exp(cum).to(xdt)[..., None]                           # (B, NC, H, Q, 1)
    if N < P:
        y_inter = torch.matmul(Ch * e, h_prev)
    else:
        y_inter = torch.matmul(Ch, h_prev) * e
    y = (y + y_inter).transpose(2, 3).reshape(Bsz, S, H, P)
    return y, h


def mamba2_block(p, x, cfg: ModelConfig, state=None, decode: bool = False):
    """x: (B, S, D) -> (B, S, D).  With ``decode`` (S = 1), ``state`` is
    ``(conv, h)`` and the result ``(out, (new_conv, new_h))``; the new h is
    f32, as the reference keeps it."""
    dt_ = x.dtype
    Bsz, S, _ = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    di = cfg.d_inner

    zxbcdt = torch.matmul(x, p["in_proj"].to(dt_))
    z, xBC, dtr = _split_proj(cfg, zxbcdt)
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus switches to x
    # past a threshold)
    dtr = dtr.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(dtr, torch.zeros_like(dtr))                # (B, S, H)
    A = -torch.exp(p["A_log"])
    dA = dt * A

    conv_w, conv_b = p["conv_w"].to(dt_), p["conv_b"].to(dt_)
    if decode:
        conv_state, h = state
        xBC, new_conv = _conv1d(xBC, conv_w, conv_b, conv_state)
    else:
        xBC, _ = _conv1d(xBC, conv_w, conv_b)

    xin = xBC[..., :di].reshape(Bsz, S, H, P)
    Bm = xBC[..., di:di + G * N].reshape(Bsz, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(Bsz, S, G, N)

    if decode:
        hpg = H // G
        Bh = Bm[:, 0].repeat_interleave(hpg, dim=1).to(torch.float32)  # (B, H, N)
        Ch = Cm[:, 0].repeat_interleave(hpg, dim=1).to(torch.float32)
        decay = torch.exp(dA[:, 0])                                     # (B, H)
        upd = (dt[:, 0, :, None] * Bh)[..., None] * xin[:, 0, :, None, :].to(torch.float32)
        h_new = h * decay[..., None, None] + upd
        y = torch.matmul(Ch[:, :, None, :], h_new)[:, None, :, 0].to(dt_)   # (B, 1, H, P)
        new_state = (new_conv, h_new)
    else:
        y, _ = _ssd_chunked(xin, Bm, Cm, dA, dt, cfg)
        new_state = None

    y = y + p["D"].to(dt_)[None, None, :, None] * xin
    y = y.reshape(Bsz, S, di)
    y = L.rmsnorm(y * _silu(z), p["norm_w"], cfg)
    out = torch.matmul(y, p["out_proj"].to(dt_))
    return (out, new_state) if decode else out
