"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of the reference package's ``models/rglru.py``: a real-gated linear
recurrent unit behind a short causal conv1d, used in a 2:1 pattern with
local sliding-window attention.  The whole-sequence form (``forward``)
scans the recurrence ``h_t = a_t * h_{t-1} + b_t`` in log depth; the decode
form advances a per-slot state ``(conv, h)`` one token.  It has no division,
so no posit kernel: its products are bf16 ``torch.matmul``s, the gates and
the recurrence f32, as the reference computes them.

The scan combines adjacent pairs recursively in the order of
``jax.lax.associative_scan`` (:func:`_scan`), so each ``h_t`` is the same
products and sums as the reference's; the two may still round them apart
(XLA may contract ``a * b + c`` into one FMA), so the tests hold the block's
output within 2 bf16 ulps of the reference's and the model's logits within
8 (``tests/test_torch_hybrid.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from .config import ModelConfig

_C = 8.0  # the RG-LRU constant


def init_rglru_block(cfg: ModelConfig, generator: torch.Generator, device,
                     dtype=torch.bfloat16) -> dict:
    """Random block parameters with the reference's init scales, drawn from
    ``generator`` (on its own device) and stored on ``device``: matrices in
    ``dtype``, ``conv_b`` and ``lam`` (uniform in [2, 4)) in f32."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    gdev = generator.device

    def mat(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(max(shape[0], 1))
        t = torch.randn(shape, generator=generator, device=gdev) * scale
        return t.to(device=device, dtype=dtype)

    lam = 2.0 + 2.0 * torch.rand((w,), generator=generator, device=gdev)
    return {
        "in_x": mat((d, w)),
        "in_gate": mat((d, w)),
        "conv_w": mat((cfg.conv_width, w), scale=1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": torch.zeros(w, dtype=torch.float32, device=device),
        "wa": mat((w, w)),
        "wx": mat((w, w)),
        "lam": lam.to(device=device, dtype=torch.float32),
        "out": mat((w, d)),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, device, dtype=torch.bfloat16):
    """Decode state of ``batch`` slots: the conv window (B, conv_width - 1,
    W) in ``dtype`` and the LRU hidden state (B, W) in f32."""
    w = cfg.lru_width or cfg.d_model
    conv = torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device)
    h = torch.zeros((batch, w), dtype=torch.float32, device=device)
    return conv, h


def _conv1d(x, w, b, state=None):
    """Causal depthwise conv: x (B, S, W), taps w (K, W), bias b (W,), all in
    x's dtype; ``state`` (B, K - 1, W) is the decode window.  The taps are
    summed in the reference's order, ``((x_0 w_0 + x_1 w_1) + ...) + b``,
    each product and sum rounded to x's dtype.  Returns ``(out,
    new_state)`` (new_state None without ``state``)."""
    K = w.shape[0]
    S = x.shape[1]
    if state is not None:
        xp = torch.cat([state, x], dim=1)
        new_state = xp[:, -(K - 1):] if K > 1 else state
    else:
        xp = Fn.pad(x, (0, 0, K - 1, 0))
        new_state = None
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return (out + b).to(x.dtype), new_state


def _rglru_coeffs(p, xc, dt):
    """``(a, b)`` f32 of the recurrence ``h = a h + b`` from the conv output
    ``xc`` (B, S, W): the recurrence and input gates ``r``, ``i`` from bf16
    products, ``log a = -C softplus(lam) r`` and ``b = sqrt(1 - a^2) i xc``."""
    r = torch.sigmoid(torch.matmul(xc, p["wa"].to(dt)).to(torch.float32))
    i = torch.sigmoid(torch.matmul(xc, p["wx"].to(dt)).to(torch.float32))
    lam = p["lam"].to(torch.float32)
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus switches to x
    # past a threshold)
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    gated = i * xc.to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated
    return a, b


def _combine(a1, b1, a2, b2):
    """The scan's operator on (earlier, later): ``(a1 a2, a2 b1 + b2)``."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """``even`` at positions 0, 2, ... and ``odd`` at 1, 3, ... of axis 1."""
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1]) + tuple(even.shape[2:]),
                      dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a, b):
    """Inclusive scan of ``(a, b)`` along axis 1 under :func:`_combine`, in
    ``jax.lax.associative_scan``'s order: adjacent pairs combined, the
    halves scanned recursively, the even positions filled in from the odd
    prefixes (depth 2 log2 S)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation, in its op order
    with each op rounded to x's dtype (``F.gelu(approximate="tanh")``
    computes in f32 and rounds once: 40% of bf16 outputs differ, where this
    form differs in 0.25%, by tanh's last bit)."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def rglru_block(p, x, cfg: ModelConfig, state=None, decode: bool = False):
    """x: (B, S, D) -> (B, S, D).  With ``decode`` (S = 1), ``state`` is
    ``(conv, h)`` and the result ``(out, (new_conv, new_h))``; the new h is
    f32, as the reference keeps it."""
    dt = x.dtype
    gate = _gelu_tanh(torch.matmul(x, p["in_gate"].to(dt)))
    xin = torch.matmul(x, p["in_x"].to(dt))
    conv_w, conv_b = p["conv_w"].to(dt), p["conv_b"].to(dt)
    if decode:
        conv_state, h = state
        xc, new_conv = _conv1d(xin, conv_w, conv_b, conv_state)
        a, b = _rglru_coeffs(p, xc, dt)
        h_new = a[:, 0] * h + b[:, 0]
        y = h_new[:, None].to(dt)
        new_state = (new_conv, h_new)
    else:
        xc, _ = _conv1d(xin, conv_w, conv_b)
        a, b = _rglru_coeffs(p, xc, dt)
        _, h = _scan(a, b)
        y = h.to(dt)
        new_state = None
    out = torch.matmul(y * gate, p["out"].to(dt))
    return (out, new_state) if decode else out
