"""Flash attention with the posit SRT normalizer, dense layout: the forward
(K3, and K6 which also saves the row residuals) and the recompute backward
(K7 for dq, K8 for dk/dv), with the straight-through autograd wrapper.

Port of the dense branch of the reference package's
``kernels/posit_flash_attn.py`` ``posit_flash_attention``: online-softmax kv
scan carrying ``(m, l, acc)``, GQA by head index, causal / window masks and
the per-sequence ``kv_start`` / ``kv_len`` / ``q_pos`` masks, and the final
``acc / l`` as a rowwise posit divide through the SRT datapath, with the
format's minpos standing in for ``l`` on fully masked rows (they come out 0).

For CUDA tensors :func:`posit_flash_attention` launches
``csrc/posit_flash_attn.cu`` (or raises); for CPU tensors it runs the plain
twin :func:`posit_flash_attention_plain`.  Both scan kv tiles of
:data:`BLOCK_K` keys anchored at each sequence's ``kv_start``, so a row's
result does not depend on its left-pad length: serving stays bit-identical
solo, batched and mid-flight.  Both differ from the reference (whose tiles
start at key 0 and are ``min(128, round_up(Sk, 8))`` wide) only in where the
online-softmax rescaling happens and in summation order; the tests bound it.

The training path runs :func:`posit_flash_attention_ste`: its forward is
:func:`posit_flash_attention_fwd` (K6: the same kernel and tiles as K3, plus
each row's final ``m`` and ``l``) and its backward :func:`flash_backward`
(K7 and K8, ``csrc/posit_flash_bwd.cu``), which recompute ``p = exp(s - m) /
l`` through the SRT datapath from those residuals, as the reference's
``_flash_backward`` does.  Each has a plain twin for CPU tensors.

The paged and packed-prefill branches (K4, K5) are not ported yet
(``ROADMAP.md``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.posit import PositFormat
from . import _build
from .ops import PLAN_ARGTYPES, plan_args
from .posit_div import DEFAULT_KERNEL_VARIANT, divide_floats_block, one_word_plan

BLOCK_K = 64        # keys per kv tile (csrc/posit_flash_attn.cu kBK)
KERNEL_FORMAT_N = 16  # the kernel is built for the posit16 plans only
HEAD_DIM_MAX = 128  # csrc/posit_flash_attn.cu kHdMax
_NEG_INF = -1e30    # the reference's mask fill


def minpos_eps(fmt: PositFormat) -> float:
    """The format's minpos, clamped to the f32 normal range: the divisor a
    fully masked row (l == 0) uses, so it normalizes to 0, not NaR."""
    return float(2.0 ** -min(fmt.max_scale, 126))


def _per_seq(vec, B: int, default: int, device):
    if vec is None:
        return torch.full((B,), default, dtype=torch.int32, device=device)
    vec = torch.as_tensor(vec, device=device).to(torch.int32).reshape(-1)
    if vec.shape[0] == 1 and B != 1:
        vec = vec.expand(B)
    if vec.shape != (B,):
        raise ValueError(f"per-sequence input has shape {tuple(vec.shape)}; "
                         f"expected ({B},)")
    return vec.contiguous()


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, H, hd) and k/v (B, Sk, KV, hd) expected; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, KV, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    return B, Sq, H, hd, Sk, KV


def flash_scan_plain(q, k, v, causal: bool = True, window: int = 0,
                     q_offset: int = 0, scale: float = 0.0, kv_start=None,
                     kv_len=None, q_pos=None):
    """The kv scan of the plain twin: the final ``(acc, l, m)``, shaped
    (B, H, Sq, hd), (B, H, Sq) and (B, H, Sq), before the posit division."""
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    G = H // KV
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    dev = q.device
    ks_all = _per_seq(kv_start, B, 0, dev).tolist()
    kl_all = _per_seq(kv_len, B, Sk, dev).tolist()
    qp_all = _per_seq(q_pos, B, 0, dev).tolist()
    heads = torch.arange(H, device=dev) // G
    acc_all = torch.empty((B, H, Sq, hd), dtype=torch.float32, device=dev)
    l_all = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    m_all = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    for b in range(B):
        ks, kl = ks_all[b], min(kl_all[b], Sk)
        qp = qp_all[b] + q_offset + torch.arange(Sq, device=dev)
        qb = q[b].to(torch.float32).transpose(0, 1)            # (H, Sq, hd)
        kb = k[b].to(torch.float32)[:, heads].transpose(0, 1)  # (H, Sk, hd)
        vb = v[b].to(torch.float32)[:, heads].transpose(0, 1)
        m = torch.full((H, Sq), _NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((H, Sq), dtype=torch.float32, device=dev)
        acc = torch.zeros((H, Sq, hd), dtype=torch.float32, device=dev)
        kv_end = min(kl, qp_all[b] + q_offset + Sq) if causal else kl
        ntiles = -(-(kv_end - ks) // BLOCK_K) if kv_end > ks else 0
        for t in range(ntiles):
            kp = ks + t * BLOCK_K + torch.arange(BLOCK_K, device=dev)
            inr = (kp >= 0) & (kp < Sk)
            idx = kp.clamp(0, Sk - 1)
            kt = torch.where(inr[None, :, None], kb[:, idx], 0.0)
            vt = torch.where(inr[None, :, None], vb[:, idx], 0.0)
            s = torch.matmul(qb, kt.transpose(1, 2)) * scale    # (H, Sq, BK)
            mask = ((kp >= ks) & (kp < kl))[None, :].expand(Sq, BLOCK_K)
            if causal:
                mask = mask & (qp[:, None] >= kp[None, :])
            if window:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vt)
            m = m_new
        acc_all[b], l_all[b], m_all[b] = acc, l, m
    return acc_all, l_all, m_all


def posit_flash_attention_plain(fmt: PositFormat, q, k, v, causal: bool = True,
                                window: int = 0, q_offset: int = 0,
                                scale: float = 0.0,
                                variant: str = DEFAULT_KERNEL_VARIANT,
                                kv_start=None, kv_len=None, q_pos=None):
    """The plain PyTorch twin of K3 (any device): float32 (B, Sq, H, hd)."""
    acc, l, _ = flash_scan_plain(q, k, v, causal, window, q_offset, scale,
                                 kv_start, kv_len, q_pos)
    l_safe = torch.where(l > 0, l, minpos_eps(fmt))
    o = divide_floats_block(fmt, acc, l_safe[..., None], variant)
    return o.transpose(1, 2).contiguous()




def posit_flash_attention_fwd_plain(fmt: PositFormat, q, k, v, causal: bool = True,
                                    window: int = 0, q_offset: int = 0,
                                    scale: float = 0.0,
                                    variant: str = DEFAULT_KERNEL_VARIANT):
    """The plain PyTorch twin of K6 (any device): ``(o, m, l)``, with ``o``
    as :func:`posit_flash_attention_plain` gives it and ``m``, ``l`` float32
    (B*H, Sq)."""
    B, Sq, H = q.shape[:3]
    acc, l, m = flash_scan_plain(q, k, v, causal, window, q_offset, scale)
    l_safe = torch.where(l > 0, l, minpos_eps(fmt))
    o = divide_floats_block(fmt, acc, l_safe[..., None], variant)
    return (o.transpose(1, 2).contiguous(), m.reshape(B * H, Sq),
            l.reshape(B * H, Sq))


# ------------------------------------------------------------------ K3 / K6


@functools.lru_cache(maxsize=None)
def _flash_fn():
    fn = _build.load("posit_flash_attn").posit_flash_attn_fwd
    fn.argtypes = (PLAN_ARGTYPES + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(plan, q, k, v, hd: int) -> None:
    """What the hand-written kernels take; raises for anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if hd > HEAD_DIM_MAX:
        raise ValueError(f"head_dim {hd} > {HEAD_DIM_MAX}")
    if plan.n != KERNEL_FORMAT_N:
        raise NotImplementedError(
            f"the flash kernels are built for posit16 plans only, not posit{plan.n} "
            "(ROADMAP.md)")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the flash kernels read bfloat16 k/v only, not {k.dtype}/{v.dtype} "
            "(ROADMAP.md)")


def _launch_forward(fmt: PositFormat, plan, q, k, v, causal, window, q_offset, scale,
                    kv_start, kv_len, q_pos, residuals: bool):
    """One launch of ``csrc/posit_flash_attn.cu``: ``out``, plus ``(m, l)``
    as (B*H, Sq) when ``residuals`` (K6), else None for both (K3)."""
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    _check_kernel_inputs(plan, q, k, v, hd)
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32).contiguous()
    kc, vc = k.contiguous(), v.contiguous()
    ks = _per_seq(kv_start, B, 0, dev)
    kl = _per_seq(kv_len, B, Sk, dev)
    qp = _per_seq(q_pos, B, 0, dev)
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
    m = l = None
    if residuals:
        m = torch.empty((B * H, Sq), dtype=torch.float32, device=dev)
        l = torch.empty((B * H, Sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _flash_fn()(*plan_args(plan), qf.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                         out.data_ptr(), m.data_ptr() if residuals else None,
                         l.data_ptr() if residuals else None, ks.data_ptr(),
                         kl.data_ptr(), qp.data_ptr(), B, Sq, Sk, H, KV, hd,
                         float(scale), int(bool(causal)), int(window), int(q_offset),
                         minpos_eps(fmt), stream)
    if rc != 0:
        raise RuntimeError(f"posit_flash_attn_fwd launch failed ({rc})")
    return out, m, l


def posit_flash_attention(fmt: PositFormat, q, k, v, causal: bool = True,
                          window: int = 0, q_offset: int = 0, scale: float = 0.0,
                          variant: str = DEFAULT_KERNEL_VARIANT,
                          kv_start=None, kv_len=None, q_pos=None):
    """Flash attention with the posit SRT normalizer, one kernel launch (K3).

    ``q``: (B, Sq, H, hd); ``k``/``v``: (B, Sk, KV, hd) with H % KV == 0.
    Returns float32 (B, Sq, H, hd).  ``scale <= 0`` means 1/sqrt(hd).
    ``kv_start``/``kv_len``/``q_pos`` are optional (B,) int32 vectors: keys
    outside ``[kv_start[b], kv_len[b])`` are masked and ``q_pos[b]`` offsets
    the sequence's query positions (on top of ``q_offset``).

    CUDA tensors launch the hand-written kernel (counted in
    ``posit_flash_attention.launches``); it takes posit16 plans and bf16
    k/v (upcast in registers, exactly), and raises for anything else.  CPU
    tensors run the plain twin, for every one-word plan and k/v dtype.
    """
    plan = one_word_plan(fmt, variant)
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return posit_flash_attention_plain(fmt, q, k, v, causal, window,
                                           q_offset, scale, variant,
                                           kv_start, kv_len, q_pos)
    out, _, _ = _launch_forward(fmt, plan, q, k, v, causal, window, q_offset, scale,
                                kv_start, kv_len, q_pos, residuals=False)
    posit_flash_attention.launches += 1
    return out


posit_flash_attention.launches = 0


def posit_flash_attention_fwd(fmt: PositFormat, q, k, v, causal: bool = True,
                              window: int = 0, q_offset: int = 0, scale: float = 0.0,
                              variant: str = DEFAULT_KERNEL_VARIANT):
    """The training forward (K6): ``(o, m, l)``, the attention output as
    :func:`posit_flash_attention` gives it plus each row's final online-
    softmax max and sum, float32 (B*H, Sq) with no padding (the reference
    returns (B*H, Sq_padded)).  ``m + log(l)`` is the row logsumexp of the
    masked scores; a fully masked row has ``l == 0``.

    CUDA tensors launch the K3 kernel with its residual outputs (counted in
    ``posit_flash_attention_fwd.launches``), CPU tensors run the plain twin.
    """
    plan = one_word_plan(fmt, variant)
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return posit_flash_attention_fwd_plain(fmt, q, k, v, causal, window, q_offset,
                                               scale, variant)
    out, m, l = _launch_forward(fmt, plan, q, k, v, causal, window, q_offset, scale,
                                None, None, None, residuals=True)
    posit_flash_attention_fwd.launches += 1
    return out, m, l


posit_flash_attention_fwd.launches = 0


# ------------------------------------------------------------------ K7 / K8


def _row_sums(g, o):
    """``D = rowsum(dO * o)`` as float32 (B*H, Sq): a plain reduce outside
    the kernels, as the reference computes it outside its pallas_calls."""
    B, Sq, H = o.shape[:3]
    D = (g.to(torch.float32) * o.to(torch.float32)).sum(-1)
    return D.transpose(1, 2).reshape(B * H, Sq).contiguous()


def flash_backward_plain(fmt: PositFormat, q, k, v, o, g, m, l, causal: bool = True,
                         window: int = 0, q_offset: int = 0, scale: float = 0.0,
                         variant: str = DEFAULT_KERNEL_VARIANT):
    """The plain PyTorch twin of K7 and K8 (any device): ``(dq, dk, dv)`` in
    the dtypes of q, k and v.

    It scans the keys in the kernels' :data:`BLOCK_K`-key tiles and
    recomputes each tile's ``p = exp(s - m) / l_safe`` through the K1 twin
    (``l_safe`` is minpos where ``l == 0``), ``ds = p * (dp - D)``; products
    are float32 ``torch.matmul``.
    """
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    G = H // KV
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    dev = q.device
    f32 = torch.float32
    qf = q.to(f32).transpose(1, 2)                          # (B, H, Sq, hd)
    gf = g.to(f32).transpose(1, 2)
    kf = k.to(f32).transpose(1, 2)                          # (B, KV, Sk, hd)
    vf = v.to(f32).transpose(1, 2)
    mrow = m.reshape(B, H, Sq, 1)
    lrow = l.reshape(B, H, Sq, 1)
    l_safe = torch.where(lrow > 0, lrow, minpos_eps(fmt))
    D = _row_sums(g, o).reshape(B, H, Sq, 1)
    heads = torch.arange(H, device=dev) // G
    qp = q_offset + torch.arange(Sq, device=dev)
    dq = torch.zeros((B, H, Sq, hd), dtype=f32, device=dev)
    dk = torch.zeros((B, KV, Sk, hd), dtype=f32, device=dev)
    dv = torch.zeros((B, KV, Sk, hd), dtype=f32, device=dev)
    for k0 in range(0, Sk, BLOCK_K):
        k1 = min(k0 + BLOCK_K, Sk)
        kp = torch.arange(k0, k1, device=dev)
        kt = kf[:, heads, k0:k1]                            # (B, H, bk, hd)
        vt = vf[:, heads, k0:k1]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale  # (B, H, Sq, bk)
        mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (qp[:, None] >= kp[None, :])
        if window:
            mask = mask & (qp[:, None] - kp[None, :] < window)
        e = torch.where(mask, torch.exp(s - mrow), 0.0)
        p = divide_floats_block(fmt, e, l_safe, variant)
        dp = torch.matmul(gf, vt.transpose(-1, -2))
        ds = p * (dp - D)
        dq += torch.matmul(ds, kt)
        dv_t = torch.matmul(p.transpose(-1, -2), gf)       # (B, H, bk, hd)
        dk_t = torch.matmul(ds.transpose(-1, -2), qf)
        dv[:, :, k0:k1] = dv_t.reshape(B, KV, G, k1 - k0, hd).sum(2)
        dk[:, :, k0:k1] = dk_t.reshape(B, KV, G, k1 - k0, hd).sum(2)
    return ((dq * scale).transpose(1, 2).to(q.dtype),
            (dk * scale).transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    lib = _build.load("posit_flash_bwd")
    fns = []
    for name, n_out in (("posit_flash_bwd_dq", 1), ("posit_flash_bwd_dkv", 2)):
        fn = getattr(lib, name)
        fn.argtypes = (PLAN_ARGTYPES + [ctypes.c_void_p] * (7 + n_out)
                       + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def _launch_backward(which: int, fmt, plan, q, k, v, g, m, l, D, outs, causal, window,
                     q_offset, scale):
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    fn = _bwd_fns()[which]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(*plan_args(plan), q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                m.data_ptr(), l.data_ptr(), D.data_ptr(), *(t.data_ptr() for t in outs),
                B, Sq, Sk, H, KV, hd, float(scale), int(bool(causal)), int(window),
                int(q_offset), minpos_eps(fmt), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed ({rc})")


def flash_backward_dq(fmt: PositFormat, plan, q, k, v, g, m, l, D, causal, window,
                      q_offset, scale):
    """One launch of K7: float32 dq (B, Sq, H, hd), counted in
    ``flash_backward_dq.launches``.  Inputs as :func:`flash_backward`
    prepares them (contiguous, q and g float32, k and v bfloat16)."""
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_backward(0, fmt, plan, q, k, v, g, m, l, D, (dq,), causal, window, q_offset,
                     scale)
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward_dkv(fmt: PositFormat, plan, q, k, v, g, m, l, D, causal, window,
                       q_offset, scale):
    """One launch of K8: float32 (dk, dv), each (B, Sk, KV, hd), counted in
    ``flash_backward_dkv.launches``."""
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    _launch_backward(1, fmt, plan, q, k, v, g, m, l, D, (dk, dv), causal, window,
                     q_offset, scale)
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def flash_backward(fmt: PositFormat, q, k, v, o, g, m, l, causal: bool = True,
                   window: int = 0, q_offset: int = 0, scale: float = 0.0,
                   variant: str = DEFAULT_KERNEL_VARIANT):
    """The recompute backward of :func:`posit_flash_attention_fwd`:
    ``(dq, dk, dv)`` in the dtypes of q, k and v, from the forward's output
    ``o``, its cotangent ``g`` and the row residuals ``m``, ``l`` (B*H, Sq).

    CUDA tensors launch K7 (dq) and K8 (dk, dv); CPU tensors run the plain
    twin :func:`flash_backward_plain`.
    """
    plan = one_word_plan(fmt, variant)
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    if m.shape != (B * H, Sq) or l.shape != (B * H, Sq):
        raise ValueError(f"m and l must be ({B * H}, {Sq}); got {tuple(m.shape)} "
                         f"and {tuple(l.shape)}")
    if q.device.type == "cpu":
        return flash_backward_plain(fmt, q, k, v, o, g, m, l, causal, window, q_offset,
                                    scale, variant)
    _check_kernel_inputs(plan, q, k, v, hd)
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qf, gf = q.to(f32).contiguous(), g.to(f32).contiguous()
    kc, vc = k.contiguous(), v.contiguous()
    mc, lc = m.to(f32).contiguous(), l.to(f32).contiguous()
    D = _row_sums(g, o)
    args = (qf, kc, vc, gf, mc, lc, D, causal, window, q_offset, scale)
    dq = flash_backward_dq(fmt, plan, *args)
    dk, dv = flash_backward_dkv(fmt, plan, *args)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ autograd


class _FlashSTE(torch.autograd.Function):
    """Posit flash forward (K6), recompute backward (K7/K8): the reference's
    ``_flash_ste`` custom_vjp with its fused backward."""

    @staticmethod
    def forward(ctx, q, k, v, fmt, variant, causal, window, q_offset, scale):
        ctx.cfg = (fmt, variant, causal, window, q_offset, scale)
        out, m, l = posit_flash_attention_fwd(fmt, q, k, v, causal, window, q_offset,
                                              scale, variant)
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    def backward(ctx, g):
        fmt, variant, causal, window, q_offset, scale = ctx.cfg
        q, k, v, o, m, l = ctx.saved_tensors
        grads = flash_backward(fmt, q, k, v, o, g, m, l, causal, window, q_offset, scale,
                               variant)
        return (*grads, None, None, None, None, None, None)


def posit_flash_attention_ste(fmt_n: int, variant: str, causal: bool, window: int,
                              q_offset: int, scale: float, q, k, v):
    """Differentiable posit flash attention: float32 (B, Sq, H, hd).  The
    forward runs K6 and saves ``(q, k, v, o, m, l)``; the backward runs the
    K7/K8 recompute backward (:func:`flash_backward`)."""
    return _FlashSTE.apply(q, k, v, PositFormat(fmt_n), variant, causal, window, q_offset,
                           scale)
