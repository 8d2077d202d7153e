"""Flash attention with the posit SRT normalizer (K3), dense layout.

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

The paged, packed-prefill and residual-saving branches (K4-K6) and the
backward kernels are not ported yet (``ROADMAP.md``).
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
    """The kv scan of the plain twin: the final ``(acc, l)``, shaped
    (B, H, Sq, hd) and (B, H, Sq), before the posit division."""
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
        acc_all[b], l_all[b] = acc, l
    return acc_all, l_all


def posit_flash_attention_plain(fmt: PositFormat, q, k, v, causal: bool = True,
                                window: int = 0, q_offset: int = 0,
                                scale: float = 0.0,
                                variant: str = DEFAULT_KERNEL_VARIANT,
                                kv_start=None, kv_len=None, q_pos=None):
    """The plain PyTorch twin of K3 (any device): float32 (B, Sq, H, hd)."""
    acc, l = flash_scan_plain(q, k, v, causal, window, q_offset, scale,
                              kv_start, kv_len, q_pos)
    l_safe = torch.where(l > 0, l, minpos_eps(fmt))
    o = divide_floats_block(fmt, acc, l_safe[..., None], variant)
    return o.transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _flash_fn():
    fn = _build.load("posit_flash_attn").posit_flash_attn_fwd
    fn.argtypes = (PLAN_ARGTYPES + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def posit_flash_attention(fmt: PositFormat, q, k, v, causal: bool = True,
                          window: int = 0, q_offset: int = 0, scale: float = 0.0,
                          variant: str = DEFAULT_KERNEL_VARIANT,
                          kv_start=None, kv_len=None, q_pos=None):
    """Flash attention with the posit SRT normalizer, one kernel launch.

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
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return posit_flash_attention_plain(fmt, q, k, v, causal, window,
                                           q_offset, scale, variant,
                                           kv_start, kv_len, q_pos)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if hd > HEAD_DIM_MAX:
        raise ValueError(f"head_dim {hd} > {HEAD_DIM_MAX}")
    if plan.n != KERNEL_FORMAT_N:
        raise NotImplementedError(
            f"the flash kernel is built for posit16 plans only, not {fmt} "
            "(ROADMAP.md)")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the flash kernel reads bfloat16 k/v only, not {k.dtype}/{v.dtype} "
            "(ROADMAP.md)")
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32).contiguous()
    kc, vc = k.contiguous(), v.contiguous()
    ks = _per_seq(kv_start, B, 0, dev)
    kl = _per_seq(kv_len, B, Sk, dev)
    qp = _per_seq(q_pos, B, 0, dev)
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _flash_fn()(*plan_args(plan), qf.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                         out.data_ptr(), ks.data_ptr(), kl.data_ptr(),
                         qp.data_ptr(), B, Sq, Sk, H, KV, hd, float(scale),
                         int(bool(causal)), int(window), int(q_offset),
                         minpos_eps(fmt), stream)
    if rc != 0:
        raise RuntimeError(f"posit_flash_attn_fwd launch failed ({rc})")
    posit_flash_attention.launches += 1
    return out


posit_flash_attention.launches = 0
