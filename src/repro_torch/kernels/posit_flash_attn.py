"""Flash attention with the posit SRT normalizer: the forward over a dense
cache (K3, and K6 which also saves the row residuals), over a paged block
pool (K4) and over a packed multi-prompt sequence (K5), and the recompute
backward (K7 for dq, K8 for dk/dv), with the straight-through autograd
wrapper.

Port of the reference package's ``kernels/posit_flash_attn.py``
``posit_flash_attention``: online-softmax kv
scan carrying ``(m, l, acc)``, GQA by head index, causal / window masks and
the per-sequence ``kv_start`` / ``kv_len`` / ``q_pos`` masks, and the final
``acc / l`` as a rowwise posit divide through the SRT datapath, with the
format's minpos standing in for ``l`` on fully masked rows (they come out 0).

For CUDA tensors :func:`posit_flash_attention` launches
``csrc/posit_flash_attn.cu`` (or raises); for CPU tensors it runs the plain
twin :func:`posit_flash_attention_plain`.  Both scan kv tiles of
:data:`BLOCK_K` keys anchored at each sequence's ``kv_start``, so a row's
result does not depend on its left-pad length: serving stays bit-identical
solo, batched and mid-flight.  The kernel source has two loops, and
:func:`flash_loop` picks one by the kind of call: the decode loop (one
query row a block, its kv tiles spread over the block's warps) for the
decode calls (K3 with ``q_pos``, K4), the tile loop (16-row tiles) for
every other call (K3 prefill and suffix prefill, K5, K6), whatever its
``Sq``.  The two share their arithmetic, so a row has the same bits in every
launch that carries it.  Both differ from the reference (whose tiles
start at key 0 and are ``min(128, round_up(Sk, 8))`` wide) only in where the
online-softmax rescaling happens and in summation order; the tests bound it.

The training path runs :func:`posit_flash_attention_ste`: its forward is
:func:`posit_flash_attention_fwd` (K6: the same kernel and tiles as K3, plus
each row's final ``m`` and ``l``) and its backward :func:`flash_backward`
(K7 and K8, ``csrc/posit_flash_bwd.cu``), which recompute ``p = exp(s - m) /
l`` through the SRT datapath from those residuals, as the reference's
``_flash_backward`` does.  Each has a plain twin for CPU tensors.

``block_tables`` switches the kv side to the paged layout (K4): k/v are
block pools (num_blocks, block_size, KV, hd) and logical row ``r`` of
sequence ``b`` is pool row ``(block_tables[b, r // block_size], r %
block_size)``.  The kernel reads each key in place through the table and
otherwise runs K3's tiles and sums, so it gives K3's bits on the gathered
dense cache; the twin gathers (:func:`gather_pages`) and runs K3's twin.

``seg_q``/``seg_kv`` (per-position segment ids, query pads -2, key pads -1)
switch on the packed layout (K5): a query attends only keys of its own
segment, and each segment's kv tiles are anchored at its first key, so a
segment's rows are the bits of a solo prefill of that prompt whatever
packs beside it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.posit import PositFormat
from . import _build
from .ops import PLAN_ARGTYPES, plan_args
from .posit_div import DEFAULT_KERNEL_VARIANT, datapath_plan, divide_floats_block

BLOCK_K = 64        # keys per kv tile (csrc/posit_flash_attn.cu kBK)
# the largest head_dim of the decode loop (K3 decode, K4), the packed layout
# (K5) and the backward (K7, K8): csrc/flash_stage.cuh kHdMax; and of the
# tile loop in the dense layout (K3 prefill, K6): kTileHdMax
HEAD_DIM_MAX = 128
TILE_HEAD_DIM_MAX = 256
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


def _check_paged(q, k, v, block_tables):
    """Shapes of the paged layout: q (B, Sq, H, hd), pools (NB, bs, KV, hd)
    and an int (B, max_blocks) table."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, H, hd) and block pools (NB, bs, KV, hd) expected; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    KV = k.shape[2]
    if (block_tables.dim() != 2 or block_tables.shape[0] != B or k.shape[3] != hd
            or KV == 0 or H % KV or block_tables.dtype.is_floating_point):
        raise ValueError(f"incompatible q {tuple(q.shape)}, pools {tuple(k.shape)} and "
                         f"block table {tuple(block_tables.shape)} ({block_tables.dtype})")


def gather_pages(pool, block_tables):
    """The dense (B, max_blocks * block_size, KV, hd) view of a block pool
    (NB, block_size, KV, hd) through a (B, max_blocks) table, ids clamped to
    [0, NB) as the kernel clamps them."""
    NB, bs = pool.shape[:2]
    bt = block_tables.to(device=pool.device, dtype=torch.long).clamp(0, NB - 1)
    B, mb = bt.shape
    return pool[bt].reshape(B, mb * bs, *pool.shape[2:])


def _mm(a, b):
    """``a @ b`` with every row of ``a`` reduced the same way however many
    rows share the call: the CPU's single-row product takes a path that sums
    in another order, so a single row runs as two (solo, packed and suffix
    prefills then give a row the same bits)."""
    if a.shape[-2] != 1:
        return torch.matmul(a, b)
    return torch.matmul(torch.cat([a, a], dim=-2), b)[..., :1, :]


def _scan_rows(qb, kb, vb, qp, ks: int, kv_end: int, kl: int, causal: bool, window: int,
               scale: float, keys=None):
    """The online-softmax scan of one sequence's query rows ``qb`` (H, R, hd)
    at positions ``qp`` (R,) over the kv tiles anchored at key ``ks`` that
    reach ``kv_end``: ``(acc, l, m)``.  ``keys`` (Sk,) bool admits a subset of
    the keys (K5's segment); the others are masked and load as 0."""
    H, R, hd = qb.shape
    Sk = kb.shape[1]
    dev = qb.device
    m = torch.full((H, R), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((H, R), dtype=torch.float32, device=dev)
    acc = torch.zeros((H, R, hd), dtype=torch.float32, device=dev)
    ntiles = -(-(kv_end - ks) // BLOCK_K) if kv_end > ks else 0
    for t in range(ntiles):
        kp = ks + t * BLOCK_K + torch.arange(BLOCK_K, device=dev)
        inr = (kp >= 0) & (kp < Sk)
        idx = kp.clamp(0, Sk - 1)
        if keys is not None:
            inr = inr & keys[idx]
        kt = torch.where(inr[None, :, None], kb[:, idx], 0.0)
        vt = torch.where(inr[None, :, None], vb[:, idx], 0.0)
        s = _mm(qb, kt.transpose(1, 2)) * scale                 # (H, R, BK)
        mask = ((kp >= ks) & (kp < kl))[None, :].expand(R, BLOCK_K)
        if keys is not None:
            mask = mask & inr[None, :]
        if causal:
            mask = mask & (qp[:, None] >= kp[None, :])
        if window:
            mask = mask & (qp[:, None] - kp[None, :] < window)
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _mm(p, vt)
        m = m_new
    return acc, l, m


def flash_scan_plain(q, k, v, causal: bool = True, window: int = 0,
                     q_offset: int = 0, scale: float = 0.0, kv_start=None,
                     kv_len=None, q_pos=None, seg_q=None, seg_kv=None):
    """The kv scan of the plain twin: the final ``(acc, l, m)``, shaped
    (B, H, Sq, hd), (B, H, Sq) and (B, H, Sq), before the posit division.

    With ``seg_q``/``seg_kv`` (B, Sq)/(B, Sk) segment ids (K5) each segment's
    rows scan the tiles anchored at the segment's first key, admitting its
    own keys only; rows with a negative id attend nothing.  ``kv_start`` is
    then unused."""
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    G = H // KV
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    dev = q.device
    ks_all = _per_seq(kv_start, B, 0, dev).tolist()
    kl_all = _per_seq(kv_len, B, Sk, dev).tolist()
    qp_all = _per_seq(q_pos, B, 0, dev).tolist()
    heads = torch.arange(H, device=dev) // G
    acc_all = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    l_all = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    m_all = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32, device=dev)
    for b in range(B):
        kl = min(kl_all[b], Sk)
        qp = qp_all[b] + q_offset + torch.arange(Sq, device=dev)
        qb = q[b].to(torch.float32).transpose(0, 1)            # (H, Sq, hd)
        kb = k[b].to(torch.float32)[:, heads].transpose(0, 1)  # (H, Sk, hd)
        vb = v[b].to(torch.float32)[:, heads].transpose(0, 1)
        if seg_q is None:
            kv_end = min(kl, qp_all[b] + q_offset + Sq) if causal else kl
            acc_all[b], l_all[b], m_all[b] = _scan_rows(
                qb, kb, vb, qp, ks_all[b], kv_end, kl, causal, window, scale)
            continue
        sq, skv = seg_q[b].to(dev), seg_kv[b].to(dev)
        for s in torch.unique(sq[sq >= 0]).tolist():
            rows = torch.nonzero(sq == s)[:, 0]
            keys = skv == s
            first = torch.nonzero(keys)
            if first.numel() == 0:
                continue
            kv_end = min(kl, int(qp[rows].max()) + 1) if causal else kl
            acc, l, m = _scan_rows(qb[:, rows], kb, vb, qp[rows], int(first[0, 0]), kv_end,
                                   kl, causal, window, scale, keys)
            acc_all[b][:, rows], l_all[b][:, rows], m_all[b][:, rows] = acc, l, m
    return acc_all, l_all, m_all


def _check_packed(q, k, seg_q, seg_kv, seg_len: int, kv_start) -> int:
    """Validates K5's inputs; returns its query rows per block,
    ``min(16, seg_len)``, which must divide ``seg_len`` so that no block
    straddles two segments (``Sq`` is a whole number of segments)."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    if seg_kv is None or tuple(seg_q.shape) != (B, Sq) or tuple(seg_kv.shape) != (B, Sk):
        raise ValueError(f"seg_q ({B}, {Sq}) and seg_kv ({B}, {Sk}) expected; got "
                         f"{None if seg_q is None else tuple(seg_q.shape)} and "
                         f"{None if seg_kv is None else tuple(seg_kv.shape)}")
    if kv_start is not None:
        raise ValueError("packed attention anchors each segment at its first key and "
                         "takes no kv_start")
    if seg_len <= 0 or Sq % seg_len:
        raise ValueError(f"packed attention needs seg_len > 0 dividing Sq={Sq}; "
                         f"got seg_len={seg_len}")
    bq = min(16, seg_len)
    if seg_len % bq:
        raise ValueError(f"seg_len={seg_len} must be below 16 or a multiple of 16")
    return bq


def posit_flash_attention_plain(fmt: PositFormat, q, k, v, causal: bool = True,
                                window: int = 0, q_offset: int = 0,
                                scale: float = 0.0,
                                variant: str = DEFAULT_KERNEL_VARIANT,
                                kv_start=None, kv_len=None, q_pos=None,
                                block_tables=None, seg_q=None, seg_kv=None):
    """The plain PyTorch twin of K3, K4 (``block_tables``: the pools are
    gathered into the dense view first) and K5 (``seg_q``/``seg_kv``), on
    any device: float32 (B, Sq, H, hd)."""
    if block_tables is not None:
        k, v = gather_pages(k, block_tables), gather_pages(v, block_tables)
    acc, l, _ = flash_scan_plain(q, k, v, causal, window, q_offset, scale,
                                 kv_start, kv_len, q_pos, seg_q, seg_kv)
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


_DENSE, _PAGED, _PACKED = 0, 1, 2   # csrc/posit_flash_attn.cu Layout
ROW_LOOP, TILE_LOOP = 0, 1           # csrc/posit_flash_attn.cu Loop


def flash_loop(q_pos=None, block_tables=None) -> int:
    """The loop of ``csrc/posit_flash_attn.cu`` a forward call takes:
    :data:`ROW_LOOP` (the decode loop: one query row a block, its kv tiles
    spread over the block's warps) for the decode calls, those
    that pass ``q_pos`` (``layers.decode_attention``) or a block table (K4,
    ``layers.decode_attention_paged``); :data:`TILE_LOOP` (16-row tiles)
    for every other call: a whole or suffix prefill (K3), a pack (K5) and
    the training forward (K6).

    The rule keys on the kind of call, never on ``Sq``: a one-token suffix
    prefill must give its row the bits of the same row of the whole
    prompt's prefill, and a packed segment those of its solo prefill, so
    every prefill row goes through the same loop."""
    return ROW_LOOP if q_pos is not None or block_tables is not None else TILE_LOOP


@functools.lru_cache(maxsize=None)
def _flash_fn(name: str):
    """``posit_flash_attn`` of the library ``name`` (one per format, posit64
    in parts: ``_build.library_of``)."""
    fn = _build.load(name).posit_flash_attn
    fn.argtypes = (PLAN_ARGTYPES + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 12
                   + [ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_built(plan) -> bool:
    """Are the flash kernels (K3-K8, every layout) instantiated for
    ``plan``?  Every posit8, posit16, posit32 and posit64 plan is (posit32
    ``srt_r4_scaled`` and posit64 on K1's two-word frame); posit10's, which
    only K11 divides, are not: the mirror of ``posit::kModelPlan``
    (``csrc/posit_srt.cuh``), which K9 shares.  Each format's plans live in
    a library of their own (posit64's in three: ``_build.part_of``)."""
    return plan.n in (8, 16, 32, 64)


# K/V element types the kernels read as they are (bf16 upcast in registers,
# exactly); f16 is upcast to f32 first, also exactly
_KV_DTYPES = (torch.bfloat16, torch.float32)


def head_dim_max(layout: str, loop: int = ROW_LOOP) -> int:
    """The largest head_dim the kernels take for a call in ``layout``
    ("dense", "paged", "packed" or "backward") through ``loop``: the dense
    tile loop (K3 prefill, K6) takes :data:`TILE_HEAD_DIM_MAX`, the others
    :data:`HEAD_DIM_MAX`."""
    return TILE_HEAD_DIM_MAX if layout == "dense" and loop == TILE_LOOP else HEAD_DIM_MAX


def _check_kernel_inputs(plan, q, k, v, hd: int, layout: str, loop: int = ROW_LOOP) -> None:
    """What the hand-written kernels take; raises for anything else, before
    any launch (a head_dim past :func:`head_dim_max` raises ValueError: no
    kernel takes it, and the twin runs on CPU tensors only)."""
    if not kernel_built(plan):
        raise NotImplementedError(
            f"no flash kernel is built for posit{plan.n} {plan.variant} in the {layout} "
            "layout; the twin runs on CPU tensors only (ROADMAP.md)")
    limit = head_dim_max(layout, loop)
    if hd > limit:
        what = ("the decode loop (K3 decode, K4)" if loop == ROW_LOOP and layout != "backward"
                else "the packed layout (K5)" if layout == "packed"
                else "the backward (K7, K8)" if layout == "backward" else "the tile loop")
        raise ValueError(f"head_dim {hd} > {limit}: {what} takes head_dim up to {limit} "
                         "(ROADMAP.md section 2 item 1)")
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    if k.dtype != v.dtype or k.dtype not in _KV_DTYPES + (torch.float16,):
        raise NotImplementedError(
            f"the flash kernels read bfloat16, float16 or float32 k/v of one dtype, not "
            f"{k.dtype}/{v.dtype} (a float64 k/v would have to be rounded)")


def _kv_operands(k, v):
    """``(k, v, kv_f32)`` as the kernels read them: contiguous bf16, or f32
    (f16 upcast, exactly); never narrowed."""
    if k.dtype == torch.float16:
        k, v = k.float(), v.float()
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise NotImplementedError(f"the flash kernels read bfloat16 or float32 k/v, not "
                                  f"{k.dtype}/{v.dtype}")
    return k.contiguous(), v.contiguous(), int(k.dtype == torch.float32)


def _launch(fmt: PositFormat, plan, q, k, v, causal, window, q_offset, scale, kv_start,
            kv_len, q_pos, residuals: bool = False, block_tables=None, seg_q=None,
            seg_kv=None, bq: int = 0):
    """One launch of ``csrc/posit_flash_attn.cu``: ``(out, m, l)``, with
    ``m``, ``l`` (B*H, Sq) when ``residuals`` (K6), else None.  The kv side
    is dense (K3, K6), a block pool read through ``block_tables`` (K4) or a
    packed sequence with segment ids ``seg_q``/``seg_kv`` and ``bq`` query
    rows per block (K5); the loop is :func:`flash_loop`'s."""
    B, Sq, H, hd = q.shape
    _check_kernel_inputs(plan, q, k, v, hd, "paged" if block_tables is not None else
                         "packed" if seg_q is not None else "dense",
                         flash_loop(q_pos, block_tables))
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32).contiguous()
    kc, vc, kv_f32 = _kv_operands(k, v)
    ids = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
    layout, bt, sq, skv, NB, bs, mb = _DENSE, None, None, None, 0, 0, 0
    if block_tables is not None:
        layout, bt = _PAGED, ids(block_tables)
        NB, bs, KV = k.shape[:3]
        mb = bt.shape[1]
        Sk = mb * bs
    else:
        Sk, KV = k.shape[1:3]
        if seg_q is not None:
            layout, sq, skv = _PACKED, ids(seg_q), ids(seg_kv)
    ks = _per_seq(kv_start, B, 0, dev)
    kl = _per_seq(kv_len, B, Sk, dev)
    qp = _per_seq(q_pos, B, 0, dev)
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
    m = l = None
    if residuals:
        m = torch.empty((B * H, Sq), dtype=torch.float32, device=dev)
        l = torch.empty((B * H, Sq), dtype=torch.float32, device=dev)
    ptrs = (qf, kc, vc, out, m, l, ks, kl, qp, bt, sq, skv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _flash_fn(_build.library_of("posit_flash_attn", plan))(
            *plan_args(plan), layout, flash_loop(q_pos, block_tables), kv_f32,
            *(None if t is None else t.data_ptr() for t in ptrs),
            B, Sq, Sk, H, KV, hd, NB, bs, mb, float(scale), int(bool(causal)), int(window),
            int(q_offset), minpos_eps(fmt), int(bq), stream)
    if rc == -1:
        raise NotImplementedError(f"posit_flash_attn: no kernel is built for posit{plan.n} "
                                  f"{plan.variant} in layout {layout} (ROADMAP.md)")
    if rc != 0:
        raise RuntimeError(f"posit_flash_attn launch failed ({rc})")
    return out, m, l


def posit_flash_attention(fmt: PositFormat, q, k, v, causal: bool = True,
                          window: int = 0, q_offset: int = 0, scale: float = 0.0,
                          variant: str = DEFAULT_KERNEL_VARIANT,
                          kv_start=None, kv_len=None, q_pos=None, block_tables=None,
                          seg_q=None, seg_kv=None, seg_len: int = 0):
    """Flash attention with the posit SRT normalizer, one kernel launch.

    ``q``: (B, Sq, H, hd); ``k``/``v``: (B, Sk, KV, hd) with H % KV == 0.
    Returns float32 (B, Sq, H, hd).  ``scale <= 0`` means 1/sqrt(hd).
    ``kv_start``/``kv_len``/``q_pos`` are optional (B,) int32 vectors: keys
    outside ``[kv_start[b], kv_len[b])`` are masked and ``q_pos[b]`` offsets
    the sequence's query positions (on top of ``q_offset``).

    ``block_tables`` (B, max_blocks) int32 makes ``k``/``v`` block pools
    (num_blocks, block_size, KV, hd) read through the table (K4; the virtual
    kv length is ``max_blocks * block_size``).  ``seg_q`` (B, Sq) and
    ``seg_kv`` (B, Sk) int32 segment ids make attention block-diagonal over
    ``seg_len``-wide packed segments (K5; query pads -2, key pads -1; no
    ``kv_start``): each segment's rows are those of a solo call on its
    prompt.

    CUDA tensors launch the hand-written kernel, counted per layout in
    ``posit_flash_attention.launches`` (K3; of them ``.tile_launches`` the
    prefills, which take the tile loop), ``.paged_launches`` (K4) and
    ``.packed_launches`` (K5); it takes bf16 or f32 k/v (f16 upcast to f32;
    all exact) and the plans :func:`kernel_built` names (every posit8,
    posit16, posit32 and posit64 plan) at head_dim up to :func:`head_dim_max`
    (256 for the prefills, 128 for the decode calls and K5), and raises for
    anything else.  CPU tensors run the plain twin, for every planned
    (format, variant), k/v dtype and head_dim.
    """
    plan = datapath_plan(fmt, variant)
    if block_tables is not None and seg_q is not None:
        raise NotImplementedError("paged and packed attention in one call")
    bq = 0
    if block_tables is not None:
        _check_paged(q, k, v, block_tables)
    else:
        _check_shapes(q, k, v)
        if seg_q is not None or seg_kv is not None:
            bq = _check_packed(q, k, seg_q, seg_kv, seg_len, kv_start)
    if q.device.type == "cpu":
        return posit_flash_attention_plain(fmt, q, k, v, causal, window,
                                           q_offset, scale, variant,
                                           kv_start, kv_len, q_pos,
                                           block_tables, seg_q, seg_kv)
    out, _, _ = _launch(fmt, plan, q, k, v, causal, window, q_offset, scale, kv_start,
                        kv_len, q_pos, block_tables=block_tables, seg_q=seg_q,
                        seg_kv=seg_kv, bq=bq)
    if block_tables is not None:
        posit_flash_attention.paged_launches += 1
    elif bq:
        posit_flash_attention.packed_launches += 1
    else:
        posit_flash_attention.launches += 1
        if flash_loop(q_pos) == TILE_LOOP:
            posit_flash_attention.tile_launches += 1
    return out


posit_flash_attention.launches = 0
posit_flash_attention.tile_launches = 0   # of .launches: K3 through the tile loop (prefill)
posit_flash_attention.paged_launches = 0
posit_flash_attention.packed_launches = 0


def posit_flash_attention_fwd(fmt: PositFormat, q, k, v, causal: bool = True,
                              window: int = 0, q_offset: int = 0, scale: float = 0.0,
                              variant: str = DEFAULT_KERNEL_VARIANT):
    """The training forward (K6): ``(o, m, l)``, the attention output as
    :func:`posit_flash_attention` gives it plus each row's final online-
    softmax max and sum, float32 (B*H, Sq) with no padding (the reference
    returns (B*H, Sq_padded)).  ``m + log(l)`` is the row logsumexp of the
    masked scores; a fully masked row has ``l == 0``.

    CUDA tensors launch the tile loop of K3's source with its residual
    outputs (counted in ``posit_flash_attention_fwd.launches``), CPU tensors
    run the plain twin.
    """
    plan = datapath_plan(fmt, variant)
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return posit_flash_attention_fwd_plain(fmt, q, k, v, causal, window, q_offset,
                                               scale, variant)
    out, m, l = _launch(fmt, plan, q, k, v, causal, window, q_offset, scale, None, None,
                        None, residuals=True)
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
def _bwd_fns(lib_name: str):
    """K7's and K8's C entries in the library ``lib_name``."""
    lib = _build.load(lib_name)
    fns = []
    for name, n_out in (("posit_flash_bwd_dq", 1), ("posit_flash_bwd_dkv", 2)):
        fn = getattr(lib, name)
        fn.argtypes = (PLAN_ARGTYPES + [ctypes.c_int] + [ctypes.c_void_p] * (7 + n_out)
                       + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def _launch_backward(which: int, fmt, plan, q, k, v, g, m, l, D, outs, causal, window,
                     q_offset, scale):
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise NotImplementedError(f"the backward kernels read bfloat16 or float32 k/v, not "
                                  f"{k.dtype}/{v.dtype}")
    fn = _bwd_fns(_build.library_of("posit_flash_bwd", plan))[which]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(*plan_args(plan), int(k.dtype == torch.float32), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), g.data_ptr(),
                m.data_ptr(), l.data_ptr(), D.data_ptr(), *(t.data_ptr() for t in outs),
                B, Sq, Sk, H, KV, hd, float(scale), int(bool(causal)), int(window),
                int(q_offset), minpos_eps(fmt), stream)
    if rc == -1:
        raise NotImplementedError(f"{fn.__name__}: no kernel is built for posit{plan.n} "
                                  f"{plan.variant} (ROADMAP.md)")
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed ({rc})")


def flash_backward_dq(fmt: PositFormat, plan, q, k, v, g, m, l, D, causal, window,
                      q_offset, scale):
    """One launch of K7: float32 dq (B, Sq, H, hd), counted in
    ``flash_backward_dq.launches``.  Inputs as :func:`flash_backward`
    prepares them (contiguous, q and g float32, k and v bfloat16 or
    float32)."""
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

    CUDA tensors launch K7 (dq) and K8 (dk, dv), on bf16 or f32 k/v (f16
    upcast to f32), dk and dv cast to k/v's dtype as the reference returns
    them; CPU tensors run the plain twin :func:`flash_backward_plain`.
    """
    plan = datapath_plan(fmt, variant)
    B, Sq, H, hd, Sk, KV = _check_shapes(q, k, v)
    if m.shape != (B * H, Sq) or l.shape != (B * H, Sq):
        raise ValueError(f"m and l must be ({B * H}, {Sq}); got {tuple(m.shape)} "
                         f"and {tuple(l.shape)}")
    if q.device.type == "cpu":
        return flash_backward_plain(fmt, q, k, v, o, g, m, l, causal, window, q_offset,
                                    scale, variant)
    _check_kernel_inputs(plan, q, k, v, hd, "backward")
    if scale <= 0.0:
        scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qf, gf = q.to(f32).contiguous(), g.to(f32).contiguous()
    kc, vc, _ = _kv_operands(k, v)
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
