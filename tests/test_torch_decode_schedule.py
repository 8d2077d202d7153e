"""The decode loop's schedule against the one-tile-at-a-time scan it replaced.

``csrc/posit_flash_attn.cu``'s decode loop (K3 decode, K4) no longer walks a
row's 64-key tiles one after another.  It takes them in chunks of W tiles,
one a warp: every tile's scores and max, then each tile's prefix max ``m_t``,
then each tile's ``p = exp(s - m_t)``, its ``p`` summed in key order from
zero and its ``p v`` summed over its keys from zero, then the tiles combined
in order, ``l = fma(l, corr_t, sum_t)`` and ``acc = fma(acc, corr_t, pv_t)``
with ``corr_t = exp(m_{t-1} - m_t)``.  The scan it replaced
(``tools/flash_rounding.py``'s ``fma`` arithmetic, the kernels' f32 FMAs)
carried ``(m, l, acc)`` through the tiles in turn.  Both are emulated here
on the CPU, with every f32 FMA rounded once, and must give the same bits of
``acc``, ``l`` and ``m``: rows that end on and across tile and chunk
boundaries (W = 4 and 8), a ``kv_start`` above 0, a fully masked row and a
window.
"""

import numpy as np
import pytest
import torch

BK = 64            # keys per tile (csrc/posit_flash_attn.cu kBK)
NEG_INF = -1e30    # the masked score
f32, f64 = torch.float32, torch.float64


def fma(a, b, c):
    """f32 ``a * b + c`` rounded once (the float64 product is exact)."""
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)


def tile_scores(q, k, rows, t, scale, window, causal=True):
    """Tile ``t`` of each row: its scores (R, BK), scaled and masked as the
    kernel does, its mask and its V rows.  ``rows`` holds each row's
    (position, kv_start, kv_len); the tile covers keys [kv_start + 64 t,
    kv_start + 64 (t + 1)), loaded as 0 outside the cache."""
    K, V = k
    qp, ks, kl = (torch.tensor(c) for c in zip(*rows))
    kp = ks[:, None] + t * BK + torch.arange(BK)[None, :]
    inr = (kp >= 0) & (kp < K.shape[0])
    idx = kp.clamp(0, K.shape[0] - 1)
    kt = torch.where(inr[..., None], K[idx], 0.0)
    vt = torch.where(inr[..., None], V[idx], 0.0)
    s = torch.zeros(kp.shape, dtype=f32)
    for d in range(q.shape[1]):               # over the head's columns in order
        s = fma(q[:, d:d + 1], kt[..., d], s)
    valid = (kp >= ks[:, None]) & (kp < kl[:, None])
    if causal:
        valid &= qp[:, None] >= kp
    if window:
        valid &= qp[:, None] - kp < window
    s = torch.where(valid, s * scale, torch.tensor(NEG_INF, dtype=f32))
    return s, valid, vt


def tile_sums(p, vt):
    """The tile's p summed in key order from zero, and its p v over its
    keys in order from zero, one FMA a key."""
    total = torch.zeros(p.shape[0], dtype=f32)
    pv = torch.zeros(vt.shape[0], vt.shape[2], dtype=f32)
    for j in range(BK):
        total = total + p[:, j]
        pv = fma(p[:, j:j + 1], vt[:, j], pv)
    return total, pv


def n_tiles(rows, causal=True):
    out = []
    for qp, ks, kl in rows:
        end = min(kl, qp + 1) if causal else kl
        out.append(-(-(end - ks) // BK) if end > ks else 0)
    return torch.tensor(out)


def scan_by_tile(q, kv, rows, scale, window):
    """The replaced scan: (m, l, acc) carried through each row's tiles."""
    R, hd = q.shape
    m = torch.full((R,), NEG_INF, dtype=f32)
    l = torch.zeros(R, dtype=f32)
    acc = torch.zeros(R, hd, dtype=f32)
    nt = n_tiles(rows)
    for t in range(int(nt.max())):
        live = t < nt
        s, valid, vt = tile_scores(q, kv, rows, t, scale, window)
        m_new = torch.maximum(m, s.max(dim=1).values)
        p = torch.where(valid, torch.exp(s - m_new[:, None]), 0.0)
        total, pv = tile_sums(p, vt)
        corr = torch.exp(m - m_new)
        l = torch.where(live, fma(l, corr, total), l)
        acc = torch.where(live[:, None], fma(acc, corr[:, None], pv), acc)
        m = torch.where(live, m_new, m)
    return m, l, acc


def scan_by_chunk(q, kv, rows, scale, window, W):
    """The decode loop's schedule: chunks of W tiles, their maxes, the
    prefix maxes, each tile's p, sum and p v from zero, then the combine."""
    R, hd = q.shape
    m = torch.full((R,), NEG_INF, dtype=f32)
    l = torch.zeros(R, dtype=f32)
    acc = torch.zeros(R, hd, dtype=f32)
    nt = n_tiles(rows)
    for c0 in range(0, int(nt.max()), W):
        tiles = [tile_scores(q, kv, rows, t, scale, window) for t in range(c0, c0 + W)]
        maxes = torch.stack([s.max(dim=1).values for s, _, _ in tiles], dim=1)   # (R, W)
        live = (c0 + torch.arange(W))[None, :] < nt[:, None]
        # m_t = max(m_{t-1}, the tile's max) over the live tiles, m_{-1} = m
        prefix = torch.cummax(torch.cat([m[:, None], torch.where(live, maxes, NEG_INF)], 1),
                              dim=1).values
        parts = []
        for w, (s, valid, vt) in enumerate(tiles):
            p = torch.where(valid, torch.exp(s - prefix[:, w + 1, None]), 0.0)
            parts.append(tile_sums(p, vt))
        for w, (total, pv) in enumerate(parts):
            corr = torch.exp(prefix[:, w] - prefix[:, w + 1])
            l = torch.where(live[:, w], fma(l, corr, total), l)
            acc = torch.where(live[:, w, None], fma(acc, corr[:, None], pv), acc)
        m = prefix[:, -1]
    return m, l, acc


def bits(t):
    return t.contiguous().view(torch.int32)


# each row: (position, kv_start, kv_len = position + 1) unless named
POSITIONS = [0, 63, 64, 65, 255, 256, 257, 1023]
CASES = {
    "tile_and_chunk_edges": [(p, 0, p + 1) for p in POSITIONS],
    "kv_start": [(40, 5, 41), (300, 100, 301), (257, 1, 258), (700, 130, 701)],
    "fully_masked": [(3, 10, 4), (200, 0, 201)],
    "window": [(300, 0, 301), (1023, 7, 1024), (64, 0, 65)],
}


@pytest.mark.parametrize("W", [4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_schedule_is_tile_scan_bits(case, W):
    rng = np.random.default_rng(len(case) + W)
    hd, Sk = 64, 1024
    rows = CASES[case]
    window = 48 if case == "window" else 0
    q = torch.from_numpy(rng.standard_normal((len(rows), hd)).astype(np.float32))
    # bf16 K/V (the cache's type) held as f32, larger scores than unit q . k
    kv = tuple(torch.from_numpy(rng.standard_normal((Sk, hd)).astype(np.float32) * 2)
               .to(torch.bfloat16).to(f32) for _ in range(2))
    scale = hd ** -0.5
    want = scan_by_tile(q, kv, rows, scale, window)
    got = scan_by_chunk(q, kv, rows, scale, window, W)
    for name, a, b in zip("m l acc".split(), got, want):
        assert torch.equal(bits(a), bits(b)), name
    if case == "fully_masked":
        assert want[1][0] == 0 and (want[2][0] == 0).all() and want[0][0] == NEG_INF
