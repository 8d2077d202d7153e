#!/usr/bin/env python3
"""How often a flash forward's arithmetic puts a posit16 output past
FLASH_TOL (5e-4) from the plain twin, emulated on the CPU.

    PYTHONPATH=src python tools/flash_rounding.py [--case train|decode_prefill]
        [--seeds 100:120] [--arith fma:fma,3xtf32:split3,...] [--step 64]

Posit16 rounds the dividend ``acc`` and the divisor ``l`` to posit16 before
it divides (``divide_floats_block``), and at |acc| or l in [16, 64) its
step is 2^-10 of them: an f32-ulp difference between a kernel's sums and the
twin's, at such a rounding boundary, moves an output by 2^-10 of its value,
past FLASH_TOL where |o| is 0.5 or more.  This script runs the flash scan of
``kernels/posit_flash_attn.flash_scan_plain`` (64-key tiles anchored at
kv_start, the online-softmax rescaling) with the products done in a given
arithmetic, divides through the twin's K1, and counts the outputs that
differ from the twin's and those past FLASH_TOL.  ``--arith`` takes
``scores:pv`` pairs, each one of:

  * ``fma``: f32 FMAs in sequence over the depth (the twin's CPU product's
    order); as P V, the decode loop's and the tile loop's whole step: p v
    summed from zero, acc = fma(acc, corr, p v), l = fma(l, corr, the
    step's p summed in key order);
  * ``3xtf32``: tf32 hi/lo splits, hi*hi + hi*lo + lo*hi summed 8 at a time
    on the tensor core, the three products chained, then added in f32
    (``csrc/flash_stage.cuh`` mma3: K7's scores and the tile loop's at posit32/64);
  * ``split3``: the left operand split exactly into three tf32 parts, each
    part's 8-term product summed from zero on the tensor core and added in
    f32, the smallest first (a tensor-core P V with exact products);
  * ``exact``: float64 products and sums, rounded to f32 once;
  * ``mma`` (P V only): the tile loop's tensor-core step at posit32 and
    posit64: each 8-key k-step in 3xTF32 from zero, added in f32, the
    step's sum from zero, acc = fma(acc, corr, p v), l in key order.

A tensor core's sum is modelled as its exact products summed in float64 and
truncated to f32, a model of the hardware (which aligns and truncates before
it sums), not its bits.  With tensor-core P V the row sums are added in the
tensor-core form's order (the lane's four keys, its quad's butterfly, warps
0..3), l = fma(l, corr, sum), and acc = acc * corr before the products.
``--step`` sets the keys of a step (the twin's BLOCK_K, 64, by default; 32
rescales twice per twin tile, as the tile loop does at posit32 and posit64).
``train`` is the training path's shape (8 x 256, 15/5 heads of 64, causal, q holding
bf16 values, as ``chip_smoke.py``'s ``training_inputs``), ``decode_prefill``
the prefill of ``tests/test_torch_cuda.py``'s ``_check_decode_and_prefill``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core.posit import POSIT16  # noqa: E402
from repro_torch.kernels import posit_flash_attn as F  # noqa: E402
from repro_torch.kernels.posit_div import divide_floats_block  # noqa: E402

FLASH_TOL = 5e-4
f32, f64 = torch.float32, torch.float64


def tf32(x):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 fraction bits, ties away."""
    u = x.to(f32).contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(f32)


def truncate(x64):
    """A float64 sum to f32 toward zero (the tensor core's accumulate)."""
    r = x64.to(f32)
    return torch.where(r.to(f64).abs() > x64.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mma(a, b, c):
    """One m16n8k8 TF32 MMA: exact products, their sum with c truncated."""
    return truncate(a.to(f64) @ b.to(f64) + c.to(f64))


def rn_add(x, y):
    return (x.to(f64) + y.to(f64)).to(f32)


def fma(a, b, c):
    """f32 a * b + c rounded once (the float64 product is exact)."""
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)


def key_order_sums(p):
    """A step's row sums, one f32 add a key, in key order."""
    total = torch.zeros(p.shape[:-1], dtype=f32)
    for j in range(p.shape[-1]):
        total = total + p[..., j]
    return total


def product(a, b, c, arith):
    """``c + a @ b`` over the last axis of ``a`` (a multiple of 8) in
    ``arith``; ``c`` is where the sum starts (f32)."""
    if arith == "exact":
        return (c.to(f64) + a.to(f64) @ b.to(f64)).to(f32)
    out = c
    if arith == "fma":
        for d in range(a.shape[-1]):
            out = (out.to(f64) + a[..., d:d + 1].to(f64) * b[..., d:d + 1, :].to(f64)).to(f32)
        return out
    zero = torch.zeros_like(c)
    for k in range(0, a.shape[-1], 8):
        ak, bk = a[..., k:k + 8], b[..., k:k + 8, :]
        bh = tf32(bk)
        bl = tf32(bk - bh)
        if arith == "3xtf32":
            ah = tf32(ak)
            al = tf32(ak - ah)
            t = mma(ah, bh, mma(ah, bl, mma(al, bh, zero)))
            out = rn_add(out, t)
        elif arith == "split3":
            a1 = tf32(ak)
            r = ak - a1
            a2 = tf32(r)
            a3 = tf32(r - a2)
            for part, bpart in ((a3, bh), (a2, bh), (a1, bl), (a1, bh)):
                out = rn_add(out, mma(part, bpart, zero))
        else:
            raise ValueError(f"unknown arithmetic {arith}")
    return out


def tile_row_sums(p):
    """A step's row sums in the first tensor-core form's order."""
    total = None
    for w in range(p.shape[-1] // 16):
        lanes = []
        for t in range(4):
            x = p[..., 16 * w + 2 * t] + p[..., 16 * w + 2 * t + 1]
            x = x + p[..., 16 * w + 8 + 2 * t]
            lanes.append(x + p[..., 16 * w + 9 + 2 * t])
        x = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
        total = x if total is None else total + x
    return total


def scan(q, k, v, start, scores, pv, step=F.BLOCK_K):
    """``(acc, l)`` of the causal flash scan, (B, H, Sq, hd) and (B, H, Sq)."""
    B, Sq, H, hd = q.shape
    heads = torch.arange(H) // (H // k.shape[2])
    Sk = k.shape[1]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=f32)
    acc_all = torch.zeros(B, H, Sq, hd, dtype=f32)
    l_all = torch.zeros(B, H, Sq, dtype=f32)
    qp = torch.arange(Sq)
    for b in range(B):
        ks = int(start[b])
        qb = q[b].transpose(0, 1).to(f32)
        kb = k[b].to(f32)[:, heads].transpose(0, 1)
        vb = v[b].to(f32)[:, heads].transpose(0, 1)
        acc = torch.zeros(H, Sq, hd, dtype=f32)
        l = torch.zeros(H, Sq, dtype=f32)
        m = torch.full((H, Sq), F._NEG_INF, dtype=f32)
        for base in range(ks, Sq, step):
            kp = base + torch.arange(step)
            inr = kp < Sk
            idx = kp.clamp(max=Sk - 1)
            kt = torch.where(inr[None, :, None], kb[:, idx], 0.0)
            vt = torch.where(inr[None, :, None], vb[:, idx], 0.0)
            s = product(qb, kt.transpose(1, 2).contiguous(),
                        torch.zeros(H, Sq, step, dtype=f32), scores) * scale
            mask = inr[None, :] & (qp[:, None] >= kp[None, :])
            s = torch.where(mask, s, torch.tensor(F._NEG_INF, dtype=f32))
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.tensor(0.0, dtype=f32))
            corr = torch.exp(m - m_new)
            if pv in ("fma", "mma"):
                l = fma(l, corr, key_order_sums(p))
                pv_step = product(p, vt, torch.zeros_like(acc), "fma" if pv == "fma" else "3xtf32")
                acc = fma(acc, corr[..., None], pv_step)
            else:
                l = fma(l, corr, tile_row_sums(p))
                acc = product(p, vt, acc * corr[..., None], pv)
            m = m_new
        acc_all[b], l_all[b] = acc, l
    return acc_all, l_all


def case(name, seed):
    g = torch.Generator().manual_seed(seed)
    if name == "train":
        q = torch.randn(8, 256, 15, 64, generator=g).to(torch.bfloat16).float()
        k = torch.randn(8, 256, 5, 64, generator=g).to(torch.bfloat16)
        v = torch.randn(8, 256, 5, 64, generator=g).to(torch.bfloat16)
        return q, k, v, torch.zeros(8, dtype=torch.int32)
    # the prefill of tests/test_torch_cuda.py _check_decode_and_prefill (seed 1)
    torch.randn(4, 1, 15, 64, generator=g)
    k = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16)
    v = torch.randn(4, 300, 5, 64, generator=g).to(torch.bfloat16)
    q = torch.randn(2, 77, 15, 64, generator=g)
    return q, k[:2, :77].contiguous(), v[:2, :77].contiguous(), torch.tensor([0, 30])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="train", choices=("train", "decode_prefill"))
    ap.add_argument("--seeds", default="100:120", help="a:b, the seeds [a, b)")
    ap.add_argument("--arith", default="fma:fma,3xtf32:split3,3xtf32:3xtf32,exact:exact")
    ap.add_argument("--step", type=int, default=F.BLOCK_K, help="keys a step (a multiple of 16)")
    args = ap.parse_args()
    lo, hi = map(int, args.seeds.split(":"))
    seeds = range(lo, hi) if args.case == "train" else [1]
    ariths = [tuple(a.split(":")) for a in args.arith.split(",")]
    tally = {a: [0, 0, 0, 0.0] for a in ariths}   # outputs, off the twin, past the bound, worst
    for seed in seeds:
        q, k, v, start = case(args.case, seed)
        twin = F.posit_flash_attention_plain(POSIT16, q, k, v, True, kv_start=start)
        for a in ariths:
            acc, l = scan(q, k, v, start, *a, step=args.step)
            l_safe = torch.where(l > 0, l, F.minpos_eps(POSIT16))
            o = divide_floats_block(POSIT16, acc, l_safe[..., None]).transpose(1, 2)
            d = (o - twin).abs()
            t = tally[a]
            t[0] += d.numel()
            t[1] += int((d > 0).sum())
            t[2] += int((d > FLASH_TOL).sum())
            t[3] = max(t[3], float(d.max()))
    for (scores, pv), (n, off, past, worst) in tally.items():
        print(f"{args.case} seeds {args.seeds if args.case == 'train' else 1}, {args.step}-key "
              f"steps: scores {scores}, P V {pv}: {n} posit16 outputs, {off} off the twin's, {past} past {FLASH_TOL} "
              f"(worst {worst:.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
