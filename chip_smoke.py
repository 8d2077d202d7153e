#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. setup    — the card's name and power limit, the kernels' parallel build.
2. K1 + K2  — the rowwise fused posit divide against its plain twin,
              bit-exact: posit16 srt_r4_cs_of_fr on 2^20 random pairs plus
              the special values, posit8 exhaustive, every one-word
              (format, variant) sampled.
3. K3       — flash attention against its plain twin at the main path's
              shapes (decode B=8, Sk=512; prefill P=128) and for every
              posit16 plan it is built for: max|diff| within FLASH_TOL,
              fully masked rows exactly 0.
   model    — the smoke config on the card (kernels) against the same
              weights on the CPU (plain twins, which the CPU tests hold
              against the reference): logits within LOGIT_ULPS bf16 ulps.
4. main     — SmolLM-360M at full width (all 32 layers, random weights from
              a seed) served by ``ServeEngine`` (8 slots, max_seq 512): 16
              greedy requests, prompts of 16-200 tokens, 32 new tokens each.
              Launch counters are zeroed before and read after: K2 must run
              2L+1 times and K3 L times per forward.  Two requests must be
              bit-identical solo and batched.
5. timing   — each kernel, its plain twin and a library yardstick at the
              main path's shapes (the kernel's device time from
              torch.profiler, which must see it; per-call times from CUDA
              events), and one full-width decode step broken down by
              kernel class.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# max|K3 - twin|: the two share tiles and key order and differ only by f32
# rounding in exp and the sums, which can move a quotient by one posit16
# step (2^-11 = 4.9e-4 in [1, 2)); observed 1.2e-4
FLASH_TOL = 5e-4
LOGIT_ULPS = 8          # card vs CPU logits, in bf16 ulps of max|logit|
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# 32-bit integer operations of the posit datapath per element (a static
# model of posit_srt.cuh: quantize, decode, the recurrence, encode,
# dequantize), bounded at the f32 CUDA-core rate.
DIV_OPS_FIXED = 160
DIV_OPS_PER_ITERATION = 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` from CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def div_ops(plan, elements: int) -> int:
    return elements * (DIV_OPS_FIXED + DIV_OPS_PER_ITERATION * plan.iterations)


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bits(t):
    import torch

    return t.contiguous().view(torch.int32)


def max_abs_err(k, p) -> float:
    """max|k - p| over elements whose bits differ (a NaN against a number
    counts as inf); 0.0 when the two are bit-identical."""
    import torch

    differ = bits(k) != bits(p)
    if not bool(differ.any()):
        return 0.0
    d = (k[differ] - p[differ]).abs()
    return float(torch.nan_to_num(d, nan=math.inf).max())


# --------------------------------------------------------------- phase 2


def phase_rowwise(torch, dev):
    from repro_torch.core.posit import POSIT8, POSIT16, posit_to_float
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import one_word_pairs

    g = torch.Generator(device="cpu").manual_seed(11)
    specials = torch.tensor([1.5, -2.25, 0.0, -0.0, math.inf, -math.inf, math.nan,
                             1e30, -1e-30, 3.0, 1e-45, -3e-39, 1e-38])

    def wide(R, C):
        mant = torch.randn(R, C, generator=g)
        return mant * torch.exp(torch.empty(R, C).uniform_(-40, 40, generator=g))

    worst = [0.0]

    def compare(fmt, variant, a, b):
        a, b = a.to(dev), b.to(dev)
        k = ops.posit_div_fused_rowwise(fmt, a, b, variant)
        p = ops.posit_div_rowwise_plain(fmt, a, b, variant)
        torch.cuda.synchronize()
        diff = int((bits(k) != bits(p)).sum())
        worst[0] = max(worst[0], max_abs_err(k, p))
        check(diff == 0, f"K2 {fmt}/{variant}: {diff} elements differ from the twin")

    # the main path's shapes: a decode step's and a prefill's RMSNorm rows
    for R in (8, 256):
        compare(POSIT16, "srt_r4_cs_of_fr", torch.randn(R, 960, generator=g),
                torch.rand(R, 1, generator=g) + 0.01)
    # posit16 default variant: 2^20 random pairs + the special values
    a = wide(1024, 1024)
    b = wide(1024, 1)
    a[0, :len(specials)] = specials
    b[:len(specials), 0] = specials
    compare(POSIT16, "srt_r4_cs_of_fr", a, b)
    # posit8 exhaustive: every pattern (and the specials) against every other
    vals = torch.cat([posit_to_float(POSIT8, torch.arange(256)), specials])
    for _, variant, _ in one_word_pairs((POSIT8,)):
        compare(POSIT8, variant, vals[None, :].expand(len(vals), -1).contiguous(),
                vals[:, None].contiguous())
    # every one-word (format, variant), sampled
    n_pairs = 0
    for fmt, variant, _ in one_word_pairs():
        a, b = wide(256, 512), wide(256, 1)
        a[0, :len(specials)] = specials
        b[:len(specials), 0] = specials
        compare(fmt, variant, a, b)
        n_pairs += 1
    print(f"K2: bit-exact to its twin (posit16 2^20 pairs, posit8 exhaustive, "
          f"{n_pairs} one-word plans sampled), max|diff| {worst[0]}")
    return worst[0]


# --------------------------------------------------------------- phase 3


def flash_inputs(torch, dev, B, Sq, Sk, H, KV, hd, seed):
    """q in f32, k/v in bf16 (as the serving path gives them to K3)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g).to(dev)
    k = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Sk, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    return q, k, v


def phase_flash(torch, dev):
    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels.posit_div import KERNEL_VARIANTS
    from repro_torch.kernels.posit_flash_attn import (
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    worst = {}

    def compare(name, q, k, v, variant="srt_r4_cs_of_fr", **kw):
        o = posit_flash_attention(POSIT16, q, k, v, True, variant=variant, **kw)
        p = posit_flash_attention_plain(POSIT16, q, k, v, True, variant=variant, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o).all()), f"K3 {name}: non-finite output")
        worst[name] = max_abs_err(o, p)
        check(worst[name] <= FLASH_TOL,
              f"K3 {name}: max|diff| {worst[name]} from its twin > {FLASH_TOL}")
        return o

    # decode: B=8 slots at mixed positions and starts, one query row each
    q, k, v = flash_inputs(torch, dev, 8, 1, 512, 15, 5, 64, 1)
    pos = torch.tensor([511, 0, 17, 130, 255, 64, 300, 12], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 5, 100, 250, 64, 0, 13], dtype=torch.int32, device=dev)
    kw = dict(kv_start=start, kv_len=pos + 1, q_pos=pos)
    o = compare("decode", q, k, v, **kw)
    check(bool((o[7] == 0).all()), "K3 decode: fully masked row is not 0")
    # every other posit16 plan the kernel is built for, at the decode shape
    for variant in KERNEL_VARIANTS:
        if variant != "srt_r4_cs_of_fr":
            compare(f"decode {variant}", q, k, v, variant, **kw)
    # prefill: one prompt left-padded by 40 to P=128, causal (the pad rows
    # are fully masked)
    q, k, v = flash_inputs(torch, dev, 1, 128, 128, 15, 5, 64, 2)
    o = compare("prefill", q, k, v, kv_start=torch.tensor([40], dtype=torch.int32, device=dev))
    check(bool((o[0, :40] == 0).all()), "K3 prefill: fully masked rows are not 0")
    print(f"K3: within {FLASH_TOL} of its twin for {len(KERNEL_VARIANTS)} posit16 plans: "
          f"decode max|diff|={worst['decode']:.3g}, prefill max|diff|="
          f"{worst['prefill']:.3g}, all plans {max(worst.values()):.3g}")
    return max(worst.values())


def phase_model_small(torch, dev):
    """The smoke model on the card against the same weights on the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("smollm_360m", smoke=True, fused=True)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    gpu = {k: (v.to(dev) if torch.is_tensor(v) else
               [{n: w.to(dev) for n, w in lay.items()} for lay in v])
           for k, v in cpu.items()}
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 2, 1)))
    start = torch.tensor([0, 6], dtype=torch.int32)
    runs = {}
    for name, params, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        cache = T.init_cache(cfg, 2, 64, device=d)
        lg, cache = T.prefill(params, cfg, toks.to(d), cache, start.to(d))
        out = [lg.float().cpu()]
        for i in range(3):
            pos = torch.full((2,), 20 + i, dtype=torch.int32, device=d)
            lg, cache = T.decode_step(params, cfg, cache, forced[i].to(d), pos, start.to(d))
            out.append(lg.float().cpu())
        runs[name] = out
    worst = 0.0
    for c, g in zip(runs["cpu"], runs["gpu"]):
        c, g = c[..., :cfg.vocab], g[..., :cfg.vocab]
        bound = LOGIT_ULPS * 2.0 ** (math.floor(math.log2(float(c.abs().max()))) - 7)
        err = float((c - g).abs().max())
        check(bool(torch.isfinite(g).all()) and err <= bound,
              f"smoke model: card vs CPU logits differ by {err} > {bound}")
        worst = max(worst, err / bound)
    print(f"model: smoke config on the card within {worst:.2f} of the "
          f"{LOGIT_ULPS}-ulp bound of the CPU path (prefill + 3 decode steps)")


# --------------------------------------------------------------- phase 4


def phase_main(torch, dev):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention
    from repro_torch.models import transformer as T
    from repro_torch.serve import FinishReason, Request, ServeEngine

    cfg = get_config("smollm_360m", fused=True)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    print(f"main: SmolLM-360M ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}) random "
          f"weights in {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(cfg, params, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 201, 16)
    reqs = [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=32)
            for n in lens]
    eng.serve([Request(reqs[0].tokens, max_new=2)])   # warm-up, not counted
    torch.cuda.synchronize()

    ops.posit_div_fused_rowwise.launches = 0
    posit_flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k3 = ops.posit_div_fused_rowwise.launches, posit_flash_attention.launches

    stats = eng.last_serve_stats
    forwards = stats["admissions"] + stats["decode_steps"]
    L = cfg.n_layers
    check(k2 == (2 * L + 1) * forwards,
          f"K2 launched {k2} times, the path implies {(2 * L + 1) * forwards}")
    check(k3 == L * forwards, f"K3 launched {k3} times, the path implies {L * forwards}")
    for r in eng.last_results:
        check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == 32,
              f"request {r.rid} finished {r.finish} with {len(r.tokens)} tokens "
              f"({r.detail})")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"request {r.rid}: token out of the vocabulary")
    n_tok = sum(len(o) for o in outs)
    print(f"main: served {len(reqs)} requests (prompts {lens.min()}-{lens.max()} "
          f"tokens, 32 new each) on {eng.sc.max_batch} slots: {n_tok} tokens in "
          f"{wall:.2f} s = {n_tok / wall:.1f} tokens/s; {stats['admissions']} "
          f"prefills + {stats['decode_steps']} decode steps; K2 {k2} launches, "
          f"K3 {k3} launches")
    for i in (0, 7):
        solo = eng.serve([reqs[i]])[0]
        check(np.array_equal(solo, outs[i]),
              f"request {i}: solo tokens differ from the batched run")
    print("main: requests 0 and 7 bit-identical solo and batched")
    return {"rowwise": k2, "flash": k3, "tokens_per_s": n_tok / wall,
            "forwards": forwards}


# --------------------------------------------------------------- phase 5


def device_kernel_ms(torch, fn, names, iters=20):
    """Device time per call of the CUDA kernels whose name contains one of
    ``names``, from torch.profiler (None if the trace shows none)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and any(
                n in e.key for n in names):
            total += e.self_device_time_total
    return total / iters / 1e3 if total > 0 else None


def phase_timing(torch, dev):
    import torch.nn.functional as Fn

    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import one_word_plan
    from repro_torch.kernels.posit_flash_attn import (
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    plan = one_word_plan(POSIT16, "srt_r4_cs_of_fr")
    g = torch.Generator(device="cpu").manual_seed(5)
    rows = {}

    def rowwise_row(R, C):
        a = torch.randn(R, C, generator=g).to(dev)
        b = (torch.rand(R, 1, generator=g) + 0.5).to(dev)
        call = lambda: ops.posit_div_fused_rowwise(POSIT16, a, b)
        dev_ms = device_kernel_ms(torch, call, ["rowwise_kernel"])
        check(dev_ms is not None, "torch.profiler saw no rowwise_kernel on the device")
        bms, by = bound_ms(8 * R * C + 4 * R, div_ops(plan, R * C))
        return {"shape": [R, C], "ms": dev_ms, "call_ms": cuda_time_ms(call),
                "plain_ms": cuda_time_ms(lambda: ops.posit_div_rowwise_plain(POSIT16, a, b),
                                         iters=5),
                "bound_ms": bms, "bound_by": by, "library_ms": None}

    rows["K2 decode"] = rowwise_row(8, 960)
    rows["K2 prefill"] = rowwise_row(256, 960)
    rows["K1"] = rowwise_row(1024, 1024)

    def flash_row(B, Sq, Sk, pos, start):
        H, KV, hd = 15, 5, 64
        q, k, v = flash_inputs(torch, dev, B, Sq, Sk, H, KV, hd, 7)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        start_t = torch.tensor(start, dtype=torch.int32, device=dev)
        if Sq == 1:
            kw = dict(kv_start=start_t, kv_len=pos_t + 1, q_pos=pos_t)
            valid = [p + 1 - s for p, s in zip(pos, start)]       # keys per row
            qp = pos_t[:, None]
        else:
            kw = dict(kv_start=start_t)
            valid = [sum(max(0, i + 1 - s) for i in range(Sq)) / Sq for s in start]
            qp = torch.arange(Sq, device=dev)[None, :].expand(B, Sq)
        call = lambda: posit_flash_attention(POSIT16, q, k, v, True, **kw)
        dev_ms = device_kernel_ms(torch, call, ["flash_kernel"])
        check(dev_ms is not None, "torch.profiler saw no flash_kernel on the device")
        keys = sum(valid) * Sq
        nbytes = 4 * B * Sq * H * hd * 2 + 2 * 2 * sum(
            min(Sk, p + 1) - s if Sq == 1 else Sk - s for p, s in zip(pos, start)) * KV * hd
        ops_ = 4 * H * keys * hd + div_ops(plan, B * Sq * H * hd)
        bms, by = bound_ms(nbytes, ops_)
        # library yardstick: one SDPA call with the same masks, f32 inputs
        kp = torch.arange(Sk, device=dev)
        mask = (kp[None, None, :] <= qp[:, :, None]) & (kp[None, None, :] >= start_t[:, None, None])
        qs, ks, vs = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask[:, None],
                                                       enable_gqa=True)
        return {"shape": [B, Sq, Sk, H, KV, hd], "ms": dev_ms, "call_ms": cuda_time_ms(call),
                "plain_ms": cuda_time_ms(lambda: posit_flash_attention_plain(
                    POSIT16, q, k, v, True, **kw), iters=3),
                "bound_ms": bms, "bound_by": by, "library_ms": cuda_time_ms(lib)}

    rows["K3 decode"] = flash_row(8, 1, 512, [47, 63, 92, 120, 151, 178, 199, 231],
                                  [0, 0, 5, 3, 9, 0, 14, 31])
    rows["K3 prefill"] = flash_row(1, 256, 256, [0], [56])
    for name, r in rows.items():
        print(f"timing {name} {r['shape']}: device {r['ms']} ms, per call "
              f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library {r['library_ms']}")
    return rows


def decode_breakdown(torch, dev):
    """Profile decode steps of the full model at 8 slots: device time by
    kernel class, wall time, and the device's idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("smollm_360m", fused=True)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    cache = T.init_cache(cfg, 8, 512, device=dev)
    pos = torch.tensor([47, 63, 92, 120, 151, 178, 199, 231], dtype=torch.int32, device=dev)
    start = torch.zeros(8, dtype=torch.int32, device=dev)
    tok = torch.from_numpy(np.arange(8, dtype=np.int64)[:, None] + 100).to(dev)
    step = lambda: T.decode_step(params, cfg, cache, tok, pos, start, with_health=True)
    with torch.inference_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_plain = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n * 1e3
    by = {"K2 rowwise": 0.0, "K3 flash": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = e.self_device_time_total / n / 1e3
        k = e.key.lower()
        if "rowwise_kernel" in k:
            by["K2 rowwise"] += t
        elif "flash_kernel" in k:
            by["K3 flash"] += t
        elif any(w in k for w in ("gemm", "gemv", "cutlass", "nvjet", "xmma", "sm90")):
            by["matmul"] += t
        else:
            by["other"] += t
    busy = sum(by.values())
    # every decode step reads all layer weights and the head once
    weight_bytes = sum(w.numel() * w.element_size() for lay in params["layers"]
                       for w in lay.values()) + params["head"].numel() * 2
    print("decode step (8 slots, full width): wall %.3f ms (%.3f ms traced), device "
          "busy %.3f ms, idle share %.3f; %s; weights read %.1f MB, bound %.4f ms" % (
              wall_plain, wall, busy, 1 - busy / wall_plain,
              ", ".join(f"{k} {v:.3f} ms" for k, v in by.items()),
              weight_bytes / 1e6, weight_bytes / HBM_BYTES_PER_S * 1e3))
    return {"wall_ms": wall_plain, "busy_ms": busy, **by}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    # bf16 products reduce in f32, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    print(f"setup: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"setup: kernels built in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()) + ")")
    for n in secs:
        log = _build.ptxas_log(n)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
        print(f"setup: ptxas {n}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers, {spills} bytes of spill stores")

    div_err = phase_rowwise(torch, dev)
    flash_err = phase_flash(torch, dev)
    phase_model_small(torch, dev)
    path = phase_main(torch, dev)
    rows = phase_timing(torch, dev)
    decode_breakdown(torch, dev)

    def entry(name, source, replaces, launches, err, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err,
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        entry("K1 posit SRT datapath (inlined in K2 and K3)", csrc + "posit_srt.cuh",
              "src/repro/kernels/posit_div.py:433", path["rowwise"] + path["flash"], div_err,
              rows["K1"]),
        entry("K2 rowwise fused posit divide", csrc + "posit_fused_div.cu",
              "src/repro/kernels/posit_fused_div.py:149", path["rowwise"], div_err,
              rows["K2 decode"]),
        entry("K3 posit flash attention, dense", csrc + "posit_flash_attn.cu",
              "src/repro/kernels/posit_flash_attn.py:330", path["flash"], flash_err,
              rows["K3 decode"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
