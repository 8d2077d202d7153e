#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. setup    — the card's name and power limit, the kernels' parallel build.
2. K1 + K2  — the rowwise fused posit divide against its plain twin,
              bit-exact: the RMSNorm rows of decode (8x960), prefill
              (256x960) and training (2048x960), posit16 srt_r4_cs_of_fr
              on 2^20 random pairs plus the special values, posit8
              exhaustive, every one-word (format, variant) sampled.
3. K3       — flash attention against its plain twin at the main path's
              shapes (decode B=8, Sk=512; prefill P=128) and for every
              posit16 plan it is built for: max|diff| within FLASH_TOL,
              fully masked rows exactly 0.
   model    — the smoke config on the card (kernels) against the same
              weights on the CPU (plain twins, which the CPU tests hold
              against the reference): logits within LOGIT_ULPS bf16 ulps.
   K6-K8    — the training forward (K6) and the recompute backward (K7 dq,
              K8 dk/dv) against their twins at the training path's shapes
              (B=8, S=256, 15/5 heads, hd 64) for the default plan and at
              B=2 for every posit16 plan: o within FLASH_TOL, lse within
              LSE_TOL, gradients within BWD_TOL and the same bits on a
              second run; fully masked rows give zero gradients.
   train    — one train step of the smoke config on the card against the
              same f32 weights and batch on the CPU: loss within LOSS_RTOL,
              every gradient leaf within GRAD_REL_L2 relative L2.
4. main     — SmolLM-360M at full width (all 32 layers, random weights from
              a seed) served by ``ServeEngine`` (8 slots, max_seq 512): 16
              greedy requests, prompts of 16-200 tokens, 32 new tokens each.
              Launch counters are zeroed before and read after: K2 must run
              2L+1 times and K3 L times per forward.  Two requests must be
              bit-identical solo and batched.
   training — SmolLM-360M at full width trained by ``Trainer`` for 4 steps
              (global batch 8 x 256, lr 1e-3, warmup 1, remat "full", seed
              0): finite losses, the last below the first, and per step K6
              2L (forward and recompute), K7 L, K8 L and K2 4L+1 launches.
              One more step is profiled: device busy and idle share.
5. timing   — each kernel, its plain twin and a library yardstick at the
              main paths' shapes (the kernel's device time from
              torch.profiler; per-call times from CUDA events), and one
              full-width decode step broken down by kernel class.  A
              profiler session that shows none of the kernels it traced is
              taken again, twice at most; where none shows them, the device
              time is the CUDA events' and the busy share "not measured".

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
# K6's lse = m + log l against its twin (the reference's residual bound)
LSE_TOL = 1e-5
# K7/K8 against their twin: p is a posit16 quantization of e, so a one-ulp
# change in e can move it one posit16 step (the reference's bound between
# its own two backward backends)
BWD_TOL = 5e-3
# smoke train step, card against CPU: the CPU tests' bounds against the
# reference (bf16 products and posit16 roundings fall at other places)
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 2e-2
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

    # the main paths' shapes: a decode step's, a prefill's and a training
    # step's (8 x 256 tokens) RMSNorm rows
    for R in (8, 256, 2048):
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


def training_inputs(torch, dev, B, S, seed, H=15, KV=5, hd=64):
    """q and dO in f32 (q holds bf16 values, as the model gives them), k/v
    in bf16: the training path's attention operands."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(torch.bfloat16).float().to(dev)
    k = torch.randn(B, S, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, S, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    co = torch.randn(B, S, H, hd, generator=g).to(dev)
    return q, k, v, co


def backward_args(F, co, o, m, l, q, k, v):
    return (q, k, v, co, m, l, F._row_sums(co, o), True, 0, 0, 1.0 / math.sqrt(q.shape[-1]))


def phase_flash_train(torch, dev):
    """K6, K7 and K8 against their twins: the default plan at the training
    path's shapes (B=8, S=256), every posit16 plan at B=2, S=256."""
    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import posit_flash_attn as F
    from repro_torch.kernels.posit_div import KERNEL_VARIANTS

    worst = {"K6": 0.0, "lse": 0.0, "K7": 0.0, "K8": 0.0}

    def compare(variant, q, k, v, co):
        where = f"{variant} B={q.shape[0]}"
        o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, True, variant=variant)
        po, pm, pl = F.posit_flash_attention_fwd_plain(POSIT16, q, k, v, True,
                                                       variant=variant)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o).all()), f"K6 {where}: non-finite output")
        err = max_abs_err(o, po)
        worst["K6"] = max(worst["K6"], err)
        lse_err = float((m + torch.log(l) - pm - torch.log(pl)).abs().max())
        worst["lse"] = max(worst["lse"], lse_err)
        check(err <= FLASH_TOL, f"K6 {where}: max|o diff| {err} > {FLASH_TOL}")
        check(lse_err <= LSE_TOL, f"K6 {where}: max|lse diff| {lse_err} > {LSE_TOL}")
        plan = F.one_word_plan(POSIT16, variant)
        args = backward_args(F, co, o, m, l, q, k, v)
        runs = [(F.flash_backward_dq(POSIT16, plan, *args),
                 *F.flash_backward_dkv(POSIT16, plan, *args)) for _ in range(2)]
        twin = F.flash_backward_plain(POSIT16, q, k.float(), v.float(), o, co, m, l, True,
                                      variant=variant)
        torch.cuda.synchronize()
        for name, got, again, want in zip(("dq", "dk", "dv"), runs[0], runs[1], twin):
            kern = "K7" if name == "dq" else "K8"
            check(bool(torch.isfinite(got).all()), f"{kern} {where}: non-finite {name}")
            check(torch.equal(got, again), f"{kern} {where}: {name} differs run to run")
            err = max_abs_err(got, want)
            worst[kern] = max(worst[kern], err)
            check(err <= BWD_TOL, f"{kern} {where}: max|{name} diff| {err} > {BWD_TOL}")

    # the training path's shapes and plan: B=8 sequences of 256, 15/5 heads
    compare("srt_r4_cs_of_fr", *training_inputs(torch, dev, 8, 256, 22))
    q, k, v, co = training_inputs(torch, dev, 2, 256, 21)
    for variant in KERNEL_VARIANTS:
        compare(variant, q, k, v, co)
    # every row fully masked (q_offset = -S puts each query before every key)
    S = q.shape[1]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.posit_flash_attention_ste(16, "srt_r4_cs_of_fr", True, 0, -S, 0.0, *leaves)
    grads = torch.autograd.grad((out * co).sum(), leaves)
    torch.cuda.synchronize()
    check(bool((out == 0).all()), "K6: fully masked rows are not 0")
    for name, gr in zip(("dq", "dk", "dv"), grads):
        check(bool(torch.isfinite(gr).all()) and bool((gr == 0).all()),
              f"fully masked rows: {name} is not finite zeros")
    print(f"K6: within {FLASH_TOL} (o, max|diff| {worst['K6']:.3g}) and {LSE_TOL} (lse, "
          f"{worst['lse']:.3g}) of its twin; K7 max|dq diff| {worst['K7']:.3g}, K8 "
          f"max|dk, dv diff| {worst['K8']:.3g} (within {BWD_TOL}), bit-identical run to "
          f"run, at B=8 x 256 (default plan) and B=2 x 256 ({len(KERNEL_VARIANTS)} "
          "posit16 plans); fully masked rows give zero gradients")
    return worst


def phase_train_small(torch, dev):
    """One train step of the smoke config on the card against the CPU path."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.tree import tree_items, tree_leaves, tree_map
    from repro_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        loss_and_grads,
        make_train_step,
    )

    cfg = get_config("smollm_360m", smoke=True)
    tc = TrainConfig(steps=4, lr=1e-3, warmup=1)
    cpu = init_train_state(cfg, tc, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    batch = SyntheticLMDataset(DataConfig(2, 64), cfg).batch_at(0)
    runs = {}
    for name, state, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        b = {n: torch.from_numpy(np.asarray(x)).to(d) for n, x in batch.items()}
        (loss, _), grads = loss_and_grads(state["params"], cfg, b)
        new_state, metrics = make_train_step(cfg, tc)(state, b)
        runs[name] = (float(loss), grads, float(metrics["loss"]), new_state)
    c_loss, c_grads, _, _ = runs["cpu"]
    g_loss, g_grads, g_step_loss, g_state = runs["gpu"]
    rel = abs(g_loss - c_loss) / abs(c_loss)
    check(math.isfinite(g_loss) and rel <= LOSS_RTOL,
          f"smoke train: card loss {g_loss} vs CPU {c_loss} (rel {rel:.3g} > {LOSS_RTOL})")
    check(math.isfinite(g_step_loss), "smoke train: the train step's loss is not finite")
    errs = {}
    for (key, g), c in zip(tree_items(g_grads), tree_leaves(c_grads)):
        g = g.cpu()
        check(bool(torch.isfinite(g).all()), f"smoke train: non-finite gradient {key}")
        errs[key] = float(torch.linalg.vector_norm(g - c) / torch.linalg.vector_norm(c))
    worst_key = max(errs, key=errs.get)
    worst = errs[worst_key]
    check(worst <= GRAD_REL_L2,
          f"smoke train: gradient {worst_key} rel L2 {worst:.3g} > {GRAD_REL_L2}")
    rest = max(v for k, v in errs.items() if k != "tok")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(g_state)),
          "smoke train: non-finite state after the step")
    print(f"train: smoke step on the card: loss {g_loss:.6f} vs CPU {c_loss:.6f} (rel "
          f"{rel:.3g}, bound {LOSS_RTOL}); worst gradient leaf {worst_key} rel L2 "
          f"{worst:.3g} (bound {GRAD_REL_L2}); worst leaf other than tok {rest:.3g}")


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


def phase_train_main(torch, dev):
    """SmolLM-360M at full width trained for 4 steps through K2, K6, K7, K8."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_flash_attn as F
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("smollm_360m")
    B, S, steps = 8, 256, 4
    tc = TrainConfig(steps=steps, lr=1e-3, warmup=1, log_every=1, seed=0)
    ds = SyntheticLMDataset(DataConfig(B, S, seed=0), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tc, ds, device=dev)
    counters = (ops.posit_div_fused_rowwise, F.posit_flash_attention,
                F.posit_flash_attention_fwd, F.flash_backward_dq, F.flash_backward_dkv)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k3, k6, k7, k8 = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    losses = [h["loss"] for h in res["history"]]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"training: losses {losses}")
    check(losses[-1] < losses[0], f"training: loss did not fall: {losses}")
    for name, got, per_step in (("K6", k6, 2 * L), ("K7", k7, L), ("K8", k8, L),
                                ("K2", k2, 4 * L + 1), ("K3", k3, 0)):
        check(got == per_step * steps,
              f"training: {name} launched {got} times, the path implies {per_step * steps}")
    secs = [h["sec"] for h in res["history"]]
    print(f"training: SmolLM-360M ({L} layers, f32 masters, remat full), {steps} steps "
          f"of {B}x{S} tokens in {wall:.2f} s; losses {[round(x, 4) for x in losses]}; "
          f"step wall times {[round(x, 3) for x in secs]} s; {B * S / min(secs):.1f} "
          f"tokens/s at the fastest step; launches K2 {k2} (4L+1 per step), K6 {k6} (2L), "
          f"K7 {k7} (L), K8 {k8} (L); peak device memory {peak / 2**30:.2f} GiB")

    # one more step under the profiler (not counted above)
    batch = {n: torch.from_numpy(x).to(dev) for n, x in ds.batch_at(steps).items()}

    def step():
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        float(metrics["loss"])

    times, traced = profiled(torch, step, ["flash_kernel", "flash_bwd"])
    by = by_class(times, (("K7 flash dq", "flash_bwd_dq_kernel"),
                          ("K8 flash dk/dv", "flash_bwd_dkv_kernel"),
                          ("K6 flash fwd", "flash_kernel"), ("K2 rowwise", "rowwise_kernel")))
    busy = sum(by.values()) if times else None
    if busy is None:
        print(f"training step (traced): wall {traced:.1f} ms; torch.profiler showed no "
              f"device records in {PROFILE_TRIES} tries: busy and idle share not measured")
    else:
        print("training step (traced): wall %.1f ms, device busy %.1f ms, idle share %.3f; "
              "%s" % (traced, busy, 1 - busy / traced,
                      ", ".join(f"{k} {v:.2f} ms" for k, v in by.items())))
    return {"rowwise": k2, "K6": k6, "K7": k7, "K8": k8, "losses": losses,
            "step_s": secs, "peak_bytes": peak, "busy_ms": busy, "traced_ms": traced}


# --------------------------------------------------------------- phase 5


PROFILE_TRIES = 3
MATMUL_NAMES = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "sm90")


def profiled(torch, fn, want):
    """Run ``fn()`` under torch.profiler; return ``({kernel: device ms}, wall
    ms)`` over the CUDA kernels the trace shows.  A trace that shows none of
    the kernels named in ``want`` is taken again, up to PROFILE_TRIES times:
    on the card a session has come back without the device records of
    kernels that did run.  The dict is empty when every try came back so."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        times, events = {}, 0
        for e in prof.key_averages():
            events += 1
            if str(getattr(e, "device_type", "")).endswith("CUDA") and e.self_device_time_total:
                times[e.key] = times.get(e.key, 0.0) + e.self_device_time_total / 1e3
        if any(w in k for k in times for w in want):
            return times, wall
        print(f"profiler: try {attempt + 1} of {PROFILE_TRIES} showed no {want} among "
              f"{len(times)} device kernels ({events} events)", file=sys.stderr)
    return {}, wall


def by_class(times, classes):
    """Sum ``times`` into the named classes (the first whose substring the
    kernel's name holds), then matmul and other."""
    by = dict.fromkeys([c for c, _ in classes] + ["matmul", "other"], 0.0)
    for key, t in times.items():
        k = key.lower()
        cls = next((c for c, sub in classes if sub in k), None)
        if cls is None:
            cls = "matmul" if any(w in k for w in MATMUL_NAMES) else "other"
        by[cls] += t
    return by


def device_kernel_ms(torch, fn, names, iters=20):
    """Device time per call of the CUDA kernels whose name holds one of
    ``names``, and where it comes from: torch.profiler, or, where no trace
    shows them, CUDA events around the calls (launch gaps included)."""
    for _ in range(3):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    times, _ = profiled(torch, calls, names)
    total = sum(t for k, t in times.items() if any(n in k for n in names))
    if total > 0:
        return total / iters, "torch.profiler"
    return cuda_time_ms(fn, iters), "CUDA events"


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
        dev_ms, src = device_kernel_ms(torch, call, ["rowwise_kernel"])
        bms, by = bound_ms(8 * R * C + 4 * R, div_ops(plan, R * C))
        return {"shape": [R, C], "ms": dev_ms, "ms_from": src,
                "call_ms": cuda_time_ms(call),
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
        dev_ms, src = device_kernel_ms(torch, call, ["flash_kernel"])
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
        return {"shape": [B, Sq, Sk, H, KV, hd], "ms": dev_ms, "ms_from": src,
                "call_ms": cuda_time_ms(call),
                "plain_ms": cuda_time_ms(lambda: posit_flash_attention_plain(
                    POSIT16, q, k, v, True, **kw), iters=3),
                "bound_ms": bms, "bound_by": by, "library_ms": cuda_time_ms(lib)}

    rows["K3 decode"] = flash_row(8, 1, 512, [47, 63, 92, 120, 151, 178, 199, 231],
                                  [0, 0, 5, 3, 9, 0, 14, 31])
    rows["K3 prefill"] = flash_row(1, 256, 256, [0], [56])
    rows.update(training_rows(torch, dev, plan))
    for name, r in rows.items():
        print(f"timing {name} {r['shape']}: device {r['ms']} ms ({r['ms_from']}), per call "
              f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library {r['library_ms']}")
    return rows


def training_rows(torch, dev, plan):
    """K6, K7 and K8 at the training path's shapes (B=8, S=256, causal)."""
    import torch.nn.functional as Fn

    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import posit_flash_attn as F

    B, S, H, KV, hd = 8, 256, 15, 5, 64
    q, k, v, co = training_inputs(torch, dev, B, S, 9)
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, True)
    args = backward_args(F, co, o, m, l, q, k, v)
    pairs = B * H * S * (S + 1) // 2            # attended (row, key) pairs
    qo = B * S * H * hd * 4                     # one f32 (B, S, H, hd) tensor
    kv = B * S * KV * hd * 2                    # one bf16 (B, S, KV, hd) tensor
    rowv = B * H * S * 4                        # one f32 (B*H, S) row vector
    # library yardsticks: SDPA forward, and SDPA backward for K7 and K8
    # together, on the same causal mask with f32 inputs
    qs, ks, vs = (t.float().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa = lambda: Fn.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                   enable_gqa=True)
    lib_fwd = cuda_time_ms(lambda: sdpa().detach())
    out = sdpa()
    gs = co.transpose(1, 2).contiguous()
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), gs,
                                                       retain_graph=True))
    plain_bwd = cuda_time_ms(lambda: F.flash_backward_plain(POSIT16, q, k, v, o, co, m, l,
                                                            True), iters=3)

    def row(call, names, nbytes, ops_, plain_ms, library_ms):
        dev_ms, src = device_kernel_ms(torch, call, names)
        bms, by = bound_ms(nbytes, ops_)
        return {"shape": [B, S, S, H, KV, hd], "ms": dev_ms, "ms_from": src,
                "call_ms": cuda_time_ms(call),
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": library_ms}

    rows = {
        "K6": row(lambda: F.posit_flash_attention_fwd(POSIT16, q, k, v, True),
                  ["flash_kernel"], 2 * qo + 2 * kv + 2 * rowv,
                  pairs * 4 * hd + div_ops(plan, B * S * H * hd),
                  cuda_time_ms(lambda: F.posit_flash_attention_fwd_plain(
                      POSIT16, q, k, v, True), iters=3), lib_fwd),
        "K7": row(lambda: F.flash_backward_dq(POSIT16, plan, *args),
                  ["flash_bwd_dq_kernel"], 3 * qo + 2 * kv + 3 * rowv,
                  pairs * 6 * hd + div_ops(plan, pairs), plain_bwd, lib_bwd),
        "K8": row(lambda: F.flash_backward_dkv(POSIT16, plan, *args),
                  ["flash_bwd_dkv_kernel"], 2 * qo + 2 * kv + 3 * rowv + 2 * 2 * kv,
                  pairs * 8 * hd + div_ops(plan, pairs), plain_bwd, lib_bwd),
    }
    return rows


def decode_breakdown(torch, dev):
    """Profile decode steps of the full model at 8 slots: device time by
    kernel class, wall time, and the device's idle share."""
    import numpy as np

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

        def steps():
            for _ in range(n):
                step()

        times, wall = profiled(torch, steps, ["flash_kernel", "rowwise_kernel"])
    by = by_class({k: t / n for k, t in times.items()},
                  (("K2 rowwise", "rowwise_kernel"), ("K3 flash", "flash_kernel")))
    busy = sum(by.values()) if times else None
    # every decode step reads all layer weights and the head once
    weight_bytes = sum(w.numel() * w.element_size() for lay in params["layers"]
                       for w in lay.values()) + params["head"].numel() * 2
    if busy is None:
        device = (f"torch.profiler showed no device records in {PROFILE_TRIES} tries: "
                  "busy and idle share not measured")
    else:
        device = "device busy %.3f ms, idle share %.3f; %s" % (
            busy, 1 - busy / wall_plain, ", ".join(f"{k} {v:.3f} ms" for k, v in by.items()))
    print("decode step (8 slots, full width): wall %.3f ms (%.3f ms traced), %s; weights "
          "read %.1f MB, bound %.4f ms" % (wall_plain, wall / n, device, weight_bytes / 1e6,
                                           weight_bytes / HBM_BYTES_PER_S * 1e3))
    return {"wall_ms": wall_plain, "busy_ms": busy, **by}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import resolve_device

    # the port's entry points resolve their device here, which keeps bf16
    # products reducing in f32 (as the reference's do) and TF32 off
    dev = resolve_device("cuda:0")
    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
          and not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          "resolving a CUDA device left reduced-precision matmuls on")
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
    train_err = phase_flash_train(torch, dev)
    phase_train_small(torch, dev)
    path = phase_main(torch, dev)
    train = phase_train_main(torch, dev)
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
        entry("K1 posit SRT datapath (inlined in K2, K3, K6, K7, K8)",
              csrc + "posit_srt.cuh", "src/repro/kernels/posit_div.py:433",
              path["rowwise"] + path["flash"] + train["rowwise"] + train["K6"] + train["K7"]
              + train["K8"], div_err, rows["K1"]),
        entry("K2 rowwise fused posit divide", csrc + "posit_fused_div.cu",
              "src/repro/kernels/posit_fused_div.py:149", path["rowwise"] + train["rowwise"],
              div_err, rows["K2 decode"]),
        entry("K3 posit flash attention, dense", csrc + "posit_flash_attn.cu",
              "src/repro/kernels/posit_flash_attn.py:330", path["flash"], flash_err,
              rows["K3 decode"]),
        entry("K6 posit flash attention forward saving (m, l)", csrc + "posit_flash_attn.cu",
              "src/repro/kernels/posit_flash_attn.py:330", train["K6"], train_err["K6"],
              rows["K6"]),
        entry("K7 posit flash attention backward, dq", csrc + "posit_flash_bwd.cu",
              "src/repro/kernels/posit_flash_attn.py:601", train["K7"], train_err["K7"],
              rows["K7"]),
        entry("K8 posit flash attention backward, dk and dv", csrc + "posit_flash_bwd.cu",
              "src/repro/kernels/posit_flash_attn.py:626", train["K8"], train_err["K8"],
              rows["K8"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
