#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. setup    — the card's name and power limit, the kernels' parallel build
              (16 libraries: the flash sources once per posit format,
              posit64's in three parts), each library's seconds and its
              ptxas registers and spills per format, each posit64 flash
              and softmax kernel's.
2. K1 + K2  — the rowwise fused posit divide against its plain twin,
              bit-exact: the RMSNorm rows of decode (8x960), prefill
              (256x960) and training (2048x960), OLMoE's RMSNorm (8x2048,
              1x2048) and router-norm rows (8x8, 1x8 over their
              fixed-order sum), posit16 srt_r4_cs_of_fr
              on 2^20 random pairs plus the special values, posit8
              exhaustive, every (format, variant) sampled, the two-word
              plans (posit32 srt_r4_scaled, posit64) at 8 x 960 and
              256 x 960.
   The flash and softmax phases hold posit16, posit32 and posit64 within
   their bounds and posit8 by its patterns (``gate``: at most one posit8
   step from the twin, in at most POSIT8_FLIP_SHARE of the outputs), and
   the plans of each format (nine; posit64 eight) to one answer, bit for
   bit.
3. K3       — flash attention against its plain twin: every posit16,
              posit8, posit32 and posit64 plan at decode (B=8, Sk=512,
              kv_start 0 and above 0) and prefill (P=128, kv_start 40);
              MODEL_PLANS (srt_r4_cs_of_fr in every format, posit32
              srt_r4_scaled, posit64 nrd) at prefill P=256 and OLMoE's
              decode at head_dim 128, 16/16 heads; fully masked rows
              exactly 0.
   K4       — paged decode attention (B=8, max_seq 512 in pages of 16,
              a shuffled table with shared pages and a parked all-zero
              row, kv_start 0 and above 0, MODEL_PLANS, at SmolLM's 15/5
              heads of 64 and OLMoE's 16/16 of 128; every posit16,
              posit8, posit32 and posit64 plan at B=4): the same bits as
              K3 on the gathered dense cache, the twin's gate, fully
              masked rows exactly 0.
   K5       — packed prefill attention on every pack the paged phase can
              form (1, 2, 4 or 8 segments of width 16-256, right-padded,
              dummies first) and on five left-padded packs, with a shared
              prefix, MODEL_PLANS (every posit8, posit32 and posit64 plan
              on two packs): every segment the same bits as a solo K3
              prefill of it, the twin's gate.
   K3 suffix — 1- and 17-token suffix prefills (q_offset, the prefix's
              keys cached) at SmolLM's 15/5 x 64 and OLMoE's 16/16 x 128
              heads, MODEL_PLANS: the bits of the whole prefill's rows (every
              prefill takes the tile loop, whatever its length).
   K9       — the fused posit softmax against its twin at the router's
              shapes (8 x 64, 1 x 64), 4096 x 64 and 37 x 1000,
              MODEL_PLANS (every posit16, posit8, posit32 and posit64 plan
              on the last), with -1e30, equal-value and NaN rows: bit-identical
              (the one-lane left-to-right row sum is the twin's order),
              the NaN row alone NaN.
   K11      — the pattern divide: posit8 every pair (9 variants) the
              twin's and the pure-Python goldens' bits; posit10 Table III
              for every variant and its 2^20-pair space the same under all 9;
              the whole posit16 pair space (2^32 pairs, chunks of 2^28 made
              on the card) the same under all 9 (a difference prints the
              first pairs with the goldens' answers), and K10 on the pairs'
              f32 images the f32 images of their quotients; 2^20 random posit16
              and posit32 pairs the twin's bits for every plan, posit32's
              zero, NaR, +-minpos, +-maxpos among them, the goldens' on 4096.
   K12      — the casts: every posit8/16 pattern and 2^20 posit32 ones
              dequantized (int64 lanes, int32 words, packed uint16 and
              uint8), 2^26 random f32 bit patterns and the specials (+-0,
              inf, NaN, every subnormal class, +-2^e and neighbours)
              quantized, the twin's bits; quantize o dequantize the
              identity on every posit8/16 pattern; the round kernel (the
              posit-KV path's K and V in one launch) on every bf16 bit
              pattern in bf16 and as f32, and on the f32 samples: the bits
              of quantize -> dequantize -> .to(dtype) on the card.
   K10      — the elementwise fused divide bit-identical to K12 -> K11 ->
              K12 and to its twin for every one-word (format, variant), on
              the reference benchmark's 64 x 1024 uniform(0.1, 10) and 2^20
              random f32 pairs with the specials; 1 launch against 4.
              Every f32 bit pattern (2^32) as x / 1.0: at posit8, posit16
              and posit32 the bits of K12's quantize then dequantize (and
              of K12's round kernel), at
              posit64 the rule ``identity64`` states (held against the
              twin on a CPU sample first).
   two-word — K11 at posit32 srt_r4_scaled on 2^24 random pattern pairs
              and every pair of the special patterns: the twin's bits, the
              goldens' on 10^4 of them, srt_r4_cs_of_fr's on all; K10 at
              the eight posit64 variants on 2^20 random f32 pairs and every
              pair of the edge operands: the twin's bits and one answer,
              the goldens' on 2^11 (normal range), no normal-range
              quotient more than 1 f32 ulp from IEEE a / b.
   grid     — K2 at 262144 rows of 960 (the twin's bits), K3 at B*H = 65536
              and K7/K8 at B*KV = 65536 (within their bounds), past the
              65535 that gridDim.y took.
   model    — the smoke configs (SmolLM, OLMoE and RecurrentGemma) on the
              card (kernels) against the same weights on the CPU (plain
              twins, which the CPU tests hold against the reference):
              logits within LOGIT_ULPS bf16 ulps (RecurrentGemma's
              whole-sequence forward past its 64-key window too); SmolLM at
              posit64, posit32 and posit8 too.
   K6-K8    — the training forward (K6) and the recompute backward (K7 dq,
              K8 dk/dv) against their twins at the training path's shapes
              (B=8, S=256, 15/5 heads, hd 64) for MODEL_PLANS, at B=2 for
              every posit16, posit8, posit32 and posit64 plan and, posit64,
              at B*KV = 65536: o the twin's gate, lse within LSE_TOL,
              gradients within BWD_TOL (posit8: ``gate_grad``) and the same
              bits on a second run; fully masked rows give zero gradients.
   f32 K/V  — K3 (decode, prefill), K4, K5 and K6-K8 on f32 K/V at posit16
              and posit64 nrd: on f32 values bf16 holds, the bf16 call's
              bits; on values it cannot hold, the twins' bounds.
   train    — one train step of the smoke config on the card against the
              same f32 weights and batch on the CPU, posit16, posit64,
              posit32 and posit8, and OLMoE's smoke config (the moe block,
              K9's and K2's straight-through backwards): loss within
              LOSS_RTOL, every gradient leaf within GRAD_REL_L2 relative L2.
4. main     — SmolLM-360M at full width (all 32 layers, random weights from
              a seed) served by ``ServeEngine`` (8 slots, max_seq 512): 16
              greedy requests, prompts of 16-200 tokens, 32 new tokens each.
              Launch counters are zeroed before and read after: K2 must run
              2L+1 times and K3 L times per forward.  Two requests must be
              bit-identical solo and batched.
   posit64  — the same model, weights and mix with div_format="posit64"
              (every RMSNorm divide on K2 and every o / l on K3 at the
              two-word frame): the same launch counts, solo = batched,
              every request its 32 tokens (the engine's health probe
              faults a non-finite logit); printed: the requests whose
              tokens differ from the posit16 run's.
   posit32, posit8 — the same at div_format="posit32" and "posit8" (K2,
              K3 at those formats): the same launch counts, solo = batched;
              printed: the requests whose tokens differ from posit16's.
   paged    — the same model and weights served with kv_layout="paged"
              (pages of 16) and packed_prefill=True: the 16 requests plus 8
              that share one 128-token prefix and add 16-64 tokens.  Per
              decode step L K4 launches (no K3), per pack L K5, per
              prefix-shared solo admission L K3; prefix hit rate above 0;
              every pack of a shape the K5 phase held.  Its tokens are
              compared with a dense solo-admission run of the same
              requests (where they differ: the first such token,
              the logits gap in bf16 ulps, whether the attention kernel and
              the products keep their bits across the two layouts' shapes).
   paged posit64 — the same with div_format="posit64" (K4, K5, K3 and K2
              on the two-word frame): the same launch counts, every pack a
              shape the K5 phase held at posit64, tokens bit-identical to
              the dense run of the same requests and to the posit64 phase's
              run of the main mix.  Then posit64 nrd (the paper's NRD
              baseline, 63 non-restoring iterations): the posit16 paged
              run's launch counts and the posit64 default plan's paged
              tokens, bit for bit.  Then the same at posit8 and posit32,
              whose launch counts must also equal the posit16 paged run's.
   posit-KV — the same model and weights, cut to 16 of its 32 layers,
              with kv_cache_format="posit16" (against the cut's bf16 cache):
              the main mix from dense slots, the paged mix from the paged
              pool (pages of 16, packed); then "posit8" from dense slots.
              Every K/V row is rounded through K12: per forward step L
              launches of its round kernel (K and V of a layer in one) and
              no quantize or dequantize, on top of the unchanged K2-K5
              counts; every rounding, in every layer of every
              prefill, packed prefill and decode step, the bits of K12's
              plain twin on the same rows; logits finite (the engine's
              health probe faults none); paged = dense tokens with no
              prefix hit; requests 0 and 7 solo = batched; every cached row
              a fixed point of K12's rounding and of the twin's; posit8
              moves some entries.  Printed: the share of entries each
              format moved, the requests whose tokens differ from the bf16
              cache's.
   stream   — the live session on the same model and weights, from dense
              slots (the main phase's engine and mix): 8 requests submitted
              and 8 more from the consuming loop at request 0's first 8
              tokens (the main phase's tokens; one FinishEvent per request,
              its tokens its TokenEvents'; K2 2L+1, K3 L a forward step, L of
              them through the tile loop a prefill), printing tokens/s and
              TTFT and per-token latency p50/p99; the mix abandoned after
              its 100th event, snapshot to host memory and restored on a
              new engine (the live run's events, each once; the snapshot's
              bytes, its and the restore's wall time); the first 4 requests
              sampled at temperature 0.8, restored after event 40 (the
              uninterrupted sampled run's tokens); request 3's K/V rows NaN
              after event 40 (it finishes fault with a prefix of its
              tokens, the others keep theirs, faults 1); request 5 with a
              60 ms deadline on a clock the consumer moves 1 ms an event
              (deadline with a prefix, the others unchanged); and
              ``stream_async`` (serve_stream's events in order).
   stream paged — the paged phase's engine and mix (pages of 16, packed):
              12 requests submitted, 12 more at request 0's first tokens,
              abandoned after event 100, snapshot and restored: the paged
              phase's tokens, exact K2-K5 launches, every pack a shape the
              K5 phase held, a prefix hit, no page mapped after the drain.
   launcher — ``python -m repro_torch.launch.serve --arch smollm-360m
              --stream --kv-layout paged --packed-prefill --shared-prefix 64
              --requests 8 --batch 4 --max-new 16`` in a subprocess: exit 0,
              a ``# slo:`` line and a ``# paged:`` line with prefix hits.
   training — SmolLM-360M at full width trained by ``Trainer`` for 4 steps
              (global batch 8 x 256, lr 1e-3, warmup 1, remat "full", seed
              0): finite losses, the last below the first, and per step K6
              2L (forward and recompute), K7 L, K8 L and K2 4L+1 launches.
              One more step is profiled: device busy and idle share.  Then
              the same at div_format="posit64" (K2, K6-K8 at W = 2), then
              posit64 srt_r2_cs (4 steps, not profiled: every step's loss
              and every parameter after it the default plan's bits, else
              the first step and tensor that differ are named), and at
              "posit32".
   moe      — (after the SmolLM state is released) OLMoE-1B-7B at full
              width and 8 of its 16 layers (random weights from a seed;
              every OLMoE serving phase below at that depth) served with
              batch-axis packed admission (8 slots, max_seq 512): 16 greedy
              requests, prompts of 16-120 tokens, 16 new tokens each.  Per
              forward step (each scan step of a prefill, each decode step)
              L K9, L K3 and 3L+1 K2 launches; requests 0 and 7 the same
              tokens alone on a solo-admission engine (else the script
              names the bf16 product that lost a row's bits and fails).
              Then the mix's first 4 requests at div_format="posit64" (K9,
              K2 and K3 at hd 128 on the two-word frame), its first 1 at
              posit64 srt_r4_cs (the default plan's tokens, bit for bit)
              and the first 4 at "posit32": the same checks; printed: the
              requests whose tokens leave posit16's.
   moe paged — the same model and weights served from the paged pool (pages
              of 16, packed admission: batch-axis packs of right-padded rows
              at start 0, ``prefill_batch_ragged``): the mix's first 8
              requests and 4 that share a 128-token prefix.  Per forward
              step L K9 and 3L+1 K2 launches, L K3 per scan step (into the
              dense mini cache), L K4 per decode step, no K5; prefix hits
              and packs; every request's tokens those of a dense-slot
              packed run, bit for bit (else ``moe_difference`` and a fail).
   training moe — (after OLMoE's serving state is released) OLMoE-1B-7B at
              full width and 4 of its 16 layers trained by ``Trainer`` for
              4 steps (8 x 256, f32 masters, remat "full", lr 1e-3, warmup
              1, seed 0): finite losses, the last below the first, per step
              K2 6L+1, K6 2L, K9 2L, K7 L, K8 L launches and no K3; one
              more step traced (busy time, idle share, the expert products
              as their own class); peak device memory.
   hybrid   — (after OLMoE's training state is released) RecurrentGemma-2B
              at full width and 13 of its 26 layers (every third local
              attention over 2048 keys, 10/1 heads of 256; random weights
              from seed 0) served from dense slots with batch-axis packed
              admission: the main mix (16 requests, 32 new each, 8 slots,
              max_seq 512), 8 submitted and 8 more at request 0's tokens
              (mid-flight).  Per forward step (a scan step, a decode step)
              exactly 2L+1 = 27 K2 launches and no flash launch (the ring
              buffer's softmax is float, as the reference's); the shortest
              request of each wave (the second submitted mid-flight) the
              same tokens alone on a solo-admission engine as packed; K2
              at 8 x 2560 the bits of its twin.
   hybrid wrap — the same weights at 3 of the 26 layers (one attention
              layer), max_seq 2304: a 2040-token prompt decodes 48 tokens
              past the 2048-key window (its ring wraps from the first
              decode step): the same tokens alone and beside a short
              request.
   hybrid forward — the whole-sequence forward on 1 x 4096 tokens: exactly
              8 K6 launches (one an attention layer, window 2048) and 2L+1
              K2, finite states; K6 and K3 prefill at 10/1 x 256 with the
              window against their twins at posit16, posit32, posit64
              (FLASH_TOL) and posit8 (its patterns), bf16 K/V and (posit16,
              posit64) f32, the division stage bit-exact on the kernel's
              own acc and l (q = 0 and integer V make both exact); then a
              decode step's breakdown and the K6 / K3 timing rows at that
              shape (SDPA with the window as a boolean mask).
   training hybrid — (after the hybrid serving state is released) K7 and
              K8 at 10/1 x 256 with the 2048-key window (1 x 2560) against
              their twins at posit16, posit32, posit64 (BWD_TOL) and posit8
              (its gate), bf16 K/V and (posit16, posit64) f32; then
              RecurrentGemma-2B at full width and 6 of its 26 layers (4
              RG-LRU, 2 local attention) trained by ``Trainer`` for 4
              steps of 1 x 4096 (f32 masters, remat "full", lr 1e-3,
              warmup 1, seed 0): falling finite losses, exactly K6 4, K7 2,
              K8 2, K2 4L+1 = 25 a step and no K3, K4, K5 or K9; one more
              step traced (busy time, idle share, kernel classes); 2 steps
              at remat "dots" from the same state, every loss and
              parameter the "full" run's bits; 2 steps with
              grad_compress_format="posit16", one K12 round launch a
              gradient leaf, step 1's rounded gradients the twin's bits;
              each run's peak device memory; the K7 / K8 timing rows at
              1 x 4096 (SDPA's backward with the window as a boolean mask).
5. timing   — each kernel, its plain twin and a library yardstick at the
              main paths' shapes (the kernel's device time from
              torch.profiler, as the yardstick's for K9; per-call times from
              CUDA events; K10-K12 also at a 2^28 chunk, K12's round kernel
              on a decode step's K and V and on 2^27 + 2^27), and one
              full-width decode step, SmolLM dense (bf16 and posit16 KV
              cache, posit64 division) and paged (posit16, posit64), OLMoE
              dense (posit16, posit64) and paged (posit16) and
              RecurrentGemma dense (posit16), broken down by kernel class; K6-K8 at OLMoE's
              training shape (16/16 heads of 128) and K9 at its 2048 router
              rows; K2-K9 (K4 decode, K5 on the paged
              phase's most frequent pack, K6-K8 at the training shape, K9
              at 8 x 64 and 4096 x 64) at posit64 and K3-K9 at posit32 (K3
              at posit8 too), K3 prefill and K4-K8 at posit64 nrd, K10 at
              posit64 and K11 at posit32 srt_r4_scaled beside their posit16
              rows; the posit8 flips'
              share against the twins; the plan table: K2, K3 prefill, K5,
              K6-K8 and K9 at every plan of posit16, posit32 and posit64
              (CUDA events) beside each plan's operation bound and the
              paper's hardware model of its divider.  A
              profiler session that shows none of the kernels it traced is
              taken again, twice at most; where none shows them, the device
              time is the CUDA events' and the busy share "not measured".

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.

    python3 chip_smoke.py --time-kernels [--src DIR] [--only K8,K9]

only builds the package under ``DIR`` (default: this checkout's ``src``),
every library at once, and prints each library's build seconds and ptxas
report, the static SASS of some libraries' kernels (opcode counts and a
digest), and the device times of K2-K12 and of the posit-KV rounding
(kernels a parent checkout of the port has too), and, with K3 or K4, a
digest of each decode output's bits on fixed inputs (``decode_digests``),
with K3, K5 or K6 of the tile loop's (``tile_digests``), with K7 or K8 of
the backward's dq, dk and dv at head_dim 64 and 128 (``backward_digests``),
with K11 or K12 of each division, cast and rounding output's
(``division_digests``): run it on a parent checkout and on this one in
turns (parent, change, change, parent) in one call, after any edit to a
kernel source or to ``posit_srt.cuh``.  ``--only`` (any of K2, K3, K4,
K5, K6, K7, K8, K9, K10, K11, K12) builds just those kernels' libraries
and times just their rows: an A/B of one kernel's design variants, each a
copy of ``src`` with the kernel source changed.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

T_START = time.perf_counter()
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
DEFAULT_VARIANT = "srt_r4_cs_of_fr"   # NumericsConfig's default plan
MOE_HEADS = (16, 16, 128)   # OLMoE-1B-7B: heads, kv heads, head_dim
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# The operations model below counts 32-bit instructions, so it is bounded
# at the rate an H100 SXM dispatches them: 4 schedulers x 32 lanes a clock on
# each of 132 SMs at 1.98 GHz, 33.45e12 a second, whatever the mix (67e12,
# the f32 FMA's flop rate, counts two flops per instruction).  The INT32
# pipe alone takes half that, 64 lanes a clock per SM (16.7e12/s; CUDA C
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0): a bound for a datapath of integer instructions only.
INSTR_PER_S = 4 * 32 * 132 * 1.98e9
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
# 32-bit integer operations of the posit datapath per element (a static
# model of posit_srt.cuh), bounded at the instruction rate: DIV_OPS_FIXED
# per pattern word for quantize, decode, encode and dequantize (posit64's
# patterns are two words), and per iteration of divide_fields' recurrence
# (div_iteration_ops) a count taken from its code, W the residual's words
# (a shift, add, select or logic op costs one instruction per word; a
# three-input logic op is one LOP3 per word) and Q the quotient's:
#   non-redundant (nrd, srt_r2): the shift W, the sign test (nrd 2) or the
#     estimate and its compares (7), the addend select 2W and carry-in 1,
#     the two adds 2W;
#   carry-save (_cs): both shifts 2W, the estimate (an add of the two top
#     words) and its compares (radix 2 9, radix 4 14), the addend select
#     (radix 2 2W, radix 4 4W) and carry-in 1, XOR3 W, the majority W, its
#     shift W and the carry-in OR 1;
#   the quotient: plain accumulation 4Q, on-the-fly conversion (_of) 10Q.
# So at W = Q = 1 a carry-save radix-2 step costs 17 + quotient where a
# non-redundant one costs 12: on a CUDA core the redundant residual costs
# more per iteration, where in hardware it is what makes an iteration short.
DIV_OPS_FIXED = 160


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


def div_iteration_ops(plan) -> int:
    """32-bit operations of one iteration of ``plan``'s recurrence (the
    model above)."""
    W, Q = plan.words, plan.qwords
    if plan.redundant:
        step = 2 * W + (9 if plan.radix == 2 else 14) + (2 if plan.radix == 2 else 4) * W \
            + 1 + 3 * W + 1
    else:
        step = W + (2 if plan.nonrestoring else 7) + 2 * W + 1 + 2 * W
    return step + (10 if plan.otf else 4) * Q


def div_ops(plan, elements: int) -> int:
    pattern_words = 2 if plan.n > 32 else 1
    return elements * (DIV_OPS_FIXED * pattern_words
                       + div_iteration_ops(plan) * plan.iterations)


def bound_ms(nbytes: float, ops: float, tensor_ops: float = 0.0):
    """The least time for the work: the larger of the bytes over the memory
    rate, the operations over the instruction rate and the products' flops
    over the TF32 tensor-core rate (a product bounds at that rate whatever
    unit a kernel runs it on)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(ops / INSTR_PER_S, tensor_ops / TF32_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tensors_of(tree):
    """The tensors of a nested dict / list of tensors (a model's parameters:
    the hybrid family nests each recurrent layer's RG-LRU under ``rec``)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return [tree]


def tree_to(tree, dev):
    """A nested dict / list of tensors with every tensor moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def bits(t):
    import torch

    return t.contiguous().view(torch.int32)


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes: two runs
    (of this tree and of a parent's) print the same digest exactly when
    their outputs have the same bits."""
    import torch

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def max_abs_err(k, p) -> float:
    """max|k - p| over elements whose bits differ (a NaN against a number
    counts as inf); 0.0 when the two are bit-identical."""
    import torch

    differ = bits(k) != bits(p)
    if not bool(differ.any()):
        return 0.0
    d = (k[differ] - p[differ]).abs()
    return float(torch.nan_to_num(d, nan=math.inf).max())


# posit8 (es = 2) keeps at most 3 fraction bits: one f32 ulp between a
# kernel and its twin (expf against torch.exp, FMA contraction, the order of
# a sum) moves a quotient that sits at a rounding boundary a whole posit8
# step (12.5% near 1).  So posit8 flash outputs are held by their patterns:
# at most one step from the twin's, in at most POSIT8_FLIP_SHARE of the
# elements; posit8 gradients within BWD_TOL of the twin's in all but that
# share and within POSIT8_BWD_TOL everywhere (one posit8 step of one p, at
# most 2^-4, times the |dO|, |dp - D| and |q|, |k| it meets).  The posit16,
# posit32 and posit64 bounds stay as they are.
POSIT8_FLIP_SHARE = 0.01
POSIT8_BWD_TOL = 0.5
NEW_FORMATS = (8, 32)       # served and trained at full width beside posit16 and posit64
# the formats the kernel phases hold at every plan (posit64: its eight)
PLAN_FORMATS = (16, 8, 32, 64)
# the (format, plan) pairs the kernel phases hold at the main paths' shapes
MODEL_PLANS = ((16, DEFAULT_VARIANT), (64, DEFAULT_VARIANT), (8, DEFAULT_VARIANT),
               (32, DEFAULT_VARIANT), (32, "srt_r4_scaled"), (64, "nrd"))


def plan_variants(n: int):
    """The Table IV variants planned for posit``n`` (nine; posit64 eight)."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels.posit_div import planned_pairs

    return [v for _, v, _ in planned_pairs((PositFormat(n),))]
FLIPS8 = collections.defaultdict(lambda: [0, 0])   # kernel -> [flips, elements]


def posit8_steps(a, b):
    """Posit8 steps between two tensors of posit8 values."""
    import torch

    from repro_torch.core.posit import POSIT8, float_to_posit

    pa, pb = (float_to_posit(POSIT8, t.float()) for t in (a, b))
    sa = torch.where(pa >= 128, pa - 256, pa)
    sb = torch.where(pb >= 128, pb - 256, pb)
    return (sa - sb).abs()


def gate(kernel, name, fmt, got, want, tol=None):
    """A kernel's output against its twin's: within ``tol`` (FLASH_TOL by
    default) at posit16, posit32 and posit64, returning max|diff|; at
    posit8 the pattern rule above, the flips tallied in FLIPS8 (0.0
    returned: the kernels line's max_abs_err is the other formats')."""
    import torch

    tol = FLASH_TOL if tol is None else tol
    check(bool(torch.isfinite(got).all()), f"{kernel} {name}: non-finite output")
    if fmt.n != 8:
        err = max_abs_err(got, want)
        check(err <= tol, f"{kernel} {name}: max|diff| {err} from its twin > {tol}")
        return err
    steps = posit8_steps(got, want)
    flips = int((steps > 0).sum())
    FLIPS8[kernel][0] += flips
    FLIPS8[kernel][1] += steps.numel()
    check(int(steps.max()) <= 1 and flips <= POSIT8_FLIP_SHARE * steps.numel(),
          f"{kernel} {name}: {flips} of {steps.numel()} posit8 outputs off the twin's, at "
          f"most {int(steps.max())} steps (bound 1 step, share {POSIT8_FLIP_SHARE})")
    return 0.0


def gate_grad(kernel, name, fmt, got, want):
    """K7/K8's f32 gradients against their twin's: within BWD_TOL, or at
    posit8 within POSIT8_BWD_TOL and beyond BWD_TOL in at most
    POSIT8_FLIP_SHARE of the elements (tallied in FLIPS8)."""
    import torch

    if fmt.n != 8:
        return gate(kernel, name, fmt, got, want, BWD_TOL)
    check(bool(torch.isfinite(got).all()), f"{kernel} {name}: non-finite output")
    err = (got - want).abs()
    far = int((err > BWD_TOL).sum())
    FLIPS8[kernel][0] += far
    FLIPS8[kernel][1] += err.numel()
    check(float(err.max()) <= POSIT8_BWD_TOL and far <= POSIT8_FLIP_SHARE * err.numel(),
          f"{kernel} {name}: max|diff| {float(err.max())} (bound {POSIT8_BWD_TOL}), {far} of "
          f"{err.numel()} beyond {BWD_TOL} (share {POSIT8_FLIP_SHARE})")
    return 0.0


def one_answer(kernel, name, outs):
    """``outs`` maps each Table IV variant to its outputs (a tensor or a
    tuple) on the same inputs: the variants divide exactly, so they must
    agree bit for bit."""
    first_v, first = next(iter(outs.items()))
    for variant, got in outs.items():
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = first if isinstance(first, (tuple, list)) else (first,)
        for a, b in zip(got, ref):
            diff = int((bits(a) != bits(b)).sum())
            check(diff == 0, f"{kernel} {name}: {variant} differs from {first_v} in {diff} "
                             "elements")


# --------------------------------------------------------------- phase 2


def phase_rowwise(torch, dev):
    from repro_torch.core.posit import POSIT8, POSIT16, posit_to_float
    from repro_torch.core.quire import fixed_order_rowsum
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import one_word_pairs, planned_pairs, two_word_pairs

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
    # step's (8 x 256 tokens) RMSNorm rows; OLMoE's RMSNorm rows (d_model
    # 2048) at 8 slots and one, and its router norm (the top-8 gates over
    # their fixed-order sum) at 8 slots and one
    for R, C in ((8, 960), (256, 960), (2048, 960), (8, 2048), (1, 2048)):
        compare(POSIT16, "srt_r4_cs_of_fr", torch.randn(R, C, generator=g),
                torch.rand(R, 1, generator=g) + 0.01)
    for R in (8, 1):
        gates = torch.rand(R, 8, generator=g) * 0.1
        compare(POSIT16, "srt_r4_cs_of_fr", gates, fixed_order_rowsum(gates))
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
    # every (format, variant), one- and two-word, sampled
    n_pairs = 0
    for fmt, variant, _ in planned_pairs():
        a, b = wide(256, 512), wide(256, 1)
        a[0, :len(specials)] = specials
        b[:len(specials), 0] = specials
        compare(fmt, variant, a, b)
        n_pairs += 1
    # the two-word plans (posit32 srt_r4_scaled, posit64) at the model's
    # RMSNorm rows: a decode step's and a prefill's
    for fmt, variant, _ in two_word_pairs():
        for R in (8, 256):
            compare(fmt, variant, torch.randn(R, 960, generator=g),
                    torch.rand(R, 1, generator=g) + 0.01)
    print(f"K2: bit-exact to its twin (RMSNorm rows of 960 and 2048, router-norm "
          f"rows of 8, posit16 2^20 pairs, posit8 exhaustive, {n_pairs} plans sampled, "
          f"the {len(two_word_pairs())} two-word plans at 8 x 960 and 256 x 960), "
          f"max|diff| {worst[0]}")
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
    """K3 against its twin (``gate``): every posit16, posit8, posit32 and
    posit64 plan at decode (B=8, Sk=512, 15/5 heads, kv_start 0 and above
    0, one fully masked slot) and at a causal prefill P=128 left-padded by
    40 (each format's plans one answer); at the model shapes (prefill
    P=256, OLMoE's decode at 16/16 heads of 128) every plan of MODEL_PLANS,
    and all posit16 plans at OLMoE's decode on 4 slots."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels.posit_div import KERNEL_VARIANTS
    from repro_torch.kernels.posit_flash_attn import (
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    worst = collections.defaultdict(float)

    def compare(name, q, k, v, variant, n, **kw):
        fmt = PositFormat(n)
        o = posit_flash_attention(fmt, q, k, v, True, variant=variant, **kw)
        p = posit_flash_attention_plain(fmt, q, k, v, True, variant=variant, **kw)
        torch.cuda.synchronize()
        worst[n] = max(worst[n], gate("K3", f"posit{n} {variant} {name}", fmt, o, p))
        return o

    dq, dk, dv = flash_inputs(torch, dev, 8, 1, 512, 15, 5, 64, 1)
    pos = torch.tensor([511, 0, 17, 130, 255, 64, 300, 12], dtype=torch.int32, device=dev)
    starts = {"start 0": [0] * 8, "left pads": [0, 0, 5, 100, 250, 64, 0, 13]}
    decode = {s: dict(kv_start=torch.tensor(st, dtype=torch.int32, device=dev),
                      kv_len=pos + 1, q_pos=pos) for s, st in starts.items()}
    # prefill: one prompt left-padded by 40 to P=128, causal (the pad rows
    # are fully masked)
    pq, pk, pv = flash_inputs(torch, dev, 1, 128, 128, 15, 5, 64, 2)
    s40 = torch.tensor([40], dtype=torch.int32, device=dev)
    for n in PLAN_FORMATS:
        variants = plan_variants(n)
        for sname, kw in decode.items():
            outs = {v: compare(f"decode {sname}", dq, dk, dv, v, n, **kw) for v in variants}
            one_answer("K3", f"posit{n} decode {sname}", outs)
        check(bool((outs[DEFAULT_VARIANT][7] == 0).all()),
              f"K3 posit{n} decode: fully masked row is not 0")
        outs = {v: compare("prefill P=128", pq, pk, pv, v, n, kv_start=s40) for v in variants}
        one_answer("K3", f"posit{n} prefill", outs)
        check(bool((outs[DEFAULT_VARIANT][0, :40] == 0).all()),
              f"K3 posit{n} prefill: fully masked rows are not 0")
    # the model shapes: a prefill of 256, OLMoE's decode (head_dim 128, the
    # kernel's largest, MHA 16/16 heads; every posit16 plan at 4 slots)
    q, k, v = flash_inputs(torch, dev, 1, 256, 256, 15, 5, 64, 4)
    mq, mk, mv = flash_inputs(torch, dev, 8, 1, 512, *MOE_HEADS, 3)
    kw = decode["left pads"]
    for n, variant in MODEL_PLANS:
        compare("prefill P=256", q, k, v, variant, n)
        o = compare("decode hd128", mq, mk, mv, variant, n, **kw)
        check(bool((o[7] == 0).all()), f"K3 posit{n} decode hd128: fully masked row is not 0")
    kw4 = {a: t[:4] for a, t in kw.items()}
    for variant in KERNEL_VARIANTS:
        compare("decode hd128 B=4", mq[:4], mk[:4], mv[:4], variant, 16, **kw4)
    flips, elems = FLIPS8["K3"]
    print(f"K3: within {FLASH_TOL} of its twin (max|diff| posit16 {worst[16]:.3g}, posit64 "
          f"{worst[64]:.3g}, posit32 {worst[32]:.3g}; posit8 {flips} of {elems} outputs one "
          f"posit8 step off, gate one step in at most {POSIT8_FLIP_SHARE}): all "
          f"{len(KERNEL_VARIANTS)} plans of posit16, posit8 and posit32 and the "
          f"{len(plan_variants(64))} of posit64 (one answer per format) at decode B=8 x 512 "
          "(kv_start 0 and above 0) and prefill P=128 (kv_start 40); "
          f"{', '.join(f'posit{n} {v}' for n, v in MODEL_PLANS)} at prefill P=256 and "
          "OLMoE's decode (16/16 heads of 128), every posit16 plan there at 4 slots")
    return max(worst.values())


def paged_inputs(torch, dev, B, max_blocks, bs, H, KV, hd, seed):
    """q (B, 1, H, hd) f32, bf16 block pools and a shuffled (B, max_blocks)
    table: sequences 0 and 1 share their first two pages, the last sequence
    is parked (an all-zero row: the sink)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    NB = B * max_blocks + 1
    q = torch.randn(B, 1, H, hd, generator=g).to(dev)
    pk = torch.randn(NB, bs, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    pv = torch.randn(NB, bs, KV, hd, generator=g).to(torch.bfloat16).to(dev)
    bt = (1 + torch.randperm(NB - 1, generator=g)[:B * max_blocks]).reshape(B, max_blocks)
    bt[1, :2] = bt[0, :2]
    bt[-1] = 0
    return q, pk, pv, bt.to(torch.int32).to(dev)


def phase_paged_kernel(torch, dev):
    """K4 against K3 on the gathered dense cache (the same bits) and against
    its twin (``gate``): decode shapes, kv_start 0 and above 0, at every
    plan of MODEL_PLANS, and every posit16, posit32, posit8 and posit64
    plan at a small size (each format's plans one answer)."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels.posit_flash_attn import (
        gather_pages,
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    worst = collections.defaultdict(float)

    def compare(name, q, pk, pv, bt, pos, start, variant, n):
        fmt = PositFormat(n)
        name = f"posit{n} {variant} {name}"
        kw = dict(kv_start=torch.tensor(start, dtype=torch.int32, device=dev),
                  kv_len=pos + 1, q_pos=pos, variant=variant)
        o = posit_flash_attention(fmt, q, pk, pv, True, block_tables=bt, **kw)
        d = posit_flash_attention(fmt, q, gather_pages(pk, bt), gather_pages(pv, bt),
                                  True, **kw)
        p = posit_flash_attention_plain(fmt, q, pk, pv, True, block_tables=bt, **kw)
        torch.cuda.synchronize()
        diff = int((bits(o) != bits(d)).sum())
        check(diff == 0, f"K4 {name}: {diff} elements differ from K3 on the gathered cache")
        worst[n] = max(worst[n], gate("K4", name, fmt, o, p))
        return o

    # decode: 8 slots, max_seq 512 in pages of 16, 15/5 heads, hd 64
    big = paged_inputs(torch, dev, 8, 32, 16, 15, 5, 64, 31)
    pos = torch.tensor([511, 0, 17, 130, 255, 64, 300, 40], dtype=torch.int32, device=dev)
    # and OLMoE's 16/16 heads of 128
    wide = paged_inputs(torch, dev, 8, 32, 16, *MOE_HEADS, 33)
    for n, variant in MODEL_PLANS:
        compare("decode start 0", *big, pos, [0] * 8, variant, n)
        o = compare("decode left pads", *big, pos, [0, 0, 5, 100, 250, 64, 0, 41], variant, n)
        check(bool((o[7] == 0).all()), f"K4 posit{n} decode: fully masked row is not 0")
        o = compare("decode hd128", *wide, pos, [0, 0, 5, 100, 250, 64, 0, 41], variant, n)
        check(bool((o[7] == 0).all()), f"K4 posit{n} decode hd128: fully masked row is not 0")
    small = paged_inputs(torch, dev, 4, 8, 16, 15, 5, 64, 32)
    pos = torch.tensor([127, 40, 77, 60], dtype=torch.int32, device=dev)
    for n in PLAN_FORMATS:
        one_answer("K4", f"posit{n} B=4", {
            v: compare("B=4", *small, pos, [5, 0, 70, 0], v, n) for v in plan_variants(n)})
    flips, elems = FLIPS8["K4"]
    print(f"K4: the same bits as K3 on the gathered cache and within {FLASH_TOL} of its "
          f"twin (max|diff| posit16 {worst[16]:.3g}, posit64 {worst[64]:.3g}, posit32 "
          f"{worst[32]:.3g}; posit8 {flips} of {elems} outputs one step off): decode B=8 x "
          "512 in pages of 16, shuffled shared pages and a parked row, kv_start 0 and "
          "above, 15/5 heads of 64 and 16/16 of 128, "
          f"{', '.join(f'posit{n} {v}' for n, v in MODEL_PLANS)}; every plan of "
          "posit16, posit32, posit8 and posit64 at B=4, one answer per format")
    return max(worst.values())


# K5 is held against its twin and solo K3 at every pack the paged phase can
# form: N = 1-8 segments (a power of two, dummies first, as the engine packs
# 5-8 requests into 8) of width 16-256 (the buckets of its 16-200-token
# prompts, at least a page); each real segment is longer than half its
# width, so from 128 up it spans several kv tiles.  Dense-layout packs are
# left-padded, and checked at a few shapes.
PACK_WIDTHS = (16, 32, 64, 128, 256)
PACK_DUMMIES = {1: 0, 2: 0, 4: 1, 8: 3}
PACKS_LEFT = ((4, 64), (8, 8), (4, 128), (4, 256), (2, 256))
PACKS_EVERY_PLAN = ((4, 128), (8, 256))   # right-padded packs held at every plan


def pack_lens(N, P):
    """Segment lengths of a test pack: the dummies (0), then prompts in
    (P/2, P], the first two of one length (they share a prefix)."""
    d = PACK_DUMMIES.get(N, 1)
    lens = [0] * d + [P - (3 * i + 1) % (P // 2) for i in range(N - d)]
    if N - d > 1:
        lens[d + 1] = lens[d]
    return lens


def packed_inputs(torch, dev, lens, P, seed, H=15, KV=5, hd=64, left=True):
    """A pack of segments of width P with the given lengths (0: a dummy),
    left-padded as the dense layout packs them or right-padded as the paged
    layout does; the second real segment repeats the first one's first half
    (a shared prefix).  Returns q, k, v, seg_q, seg_kv and each real
    segment's (offset, length)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    S = len(lens) * P
    q = torch.randn(1, S, H, hd, generator=g)
    k = torch.randn(1, S, KV, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(1, S, KV, hd, generator=g).to(torch.bfloat16)
    seg = torch.full((1, S), -1, dtype=torch.int32)
    segs = []
    for i, n in enumerate(lens):
        off = i * P + (P - n if left else 0)
        if n:
            seg[0, off:off + n] = i
            segs.append((off, n))
    if len(segs) > 1:
        (o1, n1), (o2, _) = segs[:2]
        for t in (q, k, v):
            t[:, o2:o2 + n1 // 2] = t[:, o1:o1 + n1 // 2]
    seg_q = torch.where(seg < 0, torch.full_like(seg, -2), seg)
    return [t.to(dev) for t in (q, k, v, seg_q, seg)] + [segs]


def phase_packed_kernel(torch, dev):
    """K5 against its twin (``gate``), and each segment's rows against a
    solo K3 prefill of that prompt (the same bits), at every (N, P) in
    PACK_DUMMIES x PACK_WIDTHS right-padded and PACKS_LEFT left-padded, at
    every plan of MODEL_PLANS, and at PACKS_EVERY_PLAN for every posit8,
    posit32 and posit64 plan (one answer).  Returns the worst error of the
    formats other than posit8 and the right-padded shapes held."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels.posit_flash_attn import (
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    worst = collections.defaultdict(float)
    held = [(N, P, False) for N in PACK_DUMMIES for P in PACK_WIDTHS]
    shapes = held + [(N, P, True) for N, P in PACKS_LEFT]

    def compare(n, variant, N, P, left):
        fmt = PositFormat(n)
        name = f"posit{n} {variant} N={N} P={P} {'left' if left else 'right'}-padded"
        q, k, v, seg_q, seg, segs = packed_inputs(torch, dev, pack_lens(N, P), P,
                                                  40 + N + P, left=left)
        o = posit_flash_attention(fmt, q, k, v, True, variant=variant, seg_q=seg_q,
                                  seg_kv=seg, seg_len=P)
        p = posit_flash_attention_plain(fmt, q, k, v, True, variant=variant, seg_q=seg_q,
                                        seg_kv=seg)
        torch.cuda.synchronize()
        worst[n] = max(worst[n], gate("K5", name, fmt, o, p))
        check(bool((o[0][seg_q[0] < 0] == 0).all()),
              f"K5 {name}: the dummy segments' and the pads' rows are not 0")
        for off, m in segs:
            solo = posit_flash_attention(fmt, q[:, off:off + m], k[:, off:off + m],
                                         v[:, off:off + m], True, variant=variant)
            torch.cuda.synchronize()
            diff = int((bits(o[:, off:off + m]) != bits(solo)).sum())
            check(diff == 0, f"K5 {name}: segment at {off} differs from solo K3 in {diff} "
                             "elements")
        return o

    for n, variant in MODEL_PLANS:
        for N, P, left in shapes:
            compare(n, variant, N, P, left)
    for n in (*NEW_FORMATS, 64):
        for N, P in PACKS_EVERY_PLAN:
            one_answer("K5", f"posit{n} N={N} P={P}",
                       {v: compare(n, v, N, P, False) for v in plan_variants(n)})
    flips, elems = FLIPS8["K5"]
    print(f"K5: every segment the same bits as a solo K3 prefill and within {FLASH_TOL} of "
          f"its twin (max|diff| posit16 {worst[16]:.3g}, posit64 {worst[64]:.3g}, posit32 "
          f"{worst[32]:.3g}; posit8 {flips} of {elems} outputs one step off): right-padded "
          f"packs of {'/'.join(map(str, PACK_DUMMIES))} segments x widths "
          f"{'/'.join(map(str, PACK_WIDTHS))}, left-padded "
          f"{', '.join(f'{N} x {P}' for N, P in PACKS_LEFT)}, with dummies and a shared "
          f"prefix, at {', '.join(f'posit{n} {v}' for n, v in MODEL_PLANS)}; every posit8, "
          f"posit32 and posit64 plan at {', '.join(f'{N} x {P}' for N, P in PACKS_EVERY_PLAN)}"
          ", one answer per format")
    return max(worst.values()), {(N, P) for N, P, _ in held}


# suffix prefills (layers.prefill_suffix_attention after a shared prefix):
# their lengths, each held at the prompt's end and in its middle
SUFFIX_LENS = (1, 17)


def phase_suffix(torch, dev):
    """A prefix-sharing suffix prefill gives its rows the bits of the same
    rows of the whole prompt's prefill: the wrapper routes every prefill to
    the tile loop, whatever its length (``flash_loop``), and a row's bits do
    not depend on its tile.  At full width: SmolLM's attention (15/5 heads
    of 64) on a 200-token prompt left-padded to 256 and OLMoE's (16/16
    heads of 128) on 120 tokens, 1- and 17-token suffixes, every plan of
    MODEL_PLANS.  Returns the worst error against the twin."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels.posit_flash_attn import (
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    held, worst = 0, collections.defaultdict(float)
    for heads, P, pad in (((15, 5, 64), 256, 56), (MOE_HEADS, 120, 0)):
        q, k, v = flash_inputs(torch, dev, 2, P, P, *heads, 61)
        start = torch.tensor([pad, 0], dtype=torch.int32, device=dev)
        for n, variant in MODEL_PLANS:
            fmt = PositFormat(n)
            whole = posit_flash_attention(fmt, q, k, v, True, variant=variant, kv_start=start)
            plain = posit_flash_attention_plain(fmt, q, k, v, True, variant=variant,
                                                kv_start=start)
            torch.cuda.synchronize()
            worst[n] = max(worst[n], gate("K3", f"posit{n} {variant} prefill {heads}", fmt,
                                          whole, plain))
            for m in SUFFIX_LENS:
                for t0 in (P - m, pad + (P - pad) // 2):
                    end = t0 + m
                    part = posit_flash_attention(fmt, q[:, t0:end], k[:, :end], v[:, :end],
                                                 True, q_offset=t0, variant=variant,
                                                 kv_start=start)
                    torch.cuda.synchronize()
                    diff = int((bits(part) != bits(whole[:, t0:end])).sum())
                    check(diff == 0, f"K3 suffix posit{n} {variant} heads {heads}: the "
                                     f"{m}-token suffix at {t0} differs from the whole "
                                     f"prefill's rows in {diff} elements")
                    held += 1
    print(f"K3 suffix: {held} suffix prefills ({', '.join(map(str, SUFFIX_LENS))} tokens, at "
          "the prompt's end and middle) give the bits of the whole prefill's rows, at SmolLM's "
          "15/5 heads of 64 (200 tokens left-padded to 256) and OLMoE's 16/16 of 128 (120), "
          f"{', '.join(f'posit{n} {v}' for n, v in MODEL_PLANS)}; the whole prefills within "
          f"{FLASH_TOL} of the twin (max|diff| posit16 {worst[16]:.3g}, posit64 "
          f"{worst[64]:.3g}, posit32 {worst[32]:.3g})")
    return max(v for n, v in worst.items() if n != 8)


# K9 at the router's shapes (a decode step's or scan step's 8 rows, one
# row, OLMoE's training step's 8 x 256 tokens) and wider: 4096 rows, and a
# ragged 37 x 1000
SOFTMAX_SHAPES = ((8, 64), (1, 64), (2048, 64), (4096, 64), (37, 1000))


def softmax_inputs(torch, dev, R, C, seed):
    """Router-like logits; from three rows up, row 0 holds -1e30 entries
    (the xla decode mask's value), row 1 equal values, row 2 a NaN."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(R, C, generator=g) * 2
    if R >= 3:
        x[0, ::3] = -1e30
        x[1] = 0.75
        x[2, 5] = math.nan
    return x.to(dev)


def phase_softmax(torch, dev):
    """K9 against its twin at SOFTMAX_SHAPES, MODEL_PLANS (every posit16,
    posit8, posit32 and posit64 plan on the ragged shape, each format's
    plans one answer there): bit-identical, since both call CUDA's expf and sum each
    row left to right (a shuffle or tree sum would move s by an f32 ulp and
    show here); a NaN row reaches no other row."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import ops

    rows, elements = 0, 0
    cases = [(n, R, C, v) for n, v in MODEL_PLANS for R, C in SOFTMAX_SHAPES]
    cases += [(n, 37, 1000, v) for n in PLAN_FORMATS for v in plan_variants(n)
              if (n, v) not in MODEL_PLANS]
    ragged = collections.defaultdict(dict)     # format -> variant -> (37, 1000) output
    for n, R, C, variant in cases:
        fmt = PositFormat(n)
        name = f"K9 ({R}, {C}) posit{n} {variant}"
        x = softmax_inputs(torch, dev, R, C, R + C)
        o = ops.posit_softmax_fused(fmt, x, variant)
        p = ops.posit_softmax_plain(fmt, x, variant)
        torch.cuda.synchronize()
        diff = int((bits(o) != bits(p)).sum())
        check(diff == 0, f"{name}: {diff} elements differ from the twin "
                         f"(max|diff| {max_abs_err(o, p)})")
        nan_rows = torch.isnan(o).any(-1)
        check(bool((nan_rows == (torch.arange(R, device=dev) == 2)).all()) if R >= 3
              else not bool(nan_rows.any()), f"{name}: NaN rows {nan_rows.nonzero()}")
        if R >= 3:
            check(bool((o[1] == o[1, 0]).all()), f"{name}: a row of equal values differs")
        if (R, C) == (37, 1000):
            ragged[n][variant] = o
        rows, elements = rows + R, elements + R * C
    for n, outs in ragged.items():
        check(len(outs) == len(plan_variants(n)), f"K9 posit{n}: not every plan held")
        one_answer("K9", f"posit{n} (37, 1000)", outs)
    print(f"K9: bit-identical to its twin at {', '.join(map(str, SOFTMAX_SHAPES))}, "
          f"{', '.join(f'posit{n} {v}' for n, v in MODEL_PLANS)} (every plan of posit16, "
          "posit32, posit8 and posit64 on (37, 1000), one answer per format), with -1e30, "
          f"equal-value and NaN rows: {rows} rows, "
          f"{elements} elements; the NaN row reaches no other")
    return 0.0


# The division API (the quickstart's surfaces): K11 on patterns, K12's
# casts, K10 against the chained K12 -> K11 -> K12.  The paper's Table III
# worked examples, Posit10: dividend, divisor, quotient.
TABLE3 = ((0b0011010111, 0b0001001100, 0b0110011111),
          (0b0011010111, 0b0000100110, 0b0111010000))
PAIRS16 = 1 << 32           # the posit16 pair space
CHUNK = 1 << 28             # pairs per launch of the posit16 pair-space sweep
RANDOM_PAIRS = 1 << 20
CAST_SAMPLES = 1 << 26      # random f32 bit patterns quantized per format


def golden_div(pairs, n: int):
    from repro_torch.core import goldens

    return [goldens.div(a, b, n) for a, b in pairs]


def disagreement(torch, what, px, pd, want, got, n):
    """Fail with the first pairs where ``got`` leaves ``want``, and the
    goldens' answers there."""
    bad = (got != want).nonzero()[:6, 0].cpu()
    rows = [(int(px[i]) & 0xFFFFFFFF, int(pd[i]) & 0xFFFFFFFF, int(want[i]), int(got[i]))
            for i in bad]
    gold = golden_div([(a, b) for a, b, _, _ in rows], n)
    fail(f"{what}: {int((got != want).sum())} pairs differ; first (x, d, want, got, "
         f"golden): " + ", ".join(f"({a:#x}, {b:#x}, {w:#x}, {g:#x}, {o:#x})"
                                  for (a, b, w, g), o in zip(rows, gold)))


def phase_pattern_div(torch, dev):
    """K11 on posit bit patterns: posit8 every pair and posit10 every pair
    for the nine variants, the posit16 pair space whole (2^32 pairs, every
    variant against the default's bits), posit32 sampled; against the twin
    and the pure-Python goldens."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import KERNEL_VARIANTS, one_word_pairs

    ops.posit_div.launches = 0
    g = torch.Generator(device=dev).manual_seed(13)
    others = [v for v in KERNEL_VARIANTS if v != DEFAULT_VARIANT]
    # posit8: every pair, every variant, the twin's and the goldens' bits
    P8 = PositFormat(8)
    i = torch.arange(1 << 16, device=dev)
    px, pd = i >> 8, i & 255
    gold8 = torch.tensor(golden_div(zip(px.tolist(), pd.tolist()), 8), device=dev)
    for v in KERNEL_VARIANTS:
        k = ops.posit_div(P8, px, pd, v)
        if not torch.equal(k, gold8):
            disagreement(torch, f"K11 posit8/{v} against the goldens", px, pd, gold8, k, 8)
        check(torch.equal(k, ops.posit_div_plain(P8, px, pd, v)),
              f"K11 posit8/{v}: differs from its twin")
    # posit10: Table III for every variant; the 2^20-pair space mutually
    # identical across variants and the twin's
    P10 = PositFormat(10)
    t3x = torch.tensor([x for x, _, _ in TABLE3], device=dev)
    t3d = torch.tensor([d for _, d, _ in TABLE3], device=dev)
    i = torch.arange(1 << 20, device=dev)
    px, pd = i >> 10, i & 1023
    ref = ops.posit_div(P10, px, pd)
    check(torch.equal(ref, ops.posit_div_plain(P10, px, pd)), "K11 posit10: differs from its twin")
    for v in KERNEL_VARIANTS:
        got = ops.posit_div(P10, t3x, t3d, v).tolist()
        check(got == [q for _, _, q in TABLE3],
              f"K11 posit10/{v}: Table III gives {[bin(q) for q in got]}")
        k = ops.posit_div(P10, px, pd, v)
        if not torch.equal(k, ref):
            disagreement(torch, f"K11 posit10/{v} against {DEFAULT_VARIANT}", px, pd, ref, k, 10)
    # posit16: the whole pair space, generated on the card a chunk at a time
    P16 = PositFormat(16)
    k10 = 0
    t0 = time.perf_counter()
    for c in range(PAIRS16 // CHUNK):
        idx = torch.arange(c * CHUNK, (c + 1) * CHUNK, device=dev)
        px, pd = (idx >> 16).to(torch.int32), (idx & 0xFFFF).to(torch.int32)
        del idx
        ref = ops.posit_div(P16, px, pd, DEFAULT_VARIANT)
        for v in others:
            k = ops.posit_div(P16, px, pd, v)
            if not torch.equal(k, ref):
                disagreement(torch, f"K11 posit16/{v} against {DEFAULT_VARIANT}", px, pd, ref,
                             k, 16)
            del k
        # K10 on the pairs' f32 images (posit16 -> f32 is exact): the f32
        # image of K11's quotient, bit for bit
        k = bits(ops.posit_div_fused(P16, ops.posit_dequantize(P16, px),
                                     ops.posit_dequantize(P16, pd)))
        want = bits(ops.posit_dequantize(P16, ref))
        if not torch.equal(k, want):
            disagreement(torch, "K10 posit16 on the f32 images against K11", px, pd, want, k,
                         16)
        k10 += 1
        del ref, px, pd, k, want
    torch.cuda.synchronize()
    sweep = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # posit16 / posit32: random pairs against the twin; posit32's extremes
    # against each other and the goldens
    n_sampled = 0
    for n in (16, 32):
        fmt = PositFormat(n)
        px, pd = (torch.randint(0, 1 << n, (RANDOM_PAIRS,), device=dev, generator=g)
                  for _ in range(2))
        if n == 32:
            ext = torch.tensor([0, 1 << 31, 1, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000001], device=dev)
            px[:36], pd[:36] = ext.repeat(6), ext.repeat_interleave(6)
            gold32 = torch.tensor(golden_div(zip(px[:4096].tolist(), pd[:4096].tolist()), 32),
                                  device=dev)
        for f, v, _ in one_word_pairs((fmt,)):
            k = ops.posit_div(fmt, px, pd, v)
            twin = ops.posit_div_plain(fmt, px, pd, v)
            if not torch.equal(k, twin):
                disagreement(torch, f"K11 {fmt}/{v} against its twin", px, pd, twin, k, n)
            if n == 32 and not torch.equal(k[:4096], gold32):
                disagreement(torch, f"K11 posit32/{v} against the goldens", px, pd, gold32,
                             k[:4096], 32)
            n_sampled += 1
    launches = ops.posit_div.launches
    check(launches > 0, "K11: no launch")
    print(f"K11: bit-identical to its twin and the goldens on every posit8 pair (9 variants); "
          f"Table III right for every variant; the posit10 pair space (2^20) and the whole "
          f"posit16 pair space ({PAIRS16} pairs, {PAIRS16 // CHUNK} chunks of {CHUNK}, {sweep:.1f} s) "
          f"the same bits under all 9 variants, and K10 on its f32 images ({k10} launches) "
          f"the f32 images of its quotients; {n_sampled} posit16/32 plans the twin's bits on "
          f"2^20 random pairs (posit32 with zero, NaR, +-minpos, +-maxpos, and the goldens' "
          f"on 4096); {launches} launches")
    return {"launches": launches, "sweep_s": sweep, "K10": k10}


def f32_specials(torch):
    """+-0, +-inf, NaNs, every f32 subnormal class (each leading-bit
    position, with its neighbours), +-2^e with both neighbours for every
    exponent, as f32 bit patterns."""
    sub = ([1 << k for k in range(23)] + [(1 << k) | 1 for k in range(1, 23)]
           + [(1 << (k + 1)) - 1 for k in range(23)])
    pow2 = [e << 23 for e in range(1, 255)]
    u = [0, 0x7F800000, 0x7FC00000, 0x7F800001, 0x7FFFFFFF] + sub + pow2 + \
        [p - 1 for p in pow2] + [p + 1 for p in pow2]
    u = torch.tensor(u + [x | (1 << 31) for x in u], dtype=torch.int64)
    return u.to(torch.int32).view(torch.float32)


def phase_casts(torch, dev):
    """K12: dequantize every posit8/16 pattern and 2^20 posit32 patterns
    (int64 lanes, and int32 words and packed uint16 / uint8 where they hold
    them), quantize 2^26 random f32 bit patterns and the specials: the
    twin's bits; quantize o dequantize the identity on every posit8/16
    pattern; the round kernel as the posit-KV path calls it
    (``posit_round_kv``, K and V in one launch) on every bf16 bit pattern
    and on the f32 samples, and as ``posit_round_value`` on every bf16 bit
    pattern widened to f32: the bits of the chain it replaces, quantize ->
    dequantize -> ``.to(dtype)`` on the card (a bf16 NaN's bits torch's CUDA
    conversion's)."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import ops

    ops.posit_quantize.launches = ops.posit_dequantize.launches = 0
    ops.posit_round_kv.launches = ops.posit_round_value.launches = 0
    g = torch.Generator(device=dev).manual_seed(17)
    specials = f32_specials(torch).to(dev)
    bf16 = (torch.arange(1 << 16, dtype=torch.int32, device=dev) << 16).view(torch.float32)
    err = 0.0
    for n in (8, 16, 32):
        fmt = PositFormat(n)
        p = (torch.arange(1 << n, device=dev) if n < 32 else
             torch.randint(0, 1 << 32, (RANDOM_PAIRS,), device=dev, generator=g))
        d = ops.posit_dequantize(fmt, p)
        check(torch.equal(bits(d), bits(ops.posit_dequantize_plain(fmt, p))),
              f"K12 dequantize {fmt}: differs from its twin")
        for dt in (torch.int32, torch.uint16, torch.uint8)[:{8: 3, 16: 2, 32: 1}[n]]:
            check(torch.equal(bits(ops.posit_dequantize(fmt, p.to(dt))), bits(d)),
                  f"K12 dequantize {fmt}: {dt} words differ from int64 lanes")
        if n < 32:
            check(torch.equal(ops.posit_quantize(fmt, d), p),
                  f"K12 {fmt}: quantize o dequantize is not the identity")
        x = torch.randint(-2 ** 31, 2 ** 31, (CAST_SAMPLES,), device=dev, generator=g)
        x = torch.cat([specials, x.to(torch.int32).view(torch.float32)])
        q = ops.posit_quantize(fmt, x)
        check(torch.equal(q, ops.posit_quantize_plain(fmt, x)),
              f"K12 quantize {fmt}: differs from its twin")
        # the round kernel: bf16 K (every pattern), and an f32 and a bf16
        # pair large enough for its vectorized path, each against the chain
        # on the card and its twin
        xb = x[: 1 << 22].to(torch.bfloat16)
        for k, v in ((bf16.to(torch.bfloat16), bf16[:4099].flip(0).to(torch.bfloat16)),
                     (x, x[4:(1 << 20) + 3]), (xb, xb[8:])):
            for t, r in zip((k, v), ops.posit_round_kv(fmt, k, v)):
                chain = ops.posit_dequantize(fmt, ops.posit_quantize(fmt, t)).to(t.dtype)
                view = torch.int32 if t.dtype == torch.float32 else torch.int16
                check(torch.equal(r.view(view), chain.view(view)),
                      f"K12 round {fmt} {t.dtype}: differs from quantize -> dequantize -> .to "
                      f"in {int((r.view(view) != chain.view(view)).sum())} of {t.numel()}")
                err = max(err, max_abs_err(r.float(), ops.posit_round_plain(fmt, t).float()))
        del x, q, xb
        r = ops.posit_round_value(fmt, bf16)
        twin = ops.posit_dequantize_plain(fmt, ops.posit_quantize_plain(fmt, bf16))
        err = max(err, max_abs_err(r, twin), max_abs_err(d, ops.posit_dequantize_plain(fmt, p)))
        check(torch.equal(bits(r), bits(twin)),
              f"K12 {fmt}: rounding bf16 patterns differs from its twin in "
              f"{int((bits(r) != bits(twin)).sum())} of {bf16.numel()}")
    torch.cuda.empty_cache()
    launches = (ops.posit_quantize.launches, ops.posit_dequantize.launches,
                ops.posit_round_kv.launches + ops.posit_round_value.launches)
    print(f"K12: the twin's bits dequantizing every posit8/16 pattern (int64, int32, uint16, "
          f"uint8 words) and 2^20 posit32 ones, quantizing {CAST_SAMPLES} random f32 bit "
          f"patterns and {specials.numel()} specials (+-0, inf, NaN, every subnormal class, "
          f"+-2^e and neighbours) for posit8/16/32; the round kernel the chain's bits on every "
          f"bf16 pattern (bf16 in and out, NaNs as torch's CUDA conversion gives them; f32 in and "
          f"out) and on the f32 samples; quantize o dequantize the identity on every posit8/16 "
          f"pattern; launches quantize, dequantize, round {launches}")
    return err


def phase_fused_chained(torch, dev):
    """K10 against K12 -> K11 -> K12 (and its twin) for every one-word
    (format, variant): the reference benchmark's 64 x 1024 uniform(0.1, 10)
    operands and 2^20 random f32 pairs with the specials.  One launch
    against four per division."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import one_word_pairs

    rng = np.random.default_rng(0)          # benchmarks/bench_tables.py's operands
    a = torch.from_numpy(rng.uniform(0.1, 10, (64, 1024)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(0.1, 10, (64, 1024)).astype(np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(19)
    specials = f32_specials(torch).to(dev)
    ra, rb = (torch.randint(-2 ** 31, 2 ** 31, (RANDOM_PAIRS,), device=dev, generator=g)
              .to(torch.int32).view(torch.float32) for _ in range(2))
    ra[:len(specials)], rb[:len(specials)] = specials, specials.flip(0)
    counters = (ops.posit_div_fused, ops.posit_quantize, ops.posit_div, ops.posit_dequantize)
    for c in counters:
        c.launches = 0
    divisions = 0
    for fmt, v, _ in one_word_pairs():
        for x, y in ((a, b), (ra, rb)):
            k = ops.posit_div_fused(fmt, x, y, v)
            chained = ops.posit_dequantize(fmt, ops.posit_div(
                fmt, ops.posit_quantize(fmt, x), ops.posit_quantize(fmt, y), v))
            check(torch.equal(bits(k), bits(chained)),
                  f"K10 {fmt}/{v} {tuple(x.shape)}: differs from the chain in "
                  f"{int((bits(k) != bits(chained)).sum())} elements")
            check(torch.equal(bits(k), bits(ops.posit_div_fused_plain(fmt, x, y, v))),
                  f"K10 {fmt}/{v} {tuple(x.shape)}: differs from its twin")
            divisions += 1
    k10, q, k11, dq = (c.launches for c in counters)
    check(k10 == divisions and (q, k11, dq) == (2 * divisions, divisions, divisions),
          f"K10: launches fused {k10}, chained {q} + {k11} + {dq} for {divisions} divisions")
    print(f"K10: bit-identical to K12 -> K11 -> K12 and to its twin for every one-word "
          f"(format, variant) on 64 x 1024 uniform(0.1, 10) and 2^20 random f32 pairs with "
          f"the specials; launches 1 against 4 a division ({k10} against {q + k11 + dq})")
    return {"K10": k10, "K11": k11, "K12q": q, "K12dq": dq}


def identity64(torch, u):
    """The f32 bits of x / 1.0 through posit64 for the f32 bit patterns
    ``u`` (int32): x for a normal f32, +0 for a zero, a zero of x's sign for
    a subnormal (posit64 holds it, its conversion back flushes below
    2^-126), the canonical NaN for inf and NaN."""
    e, m = (u >> 23) & 0xFF, u & 0x7FFFFF
    out = torch.where(e == 255, torch.full_like(u, 0x7FC00000), u)
    out = torch.where((e == 0) & (m == 0), torch.zeros_like(u), out)
    return torch.where((e == 0) & (m != 0), u & torch.full_like(u, -2 ** 31), out)


def phase_f32_sweep(torch, dev):
    """K10 on every f32 bit pattern as x / 1.0, default plan: at posit8,
    posit16 and posit32 the bits of K12's quantize then dequantize (the
    pattern casts K10 no longer calls), and so K12's round kernel
    (``posit_round_value``); at posit64 ``identity64``, the rule first held
    against K10's twin on a CPU sample."""
    from repro_torch.core.posit import POSIT8, POSIT16, POSIT32, POSIT64
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(37)
    u = torch.cat([f32_specials(torch).view(torch.int32),
                   torch.randint(-2 ** 31, 2 ** 31, (1 << 14,), generator=g).to(torch.int32)])
    twin = bits(ops.posit_div_fused_plain(POSIT64, u.view(torch.float32),
                                          torch.ones(len(u))))
    check(torch.equal(twin, identity64(torch, u)),
          f"K10 posit64 x / 1.0: the twin leaves the stated rule on "
          f"{int((twin != identity64(torch, u)).sum())} of {len(u)} CPU samples")
    ones = torch.ones(CHUNK, device=dev)
    launches = 0
    t0 = time.perf_counter()
    for c in range((1 << 32) // CHUNK):
        u = (torch.arange(c * CHUNK, (c + 1) * CHUNK, device=dev) - 2 ** 31).to(torch.int32)
        x = u.view(torch.float32)
        for fmt in (POSIT8, POSIT16, POSIT32, POSIT64):
            k = bits(ops.posit_div_fused(fmt, x, ones))
            want = (identity64(torch, u) if fmt is POSIT64 else
                    bits(ops.posit_dequantize(fmt, ops.posit_quantize(fmt, x))))
            if fmt is not POSIT64:
                r = bits(ops.posit_round_value(fmt, x))
                check(torch.equal(r, want),
                      f"K12 round {fmt}: {int((r != want).sum())} f32 patterns differ from "
                      "quantize -> dequantize")
                del r
            if not torch.equal(k, want):
                bad = (k != want).nonzero()[:6, 0]
                fail(f"K10 {fmt} x / 1.0: {int((k != want).sum())} f32 patterns differ; "
                     f"first (x, want, got): " + ", ".join(
                         f"({int(u[i]) & 0xFFFFFFFF:#010x}, {int(want[i]) & 0xFFFFFFFF:#010x}, "
                         f"{int(k[i]) & 0xFFFFFFFF:#010x})" for i in bad.tolist()))
            launches += 1
            del k, want
        del u, x
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"K10: every f32 bit pattern (2^32) as x / 1.0 the bits of K12's round trip at "
          f"posit8, posit16 and posit32 (and of K12's round kernel), and at posit64 x for "
          f"every normal f32, +0 for a "
          f"zero, a signed zero for a subnormal, NaN for inf and NaN (the rule the twin's "
          f"on {len(twin)} CPU samples); {launches} launches, {took:.1f} s")
    return launches


TWO_WORD_PAIRS = 1 << 24       # random posit32 srt_r4_scaled pattern pairs for K11
WIDE_RANDOM_PAIRS = 1 << 20  # random f32 pairs per posit64 variant for K10
GOLDEN_SAMPLE32 = 10000
GOLDEN_SAMPLE64 = 2048
# tests/test_multiword_div.py's edge operands
WIDE_EDGES = [0.0, -0.0, math.inf, -math.inf, math.nan, 3.4028235e38, -3.4028235e38,
              1.1754944e-38, 1e-45, -1e-44, 1e30, -1e-30, 1.0, 2.0]


def special_patterns(n: int):
    """0, NaR, +-minpos, +-maxpos, +-1 and the patterns next to each."""
    mask = (1 << n) - 1
    base = [0, 1 << (n - 1), 1, mask, (1 << (n - 1)) - 1, (1 << (n - 1)) + 1, 1 << (n - 2),
            (mask + 1 - (1 << (n - 2))) & mask]
    return sorted({(x + d) & mask for x in base for d in (-1, 0, 1)})


def golden_float_div64(a: float, b: float):
    """The goldens' posit64 quotient of two f32 values, RNE to 24 bits as
    posit_wide_to_float does, or None outside the f32 normal range (the
    kernels flush those to signed zeros, as the reference's backends do)."""
    import numpy as np

    from repro_torch.core import goldens

    d = goldens.decode(goldens.div(goldens.from_float(a, 64), goldens.from_float(b, 64), 64), 64)
    if d[0] != "num":
        return d[0]
    _, sgn, T, sig = d
    m24 = sig >> 36
    m24 += ((sig >> 35) & 1) & (int((sig & ((1 << 35) - 1)) != 0) | (m24 & 1))
    with np.errstate(over="ignore"):
        want = np.float32((-1.0 if sgn else 1.0) * float(m24) * 2.0 ** (T - 23))
    return float(want) if np.isfinite(want) and abs(want) >= 1.1754944e-38 else None


def phase_two_word(torch, dev):
    """K11 at posit32 srt_r4_scaled and K10 at the eight posit64 variants:
    the two-word datapath against its twin, the goldens and the other
    variants (the reference asserts every Table IV row gives one quotient)."""
    import numpy as np

    from repro_torch.core.posit import POSIT32, POSIT64
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import two_word_pairs

    ops.posit_div.launches = ops.posit_div_fused.launches = 0
    g = torch.Generator(device=dev).manual_seed(29)
    # K11, posit32 srt_r4_scaled: 2^24 random pairs and every special pair
    sp = torch.tensor(special_patterns(32), device=dev)
    px, pd = (torch.randint(0, 1 << 32, (TWO_WORD_PAIRS,), device=dev, generator=g)
              for _ in range(2))
    px = torch.cat([sp.repeat(len(sp)), px])
    pd = torch.cat([sp.repeat_interleave(len(sp)), pd])
    k = ops.posit_div(POSIT32, px, pd, "srt_r4_scaled")
    twin = torch.cat([ops.posit_div_plain(POSIT32, px[i:i + (1 << 22)], pd[i:i + (1 << 22)],
                                          "srt_r4_scaled")
                      for i in range(0, len(px), 1 << 22)])
    if not torch.equal(k, twin):
        disagreement(torch, "K11 posit32/srt_r4_scaled against its twin", px, pd, twin, k, 32)
    sample = torch.cat([torch.arange(len(sp) ** 2, device=dev),
                        torch.randint(len(sp) ** 2, len(px), (GOLDEN_SAMPLE32,), device=dev,
                                      generator=g)])
    gold = torch.tensor(golden_div(zip(px[sample].tolist(), pd[sample].tolist()), 32),
                        device=dev)
    if not torch.equal(k[sample], gold):
        disagreement(torch, "K11 posit32/srt_r4_scaled against the goldens", px[sample],
                     pd[sample], gold, k[sample], 32)
    other = ops.posit_div(POSIT32, px, pd, DEFAULT_VARIANT)
    if not torch.equal(k, other):
        disagreement(torch, f"K11 posit32/srt_r4_scaled against {DEFAULT_VARIANT}", px, pd,
                     other, k, 32)
    n11 = len(px)
    del px, pd, k, twin, other
    # K10, posit64: 2^20 random f32 pairs and every pair of the edge operands
    edges = torch.tensor(WIDE_EDGES, device=dev)
    a, b = (torch.randint(-2 ** 31, 2 ** 31, (WIDE_RANDOM_PAIRS,), device=dev, generator=g)
            .to(torch.int32).view(torch.float32) for _ in range(2))
    a = torch.cat([edges.repeat(len(edges)), a])
    b = torch.cat([edges.repeat_interleave(len(edges)), b])
    first = None
    plans = [(f, v) for f, v, _ in two_word_pairs() if f.n == 64]
    for fmt, v in plans:
        k = ops.posit_div_fused(fmt, a, b, v)
        twin = ops.posit_div_fused_plain(fmt, a, b, v)
        check(torch.equal(bits(k), bits(twin)),
              f"K10 posit64/{v}: differs from its twin in "
              f"{int((bits(k) != bits(twin)).sum())} elements")
        if first is None:
            first = k
        check(torch.equal(bits(k), bits(first)),
              f"K10 posit64/{v}: differs from posit64/{plans[0][1]} in "
              f"{int((bits(k) != bits(first)).sum())} elements")
    idx = torch.cat([torch.arange(len(edges) ** 2, device=dev),
                     torch.randint(len(edges) ** 2, len(a), (GOLDEN_SAMPLE64,), device=dev,
                                   generator=g)]).tolist()
    ah, bh, kh = a.cpu().tolist(), b.cpu().tolist(), first.cpu().tolist()
    checked = 0
    for i in idx:
        want = golden_float_div64(ah[i], bh[i])
        if want == "nar":
            check(math.isnan(kh[i]), f"K10 posit64: {ah[i]} / {bh[i]} gives {kh[i]}, not NaN")
        elif want == "zero":
            check(kh[i] == 0.0, f"K10 posit64: {ah[i]} / {bh[i]} gives {kh[i]}, not 0")
        elif want is not None:
            check(kh[i] == want, f"K10 posit64: {ah[i]} / {bh[i]} gives {kh[i]}, the "
                  f"goldens {want}")
        checked += 1
    # sanity: quotients in the f32 normal range more than 1 ulp from IEEE a / b
    with torch.no_grad():
        ieee = a / b
        normal = torch.isfinite(ieee) & (ieee.abs() >= 1.1754944e-38) & torch.isfinite(a) &             torch.isfinite(b)
        ulp = torch.maximum(
            torch.abs(torch.nextafter(ieee, torch.full_like(ieee, math.inf)) - ieee),
            torch.abs(torch.nextafter(ieee, torch.full_like(ieee, -math.inf)) - ieee))
        far = int(((first - ieee).abs() > ulp)[normal].sum())
    check(far == 0, f"K10 posit64: {far} normal-range quotients more than 1 ulp from a / b")
    launches = (ops.posit_div.launches, ops.posit_div_fused.launches)
    print(f"two-word: K11 posit32/srt_r4_scaled the twin's bits on {n11} pattern pairs "
          f"(2^24 random and every pair of {len(sp)} specials: 0, NaR, +-minpos, +-maxpos, "
          f"+-1 and neighbours), the goldens' on {len(sample)}, and {DEFAULT_VARIANT}'s on "
          f"all; K10 posit64 for {len(plans)} variants the twin's bits and one answer on "
          f"{len(a)} f32 pairs (2^20 random, every pair of {len(edges)} edges), the goldens' "
          f"on {checked}; {far} of {int(normal.sum())} normal-range quotients more than 1 f32 "
          f"ulp from IEEE a / b; launches K11 {launches[0]}, K10 {launches[1]}")
    return {"K11": launches[0], "K10": launches[1]}


def phase_grid(torch, dev):
    """The grids past gridDim.y's 65535: K2 at 262144 rows of 960 (the
    training RMSNorm rows of a 1024 x 256 batch) bit-identical to its twin;
    K3 at B*H = 65536 and K7/K8 at B*H = B*KV = 65536 within their bounds."""
    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_flash_attn as F

    g = torch.Generator(device=dev).manual_seed(31)
    R, C = 262144, 960
    a = torch.randn(R, C, device=dev, generator=g)
    b = torch.rand(R, 1, device=dev, generator=g) + 0.01
    k = ops.posit_div_fused_rowwise(POSIT16, a, b)
    for r in range(0, R, 32768):
        p = ops.posit_div_rowwise_plain(POSIT16, a[r:r + 32768], b[r:r + 32768])
        check(torch.equal(bits(k[r:r + 32768]), bits(p)),
              f"K2 at {R} x {C}: rows {r}-{r + 32767} differ from the twin")
    del a, b, k, p
    B, H, hd = 4096, 16, 64
    q, kk, vv = flash_inputs(torch, dev, B, 1, 64, H, H, hd, 33)
    pos = torch.full((B,), 63, dtype=torch.int32, device=dev)
    o = F.posit_flash_attention(POSIT16, q, kk, vv, True, kv_len=pos + 1, q_pos=pos)
    p = F.posit_flash_attention_plain(POSIT16, q, kk, vv, True, kv_len=pos + 1, q_pos=pos)
    e3 = max_abs_err(o, p)
    check(e3 <= FLASH_TOL, f"K3 at B*H = {B * H}: max|diff| {e3} > {FLASH_TOL}")
    q, kk, vv, co = training_inputs(torch, dev, B, 16, 35, H=H, KV=H, hd=hd)
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, kk, vv, True)
    plan = F.datapath_plan(POSIT16, DEFAULT_VARIANT)
    args = backward_args(F, co, o, m, l, q, kk, vv)
    got = (F.flash_backward_dq(POSIT16, plan, *args), *F.flash_backward_dkv(POSIT16, plan,
                                                                            *args))
    twin = F.flash_backward_plain(POSIT16, q, kk.float(), vv.float(), o, co, m, l, True)
    e8 = max(max_abs_err(x, w) for x, w in zip(got, twin))
    check(e8 <= BWD_TOL, f"K7/K8 at B*KV = {B * H}: max|diff| {e8} > {BWD_TOL}")
    torch.cuda.empty_cache()
    print(f"grid: K2 at {R} x {C} bit-identical to its twin; K3 at B*H = {B * H} within "
          f"{e3:.3g} of its twin; K7/K8 at B*H = B*KV = {B * H} within {e8:.3g}")
    return {"K3": e3, "K8": e8}


def phase_model_small(torch, dev, arch="smollm_360m", div_format="posit16"):
    """The smoke model on the card against the same weights on the CPU
    (the moe family's prefill is its scan of decode steps)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(arch, smoke=True, fused=True).with_numerics(div_format=div_format)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    gpu = tree_to(cpu, dev)
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
    what = "prefill + 3 decode steps"
    if cfg.family == "hybrid":
        # the whole-sequence forward past the local window: K6 with the
        # window (its twin on the CPU) and the RG-LRU scan
        from repro_torch.models import layers as Lyr

        seq = torch.from_numpy(rng.integers(0, cfg.vocab, (2, cfg.local_window + 16)))
        lgs = [Lyr.logits(p["head"], T.forward(p, cfg, {"tokens": seq.to(d)})).float().cpu()
               for p, d in ((cpu, "cpu"), (gpu, dev))]
        c, g = (x[..., :cfg.vocab] for x in lgs)
        bound = LOGIT_ULPS * 2.0 ** (math.floor(math.log2(float(c.abs().max()))) - 7)
        err = float((c - g).abs().max())
        check(bool(torch.isfinite(g).all()) and err <= bound,
              f"smoke model: card vs CPU forward logits differ by {err} > {bound}")
        worst = max(worst, err / bound)
        what += f", forward of {seq.shape[1]} tokens past the {cfg.local_window}-key window"
    print(f"model: {arch} smoke config ({div_format}) on the card within {worst:.2f} of the "
          f"{LOGIT_ULPS}-ulp bound of the CPU path ({what})")


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
    """K6, K7 and K8 against their twins (``gate``, ``gate_grad``): every
    plan of MODEL_PLANS at the training path's shapes (B=8, S=256, 15/5
    heads; the default plan at OLMoE's 16/16 heads of 128 too), every
    posit16, posit8, posit32 and posit64 plan at B=2, S=256 (one answer per
    format: o, m, l, dq, dk, dv), and posit64 srt_r4_cs_of_fr at B*KV =
    65536 (the grid past gridDim.y's 65535); the same bits on a second run;
    zero gradients for fully masked rows."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import posit_flash_attn as F

    worst = collections.defaultdict(float)   # "K6 posit16", ...

    def compare(variant, n, q, k, v, co):
        fmt = PositFormat(n)
        where = f"posit{n} {variant} B={q.shape[0]}"
        o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, variant=variant)
        po, pm, pl = F.posit_flash_attention_fwd_plain(fmt, q, k, v, True, variant=variant)
        torch.cuda.synchronize()
        worst[f"K6 posit{n}"] = max(worst[f"K6 posit{n}"], gate("K6", where, fmt, o, po))
        lse_err = float((m + torch.log(l) - pm - torch.log(pl)).abs().max())
        worst["lse"] = max(worst["lse"], lse_err)
        check(lse_err <= LSE_TOL, f"K6 {where}: max|lse diff| {lse_err} > {LSE_TOL}")
        plan = F.datapath_plan(fmt, variant)
        args = backward_args(F, co, o, m, l, q, k, v)
        runs = [(F.flash_backward_dq(fmt, plan, *args),
                 *F.flash_backward_dkv(fmt, plan, *args)) for _ in range(2)]
        twin = F.flash_backward_plain(fmt, q, k.float(), v.float(), o, co, m, l, True,
                                      variant=variant)
        torch.cuda.synchronize()
        for name, got, again, want in zip(("dq", "dk", "dv"), runs[0], runs[1], twin):
            kern = "K7" if name == "dq" else "K8"
            check(torch.equal(got, again), f"{kern} {where}: {name} differs run to run")
            key = f"{kern} posit{n}"
            worst[key] = max(worst[key], gate_grad(kern, f"{where} {name}", fmt, got, want))
        return (o, m, l, *runs[0])

    # the training path's shapes: B=8 sequences of 256, 15/5 heads
    inputs = training_inputs(torch, dev, 8, 256, 22)
    for n, variant in MODEL_PLANS:
        compare(variant, n, *inputs)
    # OLMoE's training step: B=8 sequences of 256, 16/16 heads of 128
    compare(DEFAULT_VARIANT, 16, *training_inputs(torch, dev, 8, 256, 23, *MOE_HEADS))
    del inputs
    small = training_inputs(torch, dev, 2, 256, 21)
    for n in PLAN_FORMATS:
        one_answer("K6-K8", f"posit{n} B=2", {v: compare(v, n, *small)
                                             for v in plan_variants(n)})
    # posit64 at B*H = B*KV = 65536 (4096 sequences of 16, 16/16 heads)
    compare(DEFAULT_VARIANT, 64, *training_inputs(torch, dev, 4096, 16, 35, H=16, KV=16,
                                                  hd=64))
    torch.cuda.empty_cache()
    # every row fully masked (q_offset = -S puts each query before every key)
    q, k, v, co = small
    S = q.shape[1]
    for n in (16, 64, *NEW_FORMATS):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = F.posit_flash_attention_ste(n, DEFAULT_VARIANT, True, 0, -S, 0.0, *leaves)
        grads = torch.autograd.grad((out * co).sum(), leaves)
        torch.cuda.synchronize()
        check(bool((out == 0).all()), f"K6 posit{n}: fully masked rows are not 0")
        for name, gr in zip(("dq", "dk", "dv"), grads):
            check(bool(torch.isfinite(gr).all()) and bool((gr == 0).all()),
                  f"posit{n} fully masked rows: {name} is not finite zeros")
    flips = {k: FLIPS8[k] for k in ("K6", "K7", "K8")}
    print(f"K6-K8: K6 within {FLASH_TOL} (o) and {LSE_TOL} (lse, max|diff| "
          f"{worst['lse']:.3g}) of its twin, K7/K8 within {BWD_TOL}, bit-identical run to "
          f"run, at {', '.join(f'posit{n} {v}' for n, v in MODEL_PLANS)} (B=8 x 256; posit16 "
          f"{DEFAULT_VARIANT} at OLMoE's 16/16 x 128 too), every plan of posit16, posit8, "
          "posit32 and posit64 at B=2 x 256 (one answer per format), posit64 at B*KV = "
          "65536 (4096 x 16, 16/16 heads); fully masked rows give zero gradients. "
          "max|diff| " + "; ".join(
              f"{kern} posit{n} {worst[f'{kern} posit{n}']:.3g}" for n in (16, 32, 64)
              for kern in ("K6", "K7", "K8")) +
          f"; posit8 K6 {flips['K6'][0]} of {flips['K6'][1]} outputs one step off, K7/K8 "
          f"{flips['K7'][0] + flips['K8'][0]} of {flips['K7'][1] + flips['K8'][1]} "
          f"gradients beyond {BWD_TOL}")
    return {kern: max(worst[f"{kern} posit{n}"] for n in (16, 32, 64))
            for kern in ("K6", "K7", "K8")}


# f32 K/V: posit16's default plan and posit64 nrd (the longest datapath)
F32_KV_PLANS = ((16, DEFAULT_VARIANT), (64, "nrd"))


def f32_values(torch, t, seed):
    """``t`` in f32 plus a perturbation below bf16's step: values bf16
    cannot hold."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    noise = torch.randn(tuple(t.shape), generator=g) * 2.0 ** -12
    return (t.float() + noise.to(t.device)).contiguous()


def phase_f32_kv(torch, dev):
    """K3 (decode B=8 x 512, prefill P=256), K4 (the paged decode), K5 (a
    right-padded 4 x 128 pack) and K6-K8 (B=8 x 256) on f32 K/V, at
    F32_KV_PLANS: on f32 values that bf16 holds, each call gives the bits of
    the same call on bf16 K/V (both upcast exactly into the same f32
    tiles); on values bf16 cannot hold, each is within its bound of its
    twin (``gate``, ``gate_grad``, LSE_TOL) and K7/K8 give the same bits on
    a second run."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import posit_flash_attn as F

    worst = collections.defaultdict(float)
    exact = [0]

    def same(kern, where, got, want):
        diff = int((bits(got) != bits(want)).sum())
        check(diff == 0, f"{kern} {where}: f32 K/V holding bf16 values differs from the bf16 "
                         f"call in {diff} elements")
        exact[0] += 1

    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)
    pos = i32([511, 0, 17, 130, 255, 64, 300, 12])
    ppos = i32([511, 0, 17, 130, 255, 64, 300, 40])
    lens = pack_lens(4, 128)
    sq, sk, sv, seg_q, seg, _ = packed_inputs(torch, dev, lens, 128, 54, left=False)
    gq, gk, gv, bt = paged_inputs(torch, dev, 8, 32, 16, 15, 5, 64, 53)
    calls = {   # name: (kernel, q, k, v, keyword arguments)
        "decode": ("K3", *flash_inputs(torch, dev, 8, 1, 512, 15, 5, 64, 51),
                   dict(kv_start=i32([0, 0, 5, 100, 250, 64, 0, 13]), kv_len=pos + 1,
                        q_pos=pos)),
        "prefill P=256": ("K3", *flash_inputs(torch, dev, 1, 256, 256, 15, 5, 64, 52),
                          dict(kv_start=i32([56]))),
        "paged decode": ("K4", gq, gk, gv, dict(kv_len=ppos + 1, q_pos=ppos, block_tables=bt)),
        "packed 4 x 128": ("K5", sq, sk, sv, dict(seg_q=seg_q, seg_kv=seg, seg_len=128)),
    }
    tq, tk, tv, co = training_inputs(torch, dev, 8, 256, 55)
    for n, variant in F32_KV_PLANS:
        fmt = PositFormat(n)
        for name, (kern, q, k, v, kw) in calls.items():
            where = f"posit{n} {variant} {name}"
            kw = dict(kw, variant=variant)
            ref = F.posit_flash_attention(fmt, q, k, v, True, **kw)
            same(kern, where, F.posit_flash_attention(fmt, q, k.float(), v.float(), True, **kw),
                 ref)
            kf, vf = f32_values(torch, k, 60), f32_values(torch, v, 61)
            got = F.posit_flash_attention(fmt, q, kf, vf, True, **kw)
            plain = F.posit_flash_attention_plain(
                fmt, q, kf, vf, True, **{a: t for a, t in kw.items() if a != "seg_len"})
            torch.cuda.synchronize()
            worst[kern] = max(worst[kern], gate(kern, f"{where} f32 K/V", fmt, got, plain))
        plan = F.datapath_plan(fmt, variant)

        def run(k_, v_):
            o, m, l = F.posit_flash_attention_fwd(fmt, tq, k_, v_, True, variant=variant)
            args = backward_args(F, co, o, m, l, tq, k_, v_)
            return (o, m, l, F.flash_backward_dq(fmt, plan, *args),
                    *F.flash_backward_dkv(fmt, plan, *args))

        where = f"posit{n} {variant} B=8 x 256"
        for name, got, want in zip(("o", "m", "l", "dq", "dk", "dv"), run(tk.float(), tv.float()),
                                   run(tk, tv)):
            same("K6" if name in "oml" else "K7" if name == "dq" else "K8", f"{where} {name}",
                 got, want)
        kf, vf = f32_values(torch, tk, 62), f32_values(torch, tv, 63)
        o, m, l, *grads = run(kf, vf)
        again = run(kf, vf)[3:]
        po, pm, pl = F.posit_flash_attention_fwd_plain(fmt, tq, kf, vf, True, variant=variant)
        twin = F.flash_backward_plain(fmt, tq, kf, vf, o, co, m, l, True, variant=variant)
        torch.cuda.synchronize()
        worst["K6"] = max(worst["K6"], gate("K6", f"{where} f32 K/V", fmt, o, po))
        lse_err = float((m + torch.log(l) - pm - torch.log(pl)).abs().max())
        check(lse_err <= LSE_TOL, f"K6 {where} f32 K/V: max|lse diff| {lse_err} > {LSE_TOL}")
        for name, got, sec, want in zip(("dq", "dk", "dv"), grads, again, twin):
            kern = "K7" if name == "dq" else "K8"
            check(torch.equal(got, sec), f"{kern} {where} f32 K/V: {name} differs run to run")
            worst[kern] = max(worst[kern], gate_grad(kern, f"{where} f32 K/V {name}", fmt, got,
                                                     want))
    print(f"f32 K/V: {exact[0]} calls on f32 values that bf16 holds the bf16 calls' bits (K3 "
          "decode and prefill, K4, K5, K6-K8), and on values bf16 cannot hold within their "
          f"twins' bounds (max|diff| {', '.join(f'{k} {v:.3g}' for k, v in sorted(worst.items()))}"
          f"), at {', '.join(f'posit{n} {v}' for n, v in F32_KV_PLANS)}")
    return worst


def phase_train_small(torch, dev, div_format="posit16", arch="smollm_360m"):
    """One train step of the smoke config on the card against the CPU path
    (``olmoe_1b_7b``: the moe block, its router's K9 and K2 and their
    straight-through backwards)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models.routes import NEAR_TIE, followed_routes, recorded_routes
    from repro_torch.optim.tree import tree_items, tree_leaves, tree_map
    from repro_torch.train.trainer import (
        TrainConfig,
        init_train_state,
        loss_and_grads,
        make_train_step,
    )

    cfg = get_config(arch, smoke=True).with_numerics(div_format=div_format)
    tc = TrainConfig(steps=4, lr=1e-3, warmup=1)
    cpu = init_train_state(cfg, tc, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    batch = SyntheticLMDataset(DataConfig(2, 64), cfg).batch_at(0)
    runs, routes, flips = {}, [], []
    # the card's run first: a moe model's CPU run follows its routes
    for name, state, d in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
        b = {n: torch.from_numpy(np.asarray(x)).to(d) for n, x in batch.items()}
        with (recorded_routes(routes) if name == "gpu" else followed_routes(routes, flips)):
            (loss, _), grads = loss_and_grads(state["params"], cfg, b)
        new_state, metrics = make_train_step(cfg, tc)(state, b)
        runs[name] = (float(loss), grads, float(metrics["loss"]), new_state)
    routing = ""
    if cfg.family == "moe":
        L = cfg.n_layers
        # remat "full": the forward's L routes, then the recompute's in reverse
        check(len(routes) == 2 * L and all(torch.equal(routes[j], routes[2 * L - 1 - j])
                                           for j in range(L)),
            f"smoke train: the card's recompute routed other than its forward "
            f"({len(routes)} routes)")
        worst_tie = max((gap for _, _, gap in flips), default=0.0)
        check(worst_tie <= NEAR_TIE, f"smoke train: the CPU's own experts leave the card's "
                                     f"at {flips[:3]} (gap > {NEAR_TIE})")
        routing = (f"; the card's recompute routed as its forward; the CPU followed the card's "
                   f"routes, its own experts differing at {len(flips)} of "
                   f"{routes[0].shape[0] * routes[0].shape[1] * L} (token, layer) pairs "
                   f"(largest relative probability gap {worst_tie:.3g}, bound {NEAR_TIE})")
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
    print(f"train: {arch} smoke step on the card ({div_format}): loss {g_loss:.6f} vs CPU "
          f"{c_loss:.6f} (rel "
          f"{rel:.3g}, bound {LOSS_RTOL}); worst gradient leaf {worst_key} rel L2 "
          f"{worst:.3g} (bound {GRAD_REL_L2}); worst leaf other than tok {rest:.3g}"
          + routing)


# --------------------------------------------------------------- phase 4


def full_model(torch, dev):
    """SmolLM-360M at full width and depth, random bf16 weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("smollm_360m", fused=True)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    print(f"main: SmolLM-360M ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}) random "
          f"weights in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def request_mix(cfg):
    """The main serving mix: 16 greedy requests, prompts of 16-200 tokens,
    32 new tokens each (seed 0)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 201, 16)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=32)
            for n in lens]


def phase_main(torch, dev, cfg, params, label="main"):
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention
    from repro_torch.serve import FinishReason, Request, ServeEngine

    eng = ServeEngine(cfg, params, device=dev)
    reqs = request_mix(cfg)
    lens = np.array([len(r.tokens) for r in reqs])
    eng.serve([Request(reqs[0].tokens, max_new=2)])   # warm-up, not counted
    torch.cuda.synchronize()

    ops.posit_div_fused_rowwise.launches = 0
    posit_flash_attention.launches = posit_flash_attention.tile_launches = 0
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k3 = ops.posit_div_fused_rowwise.launches, posit_flash_attention.launches
    k3t = posit_flash_attention.tile_launches

    stats = eng.last_serve_stats
    forwards = stats["admissions"] + stats["decode_steps"]
    L = cfg.n_layers
    check(k2 == (2 * L + 1) * forwards,
          f"K2 launched {k2} times, the path implies {(2 * L + 1) * forwards}")
    check(k3 == L * forwards, f"K3 launched {k3} times, the path implies {L * forwards}")
    # the prefills through the tile loop, the decode steps through the one-row loop
    check(k3t == L * stats["admissions"],
          f"K3 took the tile loop {k3t} times, the path's prefills imply "
          f"{L * stats['admissions']}")
    for r in eng.last_results:
        check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == 32,
              f"request {r.rid} finished {r.finish} with {len(r.tokens)} tokens "
              f"({r.detail})")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"request {r.rid}: token out of the vocabulary")
    n_tok = sum(len(o) for o in outs)
    print(f"{label}: served {len(reqs)} requests ({cfg.numerics.div_format} "
          f"{cfg.numerics.div_algo}; prompts {lens.min()}-{lens.max()} "
          f"tokens, 32 new each) on {eng.sc.max_batch} slots: {n_tok} tokens in "
          f"{wall:.2f} s = {n_tok / wall:.1f} tokens/s; {stats['admissions']} "
          f"prefills + {stats['decode_steps']} decode steps; K2 {k2} launches, "
          f"K3 {k3} launches ({k3t} prefill launches through the tile loop)")
    for i in (0, 7):
        solo = eng.serve([reqs[i]])[0]
        check(np.array_equal(solo, outs[i]),
              f"request {i}: solo tokens differ from the batched run")
    print(f"{label}: requests 0 and 7 bit-identical solo and batched")
    return {"rowwise": k2, "K3": k3, "K3 tile": k3t, "tokens_per_s": n_tok / wall,
            "forwards": forwards, "outs": outs}


PREFIX_LEN = 128            # the shared system prompt of the paged phase
PAGED_BLOCK = 16


def paged_mix(cfg):
    """The main mix plus 8 requests that share one 128-token prefix followed
    by 16-64 tokens of their own (a system prompt, as a chat deployment
    sends), interleaved so that later ones find the prefix registered."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, PREFIX_LEN)
    chat = [Request(np.concatenate([prefix, rng.integers(0, cfg.vocab, n)]).astype(np.int32),
                    max_new=32) for n in rng.integers(16, 65, 8)]
    mix = request_mix(cfg)
    out = []
    for i in range(8):
        out += [chat[i]] + mix[2 * i:2 * i + 2]
    return out


def phase_paged(torch, dev, cfg, params, packs_held, label="paged", dense_outs=None,
                same_as=None):
    """Full-width serving from the paged, prefix-shared pool with packed
    prefill (K4 decode, K5 packed admissions, K3 suffix prefills), counted
    and compared with a dense solo-admission run of the same requests.
    Every pack it forms must have a shape in ``packs_held`` (those the K5
    phase checked).  With ``dense_outs`` (the main phase's dense run of
    ``request_mix`` in this numerics) the tokens must be those of both
    dense runs, bit for bit; without, a difference is diagnosed.  With
    ``same_as`` (another plan's paged run of this format, which held those
    gates) the tokens must be that run's, bit for bit, and no dense run is
    made: the plans divide exactly."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention as F
    from repro_torch.serve import FinishReason, ServeConfig, ServeEngine

    reqs = paged_mix(cfg)
    sc = ServeConfig.from_model(cfg, kv_layout="paged", block_size=PAGED_BLOCK,
                                packed_prefill=True)
    eng = ServeEngine(cfg, params, sc, device=dev)
    eng.serve([reqs[1]])                                  # warm-up, not counted
    torch.cuda.synchronize()
    packs = []                  # (N, width, segment lengths) of each packed prefill
    prefill_pack = eng._prefill_pack

    def recorded(toks, segs, pos, last, W):
        packs.append((len(last), W, [int((segs[0, i * W:(i + 1) * W] >= 0).sum())
                                     for i in range(len(last))]))
        return prefill_pack(toks, segs, pos, last, W)

    eng._prefill_pack = recorded
    ops.posit_div_fused_rowwise.launches = 0
    F.launches = F.tile_launches = F.paged_launches = F.packed_launches = 0
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k3, k4, k5 = (ops.posit_div_fused_rowwise.launches, F.launches, F.paged_launches,
                      F.packed_launches)
    k3t = F.tile_launches
    st = eng.last_serve_stats
    L = cfg.n_layers
    solo = st["admissions"] - st["packed_segments"]
    check(k4 == L * st["decode_steps"],
          f"{label}: K4 launched {k4} times, {st['decode_steps']} decode steps imply "
          f"{L * st['decode_steps']}")
    check(k5 == L * st["packed_packs"],
          f"{label}: K5 launched {k5} times, {st['packed_packs']} packs imply "
          f"{L * st['packed_packs']}")
    check(k3 == L * solo, f"{label}: K3 launched {k3} times, {solo} solo (prefix-shared) "
                          f"admissions imply {L * solo} (none in decode)")
    check(k3t == k3, f"{label}: {k3 - k3t} of K3's {k3} suffix prefills took the one-row loop")
    forwards = st["decode_steps"] + st["packed_packs"] + solo
    check(k2 == (2 * L + 1) * forwards,
          f"{label}: K2 launched {k2} times, the path implies {(2 * L + 1) * forwards}")
    check(solo > 0 and st["prefix_hit_rate"] > 0,
          f"{label}: {solo} prefix-shared solo admissions, hit rate {st['prefix_hit_rate']}")
    check(st["faults"] == 0 and st["shed"] == 0, f"{label}: faults or sheds: {st}")
    shapes = collections.Counter((N, W) for N, W, _ in packs)
    check(len(packs) == st["packed_packs"] and set(shapes) <= packs_held,
          f"{label}: packs {dict(shapes)} not all among those the K5 phase held")
    for r in eng.last_results:
        check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == 32,
              f"{label}: request {r.rid} finished {r.finish} with {len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"{label}: request {r.rid}: token out of the vocabulary")
    n_tok = sum(len(o) for o in outs)
    peak_rows = st["peak_blocks_in_use"] * PAGED_BLOCK
    print(f"{label}: served {len(reqs)} requests ({cfg.numerics.div_format} "
          f"{cfg.numerics.div_algo}; 16 of the main mix, 8 sharing a "
          f"{PREFIX_LEN}-token prefix) on {sc.max_batch} slots, pages of {PAGED_BLOCK}: "
          f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s, "
          f"{wall / st['decode_steps'] * 1e3:.2f} ms a decode step (wall over steps, "
          f"admissions included); {st['packed_packs']} packs of {st['packed_segments']} "
          f"requests ({st['packed_dummies']} dummies; N x width: "
          f"{', '.join(f'{n} {N} x {W}' for (N, W), n in sorted(shapes.items()))}), "
          f"{solo} prefix-shared solo "
          f"admissions, {st['decode_steps']} decode steps; prefix hit rate "
          f"{st['prefix_hit_rate']:.4f} ({st['prefix_hit_tokens']} of "
          f"{st['prompt_tokens']} prompt tokens); peak {st['peak_blocks_in_use']} blocks "
          f"= {peak_rows} rows against the dense layout's {sc.max_batch} x {sc.max_seq} = "
          f"{sc.max_batch * sc.max_seq}; launches K2 {k2}, K3 {k3}, K4 {k4}, K5 {k5}")

    if same_as is not None:
        off = [i for i, (a, b) in enumerate(zip(same_as, outs)) if not np.array_equal(a, b)]
        check(not off, f"{label}: requests {off} differ from the other plan's paged run")
        print(f"{label}: tokens bit-identical to the other plan's paged run of the same "
              f"{len(reqs)} requests")
        differ = []
    else:
        dense = ServeEngine(cfg, params, device=dev)
        ref = dense.serve(reqs)
        differ = [i for i, (a, b) in enumerate(zip(ref, outs)) if not np.array_equal(a, b)]
        if not differ:
            print(f"{label}: tokens bit-identical to a dense solo-admission run of the same "
                  f"{len(reqs)} requests")
        else:
            paged_difference(torch, dev, cfg, params, reqs, ref, outs, differ)
    if dense_outs is not None:
        check(not differ, f"{label}: {len(differ)} requests' tokens differ from the dense run")
        # the main mix's requests sit at 3i + 1 and 3i + 2 of the paged mix
        main = [outs[3 * (j // 2) + 1 + j % 2] for j in range(len(dense_outs))]
        off = [j for j, (a, b) in enumerate(zip(main, dense_outs)) if not np.array_equal(a, b)]
        check(not off, f"{label}: main-mix requests {off} differ from the main phase's dense "
                       "run")
        print(f"{label}: the main mix's {len(dense_outs)} requests bit-identical to the "
              "main phase's dense run too")
    # the timing phase times K5 on the path's most frequent pack shape
    N, W = max(shapes, key=lambda nw: (shapes[nw], nw[0] * nw[1]))
    pack = next(p for p in packs if p[:2] == (N, W))
    return {"rowwise": k2, "K3": k3, "K3 tile": k3t, "K4": k4, "K5": k5,
            "tokens_per_s": n_tok / wall,
            "differ": len(differ), "stats": st, "pack": pack, "outs": outs}


def paged_difference(torch, dev, cfg, params, reqs, ref, outs, differ):
    """Where the paged run's tokens leave the dense run's: the first such
    token, the logits gap there in bf16 ulps, and whether the attention
    kernel and the bf16 products give the same bits at the two layouts'
    shapes (a dense admission's left-padded bucket, a paged one's unpadded
    prompt)."""
    import numpy as np

    from repro_torch.models import layers as Lyr
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import _bucket

    i = differ[0]
    j = int(np.flatnonzero(ref[i] != outs[i])[0])
    seq = np.concatenate([reqs[i].tokens, ref[i][:j]]).astype(np.int64)
    n = len(seq)
    P = _bucket(n, 4 * n + 8)
    padded = np.zeros(P, np.int64)
    padded[P - n:] = seq
    with torch.inference_mode():
        lg_d, _ = T.prefill(params, cfg, torch.as_tensor(padded[None], device=dev),
                            T.init_cache(cfg, 1, P, device=dev),
                            torch.tensor([P - n], dtype=torch.int32, device=dev))
        lg_p, _ = T.prefill(params, cfg, torch.as_tensor(seq[None], device=dev),
                            T.init_cache(cfg, 1, n, device=dev))
        # layer 0: the q projection's real rows at both shapes, and K3 on the
        # same q/k/v at both layouts
        p0 = params["layers"][0]
        x = Lyr.rmsnorm(Lyr.embed(params["tok"], torch.as_tensor(padded[None], device=dev)),
                        p0["ln1"], cfg)
        pos = torch.arange(P, device=dev)[None] - (P - n)
        q_pad, k_pad, v_pad = Lyr._qkv(p0, x, cfg, pos)
        q_un, k_un, v_un = Lyr._qkv(p0, x[:, P - n:].contiguous(), cfg, pos[:, P - n:])
        products_equal = (torch.equal(q_pad[:, P - n:], q_un)
                          and torch.equal(k_pad[:, P - n:], k_un))
        nm = cfg.numerics
        F = Lyr.posit_flash_attention
        pad = lambda t_pad, t_un: torch.cat([t_pad[:, :P - n], t_un], 1)
        a_pad = F(nm.div_fmt, pad(q_pad, q_un), pad(k_pad, k_un), pad(v_pad, v_un), True,
                  variant=nm.div_algo,
                  kv_start=torch.tensor([P - n], dtype=torch.int32, device=dev))
        a_un = F(nm.div_fmt, q_un, k_un, v_un, True, variant=nm.div_algo)
        attn_equal = torch.equal(a_pad[:, P - n:], a_un)
    a, b = lg_d[0, -1, :cfg.vocab].float(), lg_p[0, -1, :cfg.vocab].float()
    ulp = 2.0 ** (math.floor(math.log2(float(a.abs().max()))) - 7)
    gap = float((a - b).abs().max())
    top2 = torch.topk(a, 2).values
    print(f"paged: tokens differ from the dense solo-admission run in {len(differ)} of "
          f"{len(reqs)} requests; first at request {i}, token {j}: the logits of the two "
          f"layouts' prefill shapes (left-padded {P} rows, unpadded {n}) differ by {gap:.4g} "
          f"= {gap / ulp:.2f} bf16 ulps of max|logit| (top-2 margin "
          f"{float(top2[0] - top2[1]):.4g}); "
          f"attention kernel at the two layouts bit-identical: {attn_equal}; layer-0 q/k "
          f"products bit-identical: {products_equal}")


def served_with_cache(eng, reqs):
    """Serve ``reqs`` and return (outputs, the engine's KV cache as it was
    at the end of the run)."""
    caches = []
    finalize = eng._finalize_stats

    def grab(st):
        caches.append(st.cache)
        finalize(st)

    eng._finalize_stats = grab
    try:
        outs = eng.serve(reqs)
    finally:
        eng._finalize_stats = finalize
    return outs, caches[0]


@contextlib.contextmanager
def kv_checked(torch, dev, fmt):
    """Put a stand-in for ``layers._kv_round`` in place that holds every
    K/V rounding the serving path makes (K12 on the card) against K12's
    plain twin on the same rows, and yields its tally, kept on the card:
    the calls, the entries that differ from the twin's and the largest such
    difference, the entries the rounding moved and the entries it saw.  The
    twin is plain PyTorch: it launches no K12."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as Lyr

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    tally = {"calls": 0, "differ": zero.clone(), "moved": zero.clone(), "seen": 0,
             "err": torch.zeros((), device=dev)}
    kv_round = Lyr._kv_round

    def checked(k, v, cfg):
        rk, rv = kv_round(k, v, cfg)
        for x, r in ((k, rk), (v, rv)):
            twin = ops.posit_dequantize_plain(
                fmt, ops.posit_quantize_plain(fmt, x.to(torch.float32))).to(x.dtype)
            got, want = r.to(torch.float32), twin.to(torch.float32)
            differ = bits(got) != bits(want)
            gap = torch.nan_to_num((got - want).abs(), nan=math.inf)
            tally["differ"] += differ.sum()
            tally["err"] = torch.maximum(tally["err"], torch.where(differ, gap, 0.0).max())
            tally["moved"] += (bits(got) != bits(x.to(torch.float32))).sum()
            tally["seen"] += x.numel()
        tally["calls"] += 1
        return rk, rv

    Lyr._kv_round = checked
    try:
        yield tally
    finally:
        Lyr._kv_round = kv_round


def kv_verdict(name, tally, calls):
    """Fail unless the stand-in saw ``calls`` roundings (one per layer of
    every forward step) and K12 gave the twin's bits in each; the moved
    share and the largest difference from the twin."""
    check(tally["calls"] == calls, f"{name}: {tally['calls']} K/V roundings held against "
                                   f"K12's twin, {calls} expected (one per layer and step)")
    differ = int(tally["differ"])
    check(differ == 0, f"{name}: K12's rounding of {differ} K/V entries differs from its "
                       f"twin's (max|diff| {float(tally['err'])})")
    return int(tally["moved"]) / max(tally["seen"], 1), float(tally["err"])


def phase_posit_kv(torch, dev, cfg, params, packs_held):
    """Full-width SmolLM-360M (at the depth of ``cfg``: POSIT_KV_LAYERS)
    served from a posit KV cache (every K/V row
    rounded through K12 before it is cached or attended): posit16 from
    dense slots (the main mix) and from the paged pool with packed prefill
    (the paged mix), posit8 from dense slots.  Per forward step L launches
    of K12's round kernel (K and V of a layer in one), no quantize or
    dequantize, over the unchanged K2-K5 counts;
    every rounding of every layer and step (prefill, packed prefill,
    decode) the bits of K12's plain twin on the same rows; finite logits
    (the engine's health probe on, no fault); paged = dense tokens, no
    prefix hit; two requests solo = batched; every cache row a fixed point
    of K12's rounding and of the twin's; posit8 moves entries."""
    import numpy as np

    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention as F
    from repro_torch.numerics.quant import posit_round_value
    from repro_torch.serve import FinishReason, ServeConfig, ServeEngine

    L = cfg.n_layers
    counters = (ops.posit_round_kv, ops.posit_quantize, ops.posit_dequantize,
                ops.posit_div_fused_rowwise)
    out = {"K12r": 0, "err": 0.0}

    def run(name, eng, reqs, fmt):
        check(eng.sc.health_checks, f"{name}: the engine's logits health probe is off")
        for c in counters:
            c.launches = 0
        F.launches = F.paged_launches = F.packed_launches = 0
        with kv_checked(torch, dev, fmt) as tally:
            t0 = time.perf_counter()
            outs, cache = served_with_cache(eng, reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rk, q, dq, k2 = (c.launches for c in counters)
        st = eng.last_serve_stats
        solo = st["admissions"] - st["packed_segments"]
        forwards = st["decode_steps"] + st["packed_packs"] + solo
        for kname, got, want in (("K12 round", rk, L * forwards),
                                 ("K12 quantize", q, 0), ("K12 dequantize", dq, 0),
                                 ("K2", k2, (2 * L + 1) * forwards),
                                 ("K3", F.launches, L * (solo if eng._paged else forwards)),
                                 ("K4", F.paged_launches,
                                  L * st["decode_steps"] if eng._paged else 0),
                                 ("K5", F.packed_launches, L * st["packed_packs"])):
            check(got == want, f"{name}: {kname} launched {got} times, {forwards} forward "
                               f"steps imply {want}")
        moved, err = kv_verdict(name, tally, L * forwards)
        out["err"] = max(out["err"], err)
        check(st["faults"] == 0 and st["shed"] == 0,
              f"{name}: faults (non-finite logits) or sheds: {st}")
        for r in eng.last_results:
            check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == 32,
                  f"{name}: request {r.rid} finished {r.finish} with {len(r.tokens)} tokens")
            check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
                  f"{name}: request {r.rid}: token out of the vocabulary")
        out["K12r"] += rk
        n_tok = sum(len(o) for o in outs)
        return outs, cache, st, forwards, n_tok / wall, rk, moved

    def fixed_point(name, fmt, cache):
        for part in ("k", "v"):
            rows = cache[part].float()
            again = posit_round_value(fmt, rows)
            check(torch.equal(bits(again), bits(rows)),
                  f"{name}: {int((bits(again) != bits(rows)).sum())} cached {part} entries "
                  "are not fixed points of K12's rounding")
            twin = ops.posit_dequantize_plain(fmt, ops.posit_quantize_plain(fmt, rows))
            check(torch.equal(bits(twin), bits(rows)),
                  f"{name}: {int((bits(twin) != bits(rows)).sum())} cached {part} entries "
                  "are not fixed points of the twin's rounding")
            del rows, again, twin

    mix, pmix = request_mix(cfg), paged_mix(cfg)
    main_outs = ServeEngine(cfg, params, device=dev).serve(mix)   # the bf16 cache's tokens
    lines = []
    dense = {}
    for fmt_name in ("posit16", "posit8"):
        pcfg = cfg.with_numerics(kv_cache_format=fmt_name)
        fmt = PositFormat(int(fmt_name[5:]))
        eng = ServeEngine(pcfg, params, device=dev)
        outs, cache, st, fw, tps, k12, moved = run(f"posit-KV {fmt_name} dense", eng, mix, fmt)
        fixed_point(f"posit-KV {fmt_name} dense", fmt, cache)
        del cache
        dense[fmt_name] = outs
        differ = sum(not np.array_equal(a, b) for a, b in zip(outs, main_outs))
        if fmt_name == "posit8":
            check(moved > 0, "posit-KV posit8 dense: the rounding moved no K/V entry")
        for i in (0, 7):
            with kv_checked(torch, dev, fmt) as tally:
                alone = eng.serve([mix[i]])[0]
            st1 = eng.last_serve_stats
            kv_verdict(f"posit-KV {fmt_name} request {i} solo", tally,
                       L * (st1["decode_steps"] + st1["admissions"]))
            check(np.array_equal(alone, outs[i]),
                  f"posit-KV {fmt_name}: request {i} solo differs from batched")
        lines.append(f"{fmt_name} dense: {tps:.1f} tokens/s (checked), {fw} forward steps, "
                     f"K12 round launches {k12} (L a step); {differ} of "
                     f"{len(mix)} requests' tokens differ from the bf16 cache's; the "
                     f"rounding moved {moved:.4f} of the K/V entries")
    # posit16 from the paged pool, packed: the dense run's tokens, no sharing
    pcfg = cfg.with_numerics(kv_cache_format="posit16")
    sc = ServeConfig.from_model(pcfg, kv_layout="paged", block_size=PAGED_BLOCK,
                                packed_prefill=True)
    eng = ServeEngine(pcfg, params, sc, device=dev)
    packs = []
    prefill_pack = eng._prefill_pack

    def recorded(toks, segs, pos, last, W):
        packs.append((len(last), W))
        return prefill_pack(toks, segs, pos, last, W)

    eng._prefill_pack = recorded
    pouts, _, st, fw, tps, k12, _ = run("posit-KV posit16 paged", eng, pmix, PositFormat(16))
    check(st["packed_packs"] > 0, "posit-KV paged: no packed prefill ran")
    check(st["prefix_hit_rate"] == 0 and st["prefix_lookups"] == 0 and st["shared_blocks"] == 0,
          f"posit-KV paged: prefix sharing under kv_cache_format: {st}")
    check(set(packs) <= packs_held, f"posit-KV paged: packs {set(packs)} not all among those "
                                    "the K5 phase held")
    # paged_mix interleaves: chat request i at 3i, then the main mix's 2i, 2i + 1
    chat_pos = list(range(0, len(pmix), 3))
    main_pos = [i for i in range(len(pmix)) if i % 3]
    chat_dense = ServeEngine(pcfg, params, device=dev).serve([pmix[i] for i in chat_pos])
    want = dict(zip(main_pos, dense["posit16"]))
    want.update(zip(chat_pos, chat_dense))
    differ = [i for i in range(len(pmix)) if not np.array_equal(pouts[i], want[i])]
    check(not differ, f"posit-KV paged: requests {differ} differ from the dense posit16 run")
    lines.append(f"posit16 paged (pages of {PAGED_BLOCK}, packed): {len(pmix)} requests, "
                 f"{tps:.1f} tokens/s (checked), {fw} forward steps ({st['packed_packs']} packs of "
                 f"{st['packed_segments']}), K12 round launches {k12}, prefix hit "
                 f"rate {st['prefix_hit_rate']}, tokens the dense posit16 run's "
                 f"({len(main_pos)} of the main mix, {len(chat_pos)} chat)")
    print(f"posit-KV ({cfg.n_layers} of 32 layers; tokens/s with every rounding checked: not a "
          "throughput): "
          + "; ".join(lines) + "; every K/V rounding of every layer and step "
          "(prefill, packed prefill, decode) the bits of K12's twin on the same rows "
          f"(max|diff| {out['err']}), logits finite, every cached row a fixed point of K12's "
          "rounding and the twin's, requests 0 and 7 solo = batched")
    return out


STREAM_SNAPSHOT_AT = 100    # events consumed before a stream is abandoned and snapshot
STREAM_POISON_AT = 40       # events consumed before a slot's K/V rows are poisoned
STREAM_DEADLINE_MS = 60.0   # one request's budget; the consumer's clock moves 1 ms an event
SAMPLED = 4                 # the mix's first requests, sampled at temperature 0.8


class EventClock:
    """An injected engine clock (seconds) that the consumer moves."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def zero_launches():
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention as F

    ops.posit_div_fused_rowwise.launches = 0
    F.launches = F.tile_launches = F.paged_launches = F.packed_launches = 0


def read_launches():
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention as F

    return collections.Counter({"rowwise": ops.posit_div_fused_rowwise.launches,
                                "K3": F.launches, "K3 tile": F.tile_launches,
                                "K4": F.paged_launches, "K5": F.packed_launches})


def exact_launches(label, cfg, st, c):
    """The launches of a served session are the main and paged phases' per
    forward step: K2 2L+1, L K3 (dense) or K4 (paged) a decode step, L K3
    through the tile loop a solo prefill, L K5 a pack."""
    L = cfg.n_layers
    solo = st["admissions"] - st["packed_segments"]
    forwards = st["decode_steps"] + st["packed_packs"] + solo
    paged = st["kv_layout"] == "paged"
    want = {"rowwise": (2 * L + 1) * forwards, "K3 tile": L * solo,
            "K3": L * (solo if paged else solo + st["decode_steps"]),
            "K4": L * st["decode_steps"] if paged else 0, "K5": L * st["packed_packs"]}
    got = {k: c[k] for k in want}
    check(got == want, f"{label}: launches {got}, the session's {forwards} forward steps "
                       f"imply {want}")


def drain(stream, on_event=None, events=None):
    """Consume ``stream`` to its end (``on_event`` sees every event);
    returns the events, appended to ``events``."""
    events = [] if events is None else events
    for ev in stream:
        events.append(ev)
        if on_event is not None:
            on_event(ev)
    return events


def event_keys(events):
    """Events as comparable tuples (a result's times are the run's own)."""
    return [("token", ev.rid, int(ev.token)) if type(ev).__name__ == "TokenEvent"
            else ("finish", ev.rid, ev.result.finish.value, tuple(ev.result.tokens.tolist()))
            for ev in events]


def stream_tokens(label, events, n):
    """Each of requests 0..n-1 has exactly one FinishEvent whose tokens are
    the concatenation of its TokenEvents; returns {rid: ServeResult}."""
    import numpy as np

    from repro_torch.serve import TokenEvent

    toks, results = collections.defaultdict(list), {}
    for ev in events:
        if isinstance(ev, TokenEvent):
            toks[ev.rid].append(ev.token)
        else:
            check(ev.rid not in results, f"{label}: request {ev.rid} finished twice")
            results[ev.rid] = ev.result
    check(sorted(results) == list(range(n)),
          f"{label}: finish events for {sorted(results)}, want 0..{n - 1}")
    for rid, res in results.items():
        check(np.array_equal(np.asarray(toks[rid], np.int32), res.tokens),
              f"{label}: request {rid}'s token events are not its result's tokens")
    return results


def same_tokens(label, results, want, skip=()):
    import numpy as np

    off = [i for i, w in enumerate(want) if i not in skip
           and not np.array_equal(results[i].tokens, w)]
    check(not off, f"{label}: requests {off} differ from the uninterrupted run's tokens")


def is_prefix(label, res, clean, reason):
    import numpy as np

    n = len(res.tokens)
    check(res.finish.value == reason and 0 < n < len(clean)
          and np.array_equal(res.tokens, clean[:n]),
          f"{label}: request {res.rid} finished {res.finish.value} with {n} tokens, want "
          f"{reason} with a prefix of its {len(clean)} clean tokens")


def poison_slot(torch, eng, slot):
    """NaN into one slot's K/V rows of the engine's live dense cache."""
    with torch.inference_mode():
        for t in eng._st.cache.values():
            t[:, slot] = float("nan")


def snapshot_restore(torch, eng, make):
    """Snapshot ``eng``'s session, drop it, restore on ``make()``; returns
    (engine, snapshot bytes, snapshot s, restore s)."""
    import pickle

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = eng.snapshot()
    t_snap = time.perf_counter() - t0
    nbytes = len(pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL))
    del eng
    eng2 = make()
    t0 = time.perf_counter()
    eng2.restore(snap)
    torch.cuda.synchronize()
    return eng2, snap, nbytes, t_snap, time.perf_counter() - t0


def pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else float("nan")


def phase_stream(torch, dev, cfg, params, main_outs, card):
    """The live session from dense slots (the main phase's engine and mix):
    live admission, snapshot/restore (greedy and sampled), fault isolation,
    a deadline cut mid-decode, and ``stream_async``; every run's tokens the
    main phase's (or the stated prefixes), its launches exact."""
    import dataclasses

    import numpy as np

    from repro_torch.serve import FinishReason, ServeConfig, ServeEngine, TokenEvent
    from repro_torch.serve import stream_async

    reqs = request_mix(cfg)
    n = len(reqs)
    sc = ServeConfig.from_model(cfg)
    make = lambda clock=None: ServeEngine(cfg, params, sc, device=dev, clock=clock)
    total = collections.Counter()
    lines = []

    def counted(label, eng, c):
        exact_launches(label, cfg, eng.last_serve_stats, c)
        total.update(c)

    # live admission: the second half submitted at request 0's first tokens
    eng = make()
    eng.serve([reqs[0].tokens[:16]], max_new=2)          # warm-up, not counted
    torch.cuda.synchronize()
    late = iter(reqs[8:])
    zero_launches()
    t0 = time.perf_counter()
    for r in reqs[:8]:
        eng.submit(r)

    def submit_late(ev):
        if isinstance(ev, TokenEvent) and ev.rid == 0:
            nxt = next(late, None)
            if nxt is not None:
                eng.submit(nxt)
    live = drain(eng.serve_stream(), submit_late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_launches()
    results = stream_tokens("stream", live, n)
    same_tokens("stream", results, main_outs)
    counted("stream", eng, c)
    st = eng.last_serve_stats
    n_tok = sum(len(r.tokens) for r in results.values())
    ttft, lat = st["ttft_ms"], st["token_latency_ms"]
    lines.append(f"live admission (8 submitted, 8 more at request 0's first 8 tokens): "
                 f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s; TTFT ms p50 "
                 f"{pct(ttft, 50):.2f} p99 {pct(ttft, 99):.2f}; per-token latency ms p50 "
                 f"{pct(lat, 50):.2f} p99 {pct(lat, 99):.2f} ({card}); launches K2 "
                 f"{c['rowwise']}, K3 {c['K3']} ({c['K3 tile']} prefill)")
    out = {"tokens_per_s": n_tok / wall, "ttft_ms": (pct(ttft, 50), pct(ttft, 99)),
           "token_latency_ms": (pct(lat, 50), pct(lat, 99))}
    # snapshot after the STREAM_SNAPSHOT_AT-th event, restore on a new engine
    eng = make()
    zero_launches()
    for r in reqs:
        eng.submit(r)
    first = []
    for ev in eng.serve_stream():
        first.append(ev)
        if len(first) == STREAM_SNAPSHOT_AT:
            break
    eng, snap, nbytes, t_snap, t_rest = snapshot_restore(torch, eng, make)
    rest = drain(eng.serve_stream())
    c = read_launches()
    results = stream_tokens("stream restore", first + rest, n)
    same_tokens("stream restore", results, main_outs)
    pending = event_keys(snap["pending"])
    check(len(pending) > 0 and event_keys(rest[:len(pending)]) == pending,
          f"stream restore: the {len(pending)} unconsumed events are not the restored "
          "stream's first")
    check(event_keys(first + rest) == event_keys(live),
          "stream restore: the event sequence differs from the live run's")
    counted("stream restore", eng, c)
    lines.append(f"snapshot after event {STREAM_SNAPSHOT_AT} ({len(snap['queue'])} queued, "
                 f"{len(snap['pending'])} unconsumed events): {nbytes} bytes pickled, "
                 f"snapshot {t_snap * 1e3:.1f} ms, restore {t_rest * 1e3:.1f} ms; the live "
                 "run's events, each once")
    # sampled: the mix's first SAMPLED requests at temperature 0.8, seeds pinned
    sampled = [dataclasses.replace(r, temperature=0.8, seed=i)
               for i, r in enumerate(reqs[:SAMPLED])]
    zero_launches()
    eng = make()
    want = eng.serve(sampled)
    counted("stream sampled", eng, read_launches())
    zero_launches()
    eng = make()
    for r in sampled:
        eng.submit(r)
    first = []
    for ev in eng.serve_stream():
        first.append(ev)
        if len(first) == STREAM_POISON_AT:
            break
    eng, snap, _, _, _ = snapshot_restore(torch, eng, make)
    results = stream_tokens("stream sampled restore", first + drain(eng.serve_stream()),
                            SAMPLED)
    same_tokens("stream sampled restore", results, want)
    counted("stream sampled restore", eng, read_launches())
    differ = sum(not np.array_equal(a, b) for a, b in zip(want, main_outs))
    lines.append(f"sampled (first {SAMPLED} at temperature 0.8, snapshot after event "
                 f"{STREAM_POISON_AT}, {len(snap['gen_state'])} generator states): the "
                 f"uninterrupted sampled run's tokens ({differ} of {SAMPLED} leave greedy)")
    # fault isolation: one active slot's K/V rows NaN after the STREAM_POISON_AT-th event
    eng = make()
    zero_launches()
    for r in reqs:
        eng.submit(r)
    victim = 3
    state = {"n": 0}

    def poison(ev):
        state["n"] += 1
        if state["n"] == STREAM_POISON_AT:
            slot = int(np.flatnonzero(eng._st.sched.slot_req == victim)[0])
            poison_slot(torch, eng, slot)
    results = stream_tokens("stream fault", drain(eng.serve_stream(), poison), n)
    is_prefix("stream fault", results[victim], main_outs[victim], "fault")
    same_tokens("stream fault", results, main_outs, skip=(victim,))
    check(eng.last_serve_stats["faults"] == 1,
          f"stream fault: {eng.last_serve_stats['faults']} faults, want 1")
    counted("stream fault", eng, read_launches())
    lines.append(f"fault: request {victim}'s K/V rows NaN after event {STREAM_POISON_AT}: it "
                 f"finished fault with its first {len(results[victim].tokens)} clean tokens, "
                 "the other 15 theirs, faults 1")
    # deadline: the consumer's clock moves 1 ms an event
    clock = EventClock()
    eng = make(clock)
    zero_launches()
    cut = 5
    for i, r in enumerate(reqs):
        eng.submit(dataclasses.replace(r, deadline_ms=STREAM_DEADLINE_MS) if i == cut else r)

    def tick(ev):
        clock.t += 1e-3
    results = stream_tokens("stream deadline", drain(eng.serve_stream(), tick), n)
    is_prefix("stream deadline", results[cut], main_outs[cut], "deadline")
    same_tokens("stream deadline", results, main_outs, skip=(cut,))
    check(eng.last_serve_stats["deadline_evictions"] == 1,
          f"stream deadline: {eng.last_serve_stats['deadline_evictions']} deadline "
          "evictions, want 1")
    counted("stream deadline", eng, read_launches())
    lines.append(f"deadline: request {cut} at {STREAM_DEADLINE_MS} ms on a clock of 1 ms an "
                 f"event finished deadline with its first {len(results[cut].tokens)} clean "
                 "tokens, the other 15 theirs")
    # stream_async: the worker thread's events are serve_stream's
    eng = make()
    zero_launches()
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    events = list(stream_async(eng))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(event_keys(events) == event_keys(live),
          "stream_async: its event sequence differs from serve_stream's")
    counted("stream_async", eng, read_launches())
    lines.append(f"stream_async: serve_stream's {len(events)} events in order, "
                 f"{n_tok / wall:.1f} tokens/s")
    for line in lines:
        print(f"stream: {line}")
    out.update(total)
    return out


def phase_stream_paged(torch, dev, cfg, params, packs_held, paged_outs, card):
    """The paged phase's engine and mix streamed: the second half submitted
    mid-flight, a snapshot after the STREAM_SNAPSHOT_AT-th event restored
    on a new engine; the paged phase's tokens, exact K2-K5 launches, every
    pack a shape the K5 phase held, and no page left mapped after the
    drain."""
    from repro_torch.serve import ServeConfig, ServeEngine, TokenEvent

    label = "stream paged"
    reqs = paged_mix(cfg)
    half = len(reqs) // 2
    sc = ServeConfig.from_model(cfg, kv_layout="paged", block_size=PAGED_BLOCK,
                                packed_prefill=True)
    packs = []

    def make():
        eng = ServeEngine(cfg, params, sc, device=dev)
        prefill_pack = eng._prefill_pack

        def recorded(toks, segs, pos, last, W):
            packs.append((len(last), W))
            return prefill_pack(toks, segs, pos, last, W)

        eng._prefill_pack = recorded
        return eng

    cur = {"eng": make()}
    cur["eng"].serve([reqs[1]])                          # warm-up, not counted
    torch.cuda.synchronize()
    packs.clear()
    late = iter(reqs[half:])
    zero_launches()
    t0 = time.perf_counter()
    for r in reqs[:half]:
        cur["eng"].submit(r)

    def submit_late(ev):
        if isinstance(ev, TokenEvent) and ev.rid == 0:
            nxt = next(late, None)
            if nxt is not None:
                cur["eng"].submit(nxt)
    events = []
    for ev in cur["eng"].serve_stream():
        events.append(ev)
        submit_late(ev)
        if len(events) == STREAM_SNAPSHOT_AT:
            break
    cur["eng"], snap, nbytes, t_snap, t_rest = snapshot_restore(torch, cur["eng"], make)
    drain(cur["eng"].serve_stream(), submit_late, events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(next(late, None) is None, f"{label}: not every late request was submitted")
    c = read_launches()
    eng = cur["eng"]
    results = stream_tokens(label, events, len(reqs))
    same_tokens(label, results, paged_outs)
    st = eng.last_serve_stats
    exact_launches(label, cfg, st, c)
    check(len(packs) == st["packed_packs"] and set(packs) <= packs_held,
          f"{label}: packs {collections.Counter(packs)} not all among those the K5 phase held")
    solo = st["admissions"] - st["packed_segments"]
    check(solo > 0 and st["prefix_hit_rate"] > 0,
          f"{label}: {solo} prefix-shared solo admissions, hit rate {st['prefix_hit_rate']}")
    alloc = eng._st.alloc
    usable = set(range(1, alloc.num_blocks))
    check(alloc.blocks_in_use() == 0 and int(alloc.refcount.sum()) == 0
          and set(alloc.free) | set(alloc.cached) == usable
          and set(alloc.cached) <= set(alloc.owner),
          f"{label}: after the drain {alloc.blocks_in_use()} pages mapped, "
          f"{len(usable - set(alloc.free) - set(alloc.cached))} unaccounted for")
    n_tok = sum(len(r.tokens) for r in results.values())
    ttft, lat = st["ttft_ms"], st["token_latency_ms"]
    print(f"{label}: {len(reqs)} requests ({half} submitted, {len(reqs) - half} at request "
          f"0's first tokens), snapshot after event {STREAM_SNAPSHOT_AT} ({nbytes} bytes "
          f"pickled, snapshot {t_snap * 1e3:.1f} ms, restore {t_rest * 1e3:.1f} ms): the "
          f"paged phase's tokens; {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s "
          f"(the snapshot included); TTFT ms p50 {pct(ttft, 50):.2f} p99 {pct(ttft, 99):.2f}; "
          f"per-token latency ms p50 {pct(lat, 50):.2f} p99 {pct(lat, 99):.2f} ({card}); "
          f"{st['packed_packs']} packs, {solo} prefix-shared solo admissions, hit rate "
          f"{st['prefix_hit_rate']:.4f}; after the drain no page mapped, "
          f"{len(alloc.cached)} registered prefix pages parked; launches K2 {c['rowwise']}, "
          f"K3 {c['K3']}, K4 {c['K4']}, K5 {c['K5']}")
    out = dict(c)
    out.update(tokens_per_s=n_tok / wall, ttft_ms=(pct(ttft, 50), pct(ttft, 99)),
               token_latency_ms=(pct(lat, 50), pct(lat, 99)))
    return out


LAUNCHER_ARGS = ["--arch", "smollm-360m", "--stream", "--kv-layout", "paged",
                 "--packed-prefill", "--shared-prefix", "64", "--requests", "8", "--batch", "4",
                 "--max-new", "16"]


def phase_launcher(src):
    """``python -m repro_torch.launch.serve`` at full width on the card: exit 0,
    an SLO line, a paged line with prefix hits."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *LAUNCHER_ARGS],
                       capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    tail = (r.stdout + r.stderr)[-3000:]
    check(r.returncode == 0, f"launcher: exit {r.returncode}:\n{tail}")
    summary = [ln for ln in r.stdout.splitlines() if ln.startswith("# ")]
    slo = [ln for ln in summary if ln.startswith("# slo:")]
    paged = [ln for ln in summary if ln.startswith("# paged:")]
    hits = re.search(r"\((\d+)/(\d+) prompt tokens", paged[0]) if paged else None
    check(bool(slo) and hits is not None and int(hits.group(1)) > 0,
          f"launcher: no '# slo:' line or no prefix hit on its '# paged:' line:\n{tail}")
    print(f"launcher: python -m repro_torch.launch.serve {' '.join(LAUNCHER_ARGS)}: exit 0 "
          f"in {wall:.1f} s")
    for ln in summary:
        print(f"launcher: {ln}")


def phase_train_main(torch, dev, div_format="posit16", div_algo=DEFAULT_VARIANT,
                     record=False, profile=True):
    """SmolLM-360M at full width trained for 4 steps through K2, K6, K7, K8
    (at posit64: every divide on the two-word frame).  With ``record``, each
    step's loss and a bit-level fingerprint of every parameter after it are
    kept (``same_training`` compares two runs); with ``profile`` one more
    step is traced."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_flash_attn as F
    from repro_torch.optim.tree import tree_items
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("smollm_360m").with_numerics(div_format=div_format, div_algo=div_algo)
    B, S, steps = 8, 256, 4
    tc = TrainConfig(steps=steps, lr=1e-3, warmup=1, log_every=1, seed=0)
    ds = SyntheticLMDataset(DataConfig(B, S, seed=0), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tc, ds, device=dev)
    prints = []      # per step: (loss, {parameter: fingerprint})
    if record:
        step_fn = trainer.step_fn

        def recorded(state, batch):
            state, metrics = step_fn(state, batch)
            prints.append((float(metrics["loss"]), {
                key: int(bits(t).to(torch.int64).sum())
                for key, t in tree_items(state["params"])}))
            return state, metrics

        trainer.step_fn = recorded
    counters = (ops.posit_div_fused_rowwise, F.posit_flash_attention,
                F.posit_flash_attention_fwd, F.flash_backward_dq, F.flash_backward_dkv)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if record:
        trainer.step_fn = step_fn
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
    print(f"training: SmolLM-360M ({L} layers, {div_format} {div_algo}, f32 masters, remat "
          f"full), {steps} steps "
          f"of {B}x{S} tokens in {wall:.2f} s; losses {[round(x, 4) for x in losses]}; "
          f"step wall times {[round(x, 3) for x in secs]} s; {B * S / min(secs):.1f} "
          f"tokens/s at the fastest step; launches K2 {k2} (4L+1 per step), K6 {k6} (2L), "
          f"K7 {k7} (L), K8 {k8} (L); peak device memory {peak / 2**30:.2f} GiB"
          + ("; each step's parameters fingerprinted (inside the step times)" if record else ""))
    out = {"rowwise": k2, "K6": k6, "K7": k7, "K8": k8, "losses": losses, "prints": prints,
           "step_s": secs, "peak_bytes": peak, "busy_ms": None, "traced_ms": None}
    if not profile:
        return out

    # one more step under the profiler (not counted above)
    batch = {n: torch.from_numpy(x).to(dev) for n, x in ds.batch_at(steps).items()}

    def step():
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        float(metrics["loss"])

    times, traced = profiled(torch, step, [*FLASH_FWD, "flash_bwd"])
    by = by_class(times, (("K7 flash dq", "flash_bwd_dq_kernel"),
                          ("K8 flash dk/dv", "flash_bwd_dkv_kernel"),
                          ("K6 flash fwd", FLASH_FWD), ("K2 rowwise", "rowwise_kernel")))
    busy = sum(by.values()) if times else None
    if busy is None:
        print(f"training step (traced): wall {traced:.1f} ms; torch.profiler showed no "
              f"device records in {PROFILE_TRIES} tries: busy and idle share not measured")
    else:
        print("training step (%s, traced): wall %.1f ms, device busy %.1f ms, idle share "
              "%.3f; %s" % (div_format, traced, busy, 1 - busy / traced,
                            ", ".join(f"{k} {v:.2f} ms" for k, v in by.items())))
    return dict(out, busy_ms=busy, traced_ms=traced)


def same_training(label, got, want, what="the default plan's run"):
    """Two recorded training runs of one format at two plans (or two remat
    policies): the divides are exact, so every step's loss and every
    parameter after it must be the same bits.  Names the first step and the
    first tensor that differ."""
    for step, ((loss, params), (loss0, params0)) in enumerate(zip(got["prints"],
                                                                  want["prints"])):
        check(loss == loss0, f"{label}: step {step} loss {loss!r} against {loss0!r}")
        off = [key for key in params0 if params[key] != params0[key]]
        if off:
            fail(f"{label}: step {step}: parameter {off[0]} differs first ({len(off)} of "
                 f"{len(params0)} differ)")
    check(len(got["prints"]) == len(want["prints"]) > 0, f"{label}: steps not recorded")
    print(f"{label}: every step's loss and all {len(want['prints'][0][1])} parameters after "
          f"it bit-identical to {what} ({len(want['prints'])} steps)")


MOE_REQUESTS = 16
MOE_NEW = 16
MOE64_REQUESTS = 4          # the posit64 and posit32 OLMoE runs serve the mix's first 4
# Depth cuts for the script's time (its limit is 1200 s; the host-bound
# serving phases run a forward a prompt position, about 2-3 ms of host time
# a layer): OLMoE is served at 8 of its 16 layers, RecurrentGemma's `hybrid`
# mix at 13 of its 26 (its forward, wrap and training phases keep theirs),
# and the posit-KV phase runs SmolLM-360M at 16 of its 32 layers
MOE_SERVE_LAYERS = 8
HYBRID_SERVE_LAYERS = 13
POSIT_KV_LAYERS = 16


def cut_model(cfg, params, n_layers):
    """The model's first ``n_layers`` layers (the weights shared, not
    copied) at full width."""
    return cfg.replace(n_layers=n_layers), dict(params, layers=params["layers"][:n_layers])


def moe_model(torch, dev):
    """OLMoE-1B-7B at full width and MOE_SERVE_LAYERS of its 16 layers,
    random bf16 weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("olmoe_1b_7b", fused=True).replace(n_layers=MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tensors_of(params) if t.dim() > 1)
    print(f"moe: OLMoE-1B-7B ({cfg.n_layers} of 16 layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_experts} experts "
          f"top-{cfg.experts_per_token}, d_ff {cfg.d_ff}, vocab {cfg.vocab}): {n / 1e9:.3f} B "
          f"random parameters in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return cfg, params


def moe_mix(cfg):
    """The MoE serving mix: MOE_REQUESTS greedy requests, prompts of 16-120
    tokens, MOE_NEW new tokens each (numpy seed 0)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 121, MOE_REQUESTS)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=MOE_NEW)
            for n in lens]


def phase_moe(torch, dev, cfg, params, n_requests=MOE_REQUESTS, label="moe"):
    """Full-width OLMoE-1B-7B served from dense slots with batch-axis packed
    admission (the first ``n_requests`` of the mix): every router through
    K9, launch counts exact, requests 0 and 7 (or the last) the same tokens
    alone on a solo-admission engine."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention
    from repro_torch.serve import FinishReason, Request, ServeConfig, ServeEngine

    reqs = moe_mix(cfg)[:n_requests]
    lens = np.array([len(r.tokens) for r in reqs])
    eng = ServeEngine(cfg, params, ServeConfig.from_model(cfg, packed_prefill=True), device=dev)
    eng.serve([Request(reqs[0].tokens[:8], max_new=2)])   # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (ops.posit_softmax_fused, posit_flash_attention, ops.posit_div_fused_rowwise)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k9, k3, k2 = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated()
    st = eng.last_serve_stats
    L = cfg.n_layers
    # one forward per scan step (one prompt position of every row of a
    # prefill) and per decode step; each computes its logits
    forwards = st["prefill_forwards"] + st["decode_steps"]
    for name, got, per in (("K9", k9, L), ("K3", k3, L), ("K2", k2, 3 * L + 1)):
        check(got == per * forwards, f"{label}: {name} launched {got} times, {forwards} forward "
                                     f"steps imply {per * forwards}")
    check(st["faults"] == 0 and st["shed"] == 0 and st["packed_packs"] > 0,
          f"{label}: faults, sheds or no pack: {st}")
    for r in eng.last_results:
        check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == MOE_NEW,
              f"{label}: request {r.rid} finished {r.finish} with {len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"{label}: request {r.rid}: token out of the vocabulary")
    n_tok = sum(len(o) for o in outs)
    print(f"{label}: served {len(reqs)} requests ({cfg.numerics.div_format} "
          f"{cfg.numerics.div_algo}; prompts {lens.min()}-{lens.max()} tokens, "
          f"{MOE_NEW} new each) on {eng.sc.max_batch} slots, batch-axis packed admission: "
          f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.2f} tokens/s; {forwards} forward "
          f"steps ({st['prefill_forwards']} scan steps in {st['packed_packs']} packs of "
          f"{st['packed_segments']} requests with {st['packed_dummies']} dummy rows and "
          f"{st['admissions'] - st['packed_segments']} solo admissions, "
          f"{st['decode_steps']} decode steps); launches K9 {k9}, K3 {k3}, K2 {k2} (L, L, "
          f"3L+1 a forward step); peak device memory {peak / 2**30:.2f} GiB")
    solo = ServeEngine(cfg, params, ServeConfig.from_model(cfg), device=dev)
    probes = sorted({0, min(7, len(reqs) - 1)})
    for i in probes:
        alone = solo.serve([reqs[i]])[0]
        if not np.array_equal(alone, outs[i]):
            moe_difference(torch, dev, cfg, params)
            fail(f"{label}: request {i} alone gave {alone.tolist()}, packed {outs[i].tolist()}")
    print(f"{label}: requests {probes} alone on a solo-admission engine: the same tokens as "
          "packed")
    return {"K9": k9, "K3": k3, "rowwise": k2, "tokens_per_s": n_tok / wall,
            "forwards": forwards, "peak_bytes": peak, "outs": outs}


def moe_difference(torch, dev, cfg, params):
    """Which of layer 0's bf16 products gives a row other bits at another
    batch: a pack's scan steps run them at M = N rows, a solo admission at
    M = 1, a decode step at M = 8."""
    from repro_torch.models import layers as Lyr

    p = params["layers"][0]
    g = torch.Generator(device="cpu").manual_seed(7)
    x = Lyr.rmsnorm(params["tok"][torch.randint(0, cfg.vocab, (8, 1), generator=g).to(dev)],
                    p["ln1"], cfg)
    E, F = cfg.n_experts, cfg.d_ff
    prods = {name: (lambda a, n=name: torch.matmul(a, p[n])) for name in
             ("wq", "wk", "wv", "router")}
    prods["head"] = lambda a: torch.matmul(a, params["head"])
    for name in ("w1", "w3"):
        prods[name] = (lambda a, n=name: torch.einsum(
            "becd,edf->becf", a[:, None].expand(-1, E, -1, -1), p[n]))
    h = torch.randn(8, 1, F, generator=g).to(dev, torch.bfloat16)
    lost = []
    for name, f in prods.items():
        one = f(x[:1])
        for M in (2, 4, 8):
            if not torch.equal(f(x[:M])[:1], one):
                lost.append(f"{name} (M=1 vs {M})")
                break
    w2 = lambda a: torch.einsum("becf,efd->becd", a[:, None].expand(-1, E, -1, -1), p["w2"])
    for M in (2, 4, 8):
        if not torch.equal(w2(h[:M])[:1], w2(h[:1])):
            lost.append(f"w2 (M=1 vs {M})")
            break
    print(f"moe: products whose row 0 loses its bits when more rows ride along: "
          f"{', '.join(lost) if lost else 'none'}")


MOE_CHAT = 4                # requests of the moe paged mix sharing one prefix


def moe_paged_mix(cfg):
    """The MoE mix's first 8 requests plus MOE_CHAT that share one
    128-token prefix followed by 16-64 tokens of their own, interleaved so
    that later ones find the prefix registered (as ``paged_mix`` does)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, PREFIX_LEN)
    chat = [Request(np.concatenate([prefix, rng.integers(0, cfg.vocab, n)]).astype(np.int32),
                    max_new=MOE_NEW) for n in rng.integers(16, 65, MOE_CHAT)]
    mix = moe_mix(cfg)[:2 * MOE_CHAT]
    out = []
    for i in range(MOE_CHAT):
        out += [chat[i]] + mix[2 * i:2 * i + 2]
    return out


def phase_moe_paged(torch, dev, cfg, params):
    """Full-width OLMoE-1B-7B served from the paged, prefix-shared pool
    (pages of 16, packed admission: batch-axis packs of right-padded rows,
    ``T.prefill_batch_ragged``): per forward step L K9 and 3L+1 K2
    launches; L K3 launches per scan step (into a dense mini cache) and L
    K4 per decode step, no K5; prefix hits and packs; the tokens of a
    dense-slot packed run of the same requests, bit for bit (else the
    script names the bf16 product that lost a row's bits and fails)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_flash_attn import posit_flash_attention as F
    from repro_torch.serve import FinishReason, Request, ServeConfig, ServeEngine

    label = "moe paged"
    reqs = moe_paged_mix(cfg)
    sc = ServeConfig.from_model(cfg, kv_layout="paged", block_size=PAGED_BLOCK,
                                packed_prefill=True)
    eng = ServeEngine(cfg, params, sc, device=dev)
    eng.serve([Request(reqs[1].tokens[:8], max_new=2)])   # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.posit_softmax_fused.launches = ops.posit_div_fused_rowwise.launches = 0
    F.launches = F.tile_launches = F.paged_launches = F.packed_launches = 0
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k9, k2 = ops.posit_softmax_fused.launches, ops.posit_div_fused_rowwise.launches
    k3, k4, k5 = F.launches, F.paged_launches, F.packed_launches
    peak = torch.cuda.max_memory_allocated()
    st = eng.last_serve_stats
    L = cfg.n_layers
    forwards = st["prefill_forwards"] + st["decode_steps"]
    for name, got, want in (("K9", k9, L * forwards), ("K2", k2, (3 * L + 1) * forwards),
                            ("K3", k3, L * st["prefill_forwards"]),
                            ("K3 through the tile loop", F.tile_launches, 0),
                            ("K4", k4, L * st["decode_steps"]), ("K5", k5, 0)):
        check(got == want, f"{label}: {name} launched {got} times, the path implies {want} "
                           f"({st['prefill_forwards']} scan steps, {st['decode_steps']} "
                           "decode steps)")
    check(st["prefix_hit_tokens"] > 0 and st["packed_packs"] > 0,
          f"{label}: no prefix hit or no pack: {st}")
    check(st["faults"] == 0 and st["shed"] == 0, f"{label}: faults or sheds: {st}")
    for r in eng.last_results:
        check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == MOE_NEW,
              f"{label}: request {r.rid} finished {r.finish} with {len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"{label}: request {r.rid}: token out of the vocabulary")
    n_tok = sum(len(o) for o in outs)
    solo = st["admissions"] - st["packed_segments"]
    print(f"{label}: served {len(reqs)} requests ({cfg.numerics.div_format} "
          f"{cfg.numerics.div_algo}; {len(reqs) - MOE_CHAT} of the MoE mix, {MOE_CHAT} sharing "
          f"a {PREFIX_LEN}-token prefix) on {sc.max_batch} slots, pages of {PAGED_BLOCK}: "
          f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.2f} tokens/s; {forwards} forward "
          f"steps ({st['prefill_forwards']} scan steps in {st['packed_packs']} packs of "
          f"{st['packed_segments']} requests with {st['packed_dummies']} dummy rows and {solo} "
          f"prefix-shared solo admissions, {st['decode_steps']} decode steps); prefix hit rate "
          f"{st['prefix_hit_rate']:.4f} ({st['prefix_hit_tokens']} of {st['prompt_tokens']} "
          f"prompt tokens); peak {st['peak_blocks_in_use']} blocks = "
          f"{st['peak_blocks_in_use'] * PAGED_BLOCK} rows against the dense layout's "
          f"{sc.max_batch * sc.max_seq}; launches K9 {k9}, K2 {k2}, K3 {k3}, K4 {k4}, K5 {k5}; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    dense = ServeEngine(cfg, params, ServeConfig.from_model(cfg, packed_prefill=True),
                        device=dev)
    ref = dense.serve(reqs)
    off = [i for i, (a, b) in enumerate(zip(ref, outs)) if not np.array_equal(a, b)]
    if off:
        moe_difference(torch, dev, cfg, params)
        fail(f"{label}: requests {off} differ from the dense-slot run (first: paged "
             f"{outs[off[0]].tolist()}, dense {ref[off[0]].tolist()})")
    print(f"{label}: tokens bit-identical to a dense-slot packed run of the same "
          f"{len(reqs)} requests")
    return {"K9": k9, "rowwise": k2, "K3": k3, "K3 tile": F.tile_launches, "K4": k4,
            "tokens_per_s": n_tok / wall, "stats": st, "peak_bytes": peak, "outs": outs}


MOE_TRAIN_LAYERS = 4        # of OLMoE's 16: f32 masters, gradients and AdamW fit one card


def phase_train_moe(torch, dev):
    """OLMoE-1B-7B at full width and depth MOE_TRAIN_LAYERS trained by
    ``Trainer`` for 4 steps (global batch 8 x 256, f32 masters, remat
    "full", lr 1e-3, warmup 1, seed 0).

    Launches per step, from the code: each block's forward runs its two
    RMSNorms and the router's renormalization on K2, attention on K6 and
    the router's softmax on K9; remat "full" runs each block's forward
    again in the backward (up to its last saved tensor, the experts'
    combine), and the backward runs K7 and K8 once a block; the final
    RMSNorm runs once; the softmax's and the divides' backwards are plain
    torch.  So K2 6L+1, K6 2L, K9 2L, K7 L, K8 L and K3 0.  One more step
    is traced: device busy time, idle share, and the kernel classes, with
    the expert products (the batched products of ``aten::bmm``) a class of
    their own."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_flash_attn as F
    from repro_torch.train import TrainConfig, Trainer

    label = "training moe"
    cfg = get_config("olmoe_1b_7b").replace(n_layers=MOE_TRAIN_LAYERS)
    B, S, steps = 8, 256, 4
    tc = TrainConfig(steps=steps, lr=1e-3, warmup=1, log_every=1, seed=0)
    ds = SyntheticLMDataset(DataConfig(B, S, seed=0), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tc, ds, device=dev)
    n_params = sum(t.numel() for t in [trainer.state["params"]["tok"],
                                       trainer.state["params"]["head"]]
                   + [w for lay in trainer.state["params"]["layers"] for w in lay.values()])
    counters = (ops.posit_div_fused_rowwise, F.posit_flash_attention,
                F.posit_flash_attention_fwd, F.flash_backward_dq, F.flash_backward_dkv,
                ops.posit_softmax_fused)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, k3, k6, k7, k8, k9 = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    losses = [h["loss"] for h in res["history"]]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{label}: losses {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    for name, got, per_step in (("K2", k2, 6 * L + 1), ("K6", k6, 2 * L), ("K9", k9, 2 * L),
                                ("K7", k7, L), ("K8", k8, L), ("K3", k3, 0)):
        check(got == per_step * steps,
              f"{label}: {name} launched {got} times, the path implies {per_step * steps}")
    secs = [h["sec"] for h in res["history"]]
    print(f"{label}: OLMoE-1B-7B at full width, {L} of 16 layers ({n_params / 1e9:.3f} B "
          f"parameters; {cfg.numerics.div_format} {cfg.numerics.div_algo}, f32 masters, remat "
          f"full), {steps} steps of {B}x{S} tokens in {wall:.2f} s; losses "
          f"{[round(x, 4) for x in losses]}; step wall times {[round(x, 3) for x in secs]} s; "
          f"{B * S / min(secs):.1f} tokens/s at the fastest step; launches K2 {k2} (6L+1 a "
          f"step), K6 {k6} (2L), K9 {k9} (2L), K7 {k7} (L), K8 {k8} (L), K3 {k3}; peak device "
          f"memory {peak / 2**30:.2f} GiB")

    batch = {n: torch.from_numpy(x).to(dev) for n, x in ds.batch_at(steps).items()}

    def step():
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        float(metrics["loss"])

    op_ms = {"aten::bmm": 0.0}
    times, traced = profiled(torch, step, [*FLASH_FWD, "flash_bwd"], op_ms=op_ms)
    by = by_class(times, (("K7 flash dq", "flash_bwd_dq_kernel"),
                          ("K8 flash dk/dv", "flash_bwd_dkv_kernel"),
                          ("K6 flash fwd", FLASH_FWD), ("K2 rowwise", "rowwise_kernel"),
                          ("K9 softmax", "softmax_kernel")))
    busy = sum(by.values()) if times else None
    if busy is None:
        print(f"{label} step (traced): wall {traced:.1f} ms; torch.profiler showed no device "
              f"records in {PROFILE_TRIES} tries: busy and idle share not measured")
    else:
        experts = min(op_ms["aten::bmm"], by["matmul"])
        by["matmul"] -= experts
        by = {"expert products (aten::bmm)": experts, **by}
        print("%s step (traced): wall %.1f ms, device busy %.1f ms, idle share %.3f; %s" % (
            label, traced, busy, 1 - busy / traced,
            ", ".join(f"{k} {v:.2f} ms" for k, v in by.items())))
    return {"rowwise": k2, "K6": k6, "K7": k7, "K8": k8, "K9": k9, "losses": losses,
            "step_s": secs, "peak_bytes": peak, "busy_ms": busy, "traced_ms": traced}


HYBRID_NEW = 32             # new tokens a request of the hybrid mix
HYBRID_WRAP_LAYERS = 3      # of RecurrentGemma's 26 in the wrap phase: layer 2 attends
HYBRID_WRAP_SEQ = 2304      # the wrap phase's max_seq: the 2048-key window and 256 rows
HYBRID_WRAP_PROMPT = 2040   # its long prompt, left-padded to 2048 rows
HYBRID_WRAP_NEW = 48        # its new tokens: the ring wraps at the first decode step
HYBRID_FWD_SEQ = 4096       # tokens of the whole-sequence forward
HYBRID_HEADS = (10, 1, 256)  # RecurrentGemma-2B: heads, kv heads, head_dim


def hybrid_model(torch, dev):
    """RecurrentGemma-2B at full width and depth, random bf16 weights from
    seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("recurrentgemma_2b", fused=True)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tensors_of(params))
    print(f"hybrid: RecurrentGemma-2B ({cfg.n_layers} layers, one in {cfg.attn_period} local "
          f"attention over {cfg.local_window} keys, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, RG-LRU width "
          f"{cfg.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab}): {n / 1e9:.3f} B random "
          f"parameters in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return cfg, params


def zero_hybrid_launches():
    from repro_torch.kernels import posit_flash_attn as F

    zero_launches()
    F.posit_flash_attention_fwd.launches = 0


def hybrid_launches():
    """K2's launches and every flash forward's (K3-K6) since the last zero."""
    from repro_torch.kernels import posit_flash_attn as F

    c = read_launches()
    flash = c["K3"] + c["K4"] + c["K5"] + F.posit_flash_attention_fwd.launches
    return c["rowwise"], flash


def products_difference(torch, dev, cfg, params):
    """Which bf16 products of layer 0 and 2 (a recurrent and an attention
    layer) and of the head give a row other bits when more rows ride along:
    a pack's scan steps run them at M = N rows, a solo admission at M = 1,
    a decode step at M = 8."""
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(8, 1, cfg.d_model, generator=g).to(dev, torch.bfloat16)
    rec, att = params["layers"][0], params["layers"][2]
    prods = {f"rec {n}": (lambda a, w=rec["rec"][n]: torch.matmul(a, w))
             for n in ("in_x", "in_gate")}
    prods.update({f"attn {n}": (lambda a, w=att[n]: torch.matmul(a, w))
                  for n in ("wq", "wk", "wv")})
    prods.update({"mlp w1": lambda a: torch.matmul(a, rec["w1"]),
                  "head": lambda a: torch.matmul(a, params["head"])})
    lost = []
    for name, f in prods.items():
        one = f(x[:1])
        for M in (2, 4, 8):
            if not torch.equal(f(x[:M])[:1], one):
                lost.append(f"{name} (M=1 vs {M})")
                break
    print(f"hybrid: products whose row 0 loses its bits when more rows ride along: "
          f"{', '.join(lost) if lost else 'none'}")


def phase_hybrid(torch, dev, cfg, params):
    """Full-width RecurrentGemma-2B (at the depth of ``cfg``:
    HYBRID_SERVE_LAYERS) served from dense slots with batch-axis
    packed admission: the main mix (16 greedy requests, prompts of 16-200
    tokens, 32 new each, 8 slots, max_seq 512), its first 8 submitted and
    the other 8 from the consuming loop at request 0's tokens (mid-flight);
    per forward step (a scan step of a prefill, a decode step) exactly 2L +
    1 K2 launches and no flash launch (the ring buffer's softmax is float,
    as the reference's); the shortest request of each wave (the second
    submitted mid-flight) the same tokens alone on a solo-admission engine;
    K2 at 8 x 2560 the bits of its twin."""
    import numpy as np

    from repro_torch.serve import FinishReason, Request, ServeConfig, ServeEngine, TokenEvent

    reqs = request_mix(cfg)
    lens = np.array([len(r.tokens) for r in reqs])
    sc = ServeConfig.from_model(cfg, packed_prefill=True)
    eng = ServeEngine(cfg, params, sc, device=dev)
    eng.serve([Request(reqs[0].tokens[:8], max_new=2)])   # warm-up, not counted
    torch.cuda.synchronize()
    late = iter(reqs[8:])

    def submit_late(ev):
        if isinstance(ev, TokenEvent) and ev.rid == 0:
            nxt = next(late, None)
            if nxt is not None:
                eng.submit(nxt)
    zero_hybrid_launches()
    t0 = time.perf_counter()
    for r in reqs[:8]:
        eng.submit(r)
    events = drain(eng.serve_stream(), submit_late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, flash = hybrid_launches()
    results = {ev.rid: ev.result for ev in events if type(ev).__name__ == "FinishEvent"}
    check(sorted(results) == list(range(len(reqs))),
          f"hybrid: finished {sorted(results)}, submitted {len(reqs)}")
    outs = [results[i].tokens for i in range(len(reqs))]
    st = eng.last_serve_stats
    L = cfg.n_layers
    forwards = st["prefill_forwards"] + st["decode_steps"]
    check(k2 == (2 * L + 1) * forwards,
          f"hybrid: K2 launched {k2} times, {forwards} forward steps imply "
          f"{(2 * L + 1) * forwards}")
    check(flash == 0, f"hybrid: {flash} flash launches; the ring buffer attends without one")
    check(st["faults"] == 0 and st["shed"] == 0 and st["packed_packs"] > 0,
          f"hybrid: faults, sheds or no pack: {st}")
    for rid, r in results.items():
        check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == HYBRID_NEW,
              f"hybrid: request {rid} finished {r.finish} with {len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"hybrid: request {rid}: token out of the vocabulary")
    n_tok = sum(len(o) for o in outs)
    print(f"hybrid: {L} of 26 layers served {len(reqs)} requests ({cfg.numerics.div_format} "
          f"{cfg.numerics.div_algo}; prompts {lens.min()}-{lens.max()} tokens, {HYBRID_NEW} "
          f"new each; 8 submitted, 8 more at request 0's tokens) on {sc.max_batch} slots, "
          f"batch-axis packed admission: {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.2f} tokens/s; {forwards} forward steps ({st['prefill_forwards']} "
          f"scan steps in {st['packed_packs']} packs of {st['packed_segments']} requests with "
          f"{st['packed_dummies']} dummy rows and {st['admissions'] - st['packed_segments']} "
          f"solo admissions, {st['decode_steps']} decode steps); K2 {k2} launches (2L+1 = "
          f"{2 * L + 1} a forward step), no flash launch")
    # the shortest prompt of each wave, alone (a solo prefill scans its bucket)
    probes = [min(range(0, 8), key=lambda i: lens[i]), min(range(8, 16), key=lambda i: lens[i])]
    solo = ServeEngine(cfg, params, ServeConfig.from_model(cfg), device=dev)
    for i in probes:
        alone = solo.serve([reqs[i]])[0]
        if not np.array_equal(alone, outs[i]):
            products_difference(torch, dev, cfg, params)
            fail(f"hybrid: request {i} alone gave {alone.tolist()}, packed {outs[i].tolist()}")
    print(f"hybrid: requests {probes[0]} (first wave) and {probes[1]} (submitted mid-flight) "
          "alone on a solo-admission engine the same tokens as packed")
    # K2 at the decode step's RMSNorm rows, the bits of its twin
    k2_same_bits(torch, dev, "hybrid", ((8, cfg.d_model),), 8)
    return {"rowwise": k2, "tokens_per_s": n_tok / wall, "forwards": forwards, "outs": outs}


def phase_hybrid_wrap(torch, dev, cfg, params):
    """RecurrentGemma-2B at full width and HYBRID_WRAP_LAYERS of its layers
    (one attention layer), max_seq HYBRID_WRAP_SEQ: a prompt of
    HYBRID_WRAP_PROMPT tokens (left-padded to 2048 rows) decodes past the
    2048-key window, its ring wrapping from the first decode step; its
    tokens alone are the bits of its tokens beside a short request (the
    reference's ``test_hybrid_ring_wrap_batch_invariance``)."""
    import numpy as np

    from repro_torch.serve import Request, ServeConfig, ServeEngine

    L = HYBRID_WRAP_LAYERS
    cut = cfg.replace(n_layers=L)
    check(sum(cut.is_attn_layer(i) for i in range(L)) == 1,
          "hybrid wrap: the cut model must keep one attention layer")
    sub = dict(params, layers=params["layers"][:L])
    rng = np.random.default_rng(4)
    long = Request(rng.integers(0, cfg.vocab, HYBRID_WRAP_PROMPT).astype(np.int32),
                   max_new=HYBRID_WRAP_NEW)
    short = Request(rng.integers(0, cfg.vocab, 20).astype(np.int32), max_new=16)
    eng = ServeEngine(cut, sub, ServeConfig(max_batch=2, max_seq=HYBRID_WRAP_SEQ), device=dev)
    zero_hybrid_launches()
    t0 = time.perf_counter()
    alone = eng.serve([long])[0]
    st = eng.last_serve_stats
    k2, flash = hybrid_launches()
    forwards = st["prefill_forwards"] + st["decode_steps"]
    check(k2 == (2 * L + 1) * forwards and flash == 0,
          f"hybrid wrap: K2 {k2} (want {(2 * L + 1) * forwards}), flash {flash} (want 0)")
    both = eng.serve([long, short])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    W = min(cut.local_window, HYBRID_WRAP_SEQ)
    rows = st["prefill_forwards"] + len(alone) - 1   # rows written, pads included
    check(rows > W, f"hybrid wrap: {rows} rows do not pass the {W}-row ring")
    check(len(alone) == HYBRID_WRAP_NEW and np.array_equal(alone, both[0]),
          f"hybrid wrap: the long request alone {alone.tolist()} and beside a short one "
          f"{both[0].tolist()} differ")
    print(f"hybrid wrap: {L} of {cfg.n_layers} layers (one attention layer, a {W}-row ring), "
          f"a {HYBRID_WRAP_PROMPT}-token prompt in {st['prefill_forwards']} scan steps, "
          f"{HYBRID_WRAP_NEW} new tokens, its ring wrapped {rows - W} rows: the same tokens "
          f"alone and beside a 20-token request ({wall:.1f} s); K2 {k2} launches alone "
          f"(2L+1 a forward step), no flash launch")
    return {"rowwise": k2}


def phase_hybrid_forward(torch, dev, cfg, params):
    """The whole-sequence forward of full-width RecurrentGemma-2B on 1 x
    HYBRID_FWD_SEQ tokens: exactly one K6 launch an attention layer (8),
    2L + 1 K2 launches, finite states of the expected shape; then K6 and K3
    prefill at its attention shape (10/1 heads of 256, window 2048) against
    their twins at posit16, posit32, posit64 (FLASH_TOL) and posit8 (its
    patterns), bf16 K/V and, posit16 and posit64, f32 K/V; the division
    stage bit-exact on the kernel's own acc and l (q = 0 makes every p
    exactly 1 and integer V makes acc and l exact integers, whatever the
    order of the sums)."""
    import numpy as np

    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import posit_flash_attn as F
    from repro_torch.kernels.posit_div import divide_floats_block
    from repro_torch.models import transformer as T

    L = cfg.n_layers
    attn = sum(cfg.is_attn_layer(i) for i in range(L))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (1, HYBRID_FWD_SEQ)))
    fcfg = cfg.replace(remat="none")
    with torch.inference_mode():
        T.forward(params, fcfg, {"tokens": toks[:, :256].to(dev)})   # warm-up, not counted
        torch.cuda.synchronize()
        zero_hybrid_launches()
        t0 = time.perf_counter()
        h = T.forward(params, fcfg, {"tokens": toks.to(dev)})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k6 = F.posit_flash_attention_fwd.launches
    k2, flash = hybrid_launches()
    check(k6 == attn and flash == k6, f"hybrid forward: K6 launched {k6} times, {flash} flash "
                                      f"launches in all; {attn} attention layers imply {attn}")
    check(k2 == 2 * L + 1, f"hybrid forward: K2 launched {k2} times, want {2 * L + 1}")
    check(tuple(h.shape) == (1, HYBRID_FWD_SEQ, cfg.d_model) and bool(torch.isfinite(h).all()),
          f"hybrid forward: states {tuple(h.shape)}, finite {bool(torch.isfinite(h).all())}")
    print(f"hybrid forward: 1 x {HYBRID_FWD_SEQ} tokens through {L} layers in {wall * 1e3:.1f} "
          f"ms ({HYBRID_FWD_SEQ / wall:.0f} tokens/s): K6 {k6} launches (one an attention "
          f"layer, window {cfg.local_window}), K2 {k2}, finite states")
    del h
    # the kernels at the forward's attention shape against their twins
    H, KV, hd = HYBRID_HEADS
    S, win = HYBRID_FWD_SEQ, cfg.local_window
    q, k, v = flash_inputs(torch, dev, 1, S, S, H, KV, hd, 31)
    worst = collections.defaultdict(float)
    i = torch.arange(S, device=dev)
    keep = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < win)
    vi = torch.randint(-8, 9, (1, S, KV, hd), generator=torch.Generator().manual_seed(6))
    acc = torch.einsum("qk,kd->qd", keep.double(), vi[0, :, 0].double().to(dev)).float()
    cnt = keep.sum(-1).float()
    for n in (16, 32, 64, 8):
        fmt = PositFormat(n)
        for kv_dt in ((torch.bfloat16, torch.float32) if n in (16, 64) else (torch.bfloat16,)):
            kk, vv = k.to(kv_dt), v.to(kv_dt)
            where = f"posit{n} hd {hd} window {win} {str(kv_dt)[6:]} K/V"
            o, m, l = F.posit_flash_attention_fwd(fmt, q, kk, vv, True, win)
            po, pm, pl = F.posit_flash_attention_fwd_plain(fmt, q, kk, vv, True, win)
            torch.cuda.synchronize()
            worst[f"K6 posit{n}"] = max(worst[f"K6 posit{n}"], gate("K6", where, fmt, o, po))
            lse = float((m + torch.log(l) - pm - torch.log(pl)).abs().max())
            check(lse <= LSE_TOL, f"K6 {where}: max|lse diff| {lse} > {LSE_TOL}")
            del o, m, l, po, pm, pl
            s0 = torch.tensor([0], dtype=torch.int32, device=dev)
            o = F.posit_flash_attention(fmt, q, kk, vv, True, win, kv_start=s0)
            po = F.posit_flash_attention_plain(fmt, q, kk, vv, True, win, kv_start=s0)
            torch.cuda.synchronize()
            worst[f"K3 posit{n}"] = max(worst[f"K3 posit{n}"], gate("K3", where, fmt, o, po))
            del o, po
            # the division stage on the kernel's own acc and l
            oz, _, lz = F.posit_flash_attention_fwd(fmt, torch.zeros_like(q), kk,
                                                    vi.to(dev, kv_dt), True, win)
            want = divide_floats_block(fmt, acc, cnt[:, None], DEFAULT_VARIANT)
            torch.cuda.synchronize()
            same = all(torch.equal(bits(oz[0, :, h_]), bits(want)) for h_ in range(H))
            check(same and torch.equal(lz.reshape(H, S)[0], cnt),
                  f"K6 {where}: the division stage differs from the twin's divide of the "
                  "kernel's own acc and l")
    print(f"hybrid forward: K6 and K3 prefill at 1 x {S}, {H}/{KV} heads of {hd}, window {win} "
          f"within {FLASH_TOL} of their twins (max|diff| " + ", ".join(
              f"{kern} posit{n} {worst[f'{kern} posit{n}']:.3g}" for n in (16, 32, 64)
              for kern in ("K6", "K3")) + "; posit8 by its patterns; bf16 K/V, and f32 at "
          "posit16 and posit64); the division stage bit-exact on the kernel's own acc and l")
    return {"K6": k6, "rowwise": k2, "err": max(worst.values())}


HYBRID_TRAIN_LAYERS = 6     # of RecurrentGemma's 26: layers 2 and 5 attend
HYBRID_BWD_SEQ = 2560       # the backward's gate: rows past the 2048-key window


def hybrid_backward_gates(torch, dev):
    """K7 and K8 at RecurrentGemma's attention shape (10/1 heads of 256,
    window 2048) on 1 x HYBRID_BWD_SEQ rows, from K6's residuals, against
    their twins: posit16, posit32 and posit64 within BWD_TOL, posit8 by its
    gate (``gate_grad``), on bf16 K/V and, at posit16 and posit64, on f32
    K/V bf16 cannot hold.  Returns the worst max|diff| of each kernel."""
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import posit_flash_attn as F

    H, KV, hd = HYBRID_HEADS
    S, win = HYBRID_BWD_SEQ, 2048
    q, k, v, co = training_inputs(torch, dev, 1, S, 36, H, KV, hd)
    worst = collections.defaultdict(float)
    for n in (16, 32, 64, 8):
        fmt = PositFormat(n)
        plan = F.datapath_plan(fmt, DEFAULT_VARIANT)
        for kv in (("bf16", "f32") if n in (16, 64) else ("bf16",)):
            kk, vv = (k, v) if kv == "bf16" else (f32_values(torch, k, 37),
                                                  f32_values(torch, v, 38))
            o, m, l = F.posit_flash_attention_fwd(fmt, q, kk, vv, True, win)
            args = (q, kk, vv, co, m, l, F._row_sums(co, o), True, win, 0,
                    1.0 / math.sqrt(hd))
            got = (F.flash_backward_dq(fmt, plan, *args), *F.flash_backward_dkv(fmt, plan, *args))
            twin = F.flash_backward_plain(fmt, q, kk.float(), vv.float(), o, co, m, l, True,
                                          win)
            torch.cuda.synchronize()
            for name, g, w in zip(("dq", "dk", "dv"), got, twin):
                kern = "K7" if name == "dq" else "K8"
                where = f"posit{n} hd {hd} window {win} {kv} K/V {name}"
                worst[kern] = max(worst[kern], gate_grad(kern, where, fmt, g, w))
            del o, m, l, got, twin
    print(f"training hybrid: K7 and K8 at 1 x {S}, {H}/{KV} heads of {hd}, window {win} "
          f"within {BWD_TOL} of their twins at posit16, posit32 and posit64 (max|diff| K7 "
          f"{worst['K7']:.3g}, K8 {worst['K8']:.3g}), posit8 by its gate; bf16 K/V, and f32 "
          "at posit16 and posit64")
    return dict(worst)


def hybrid_training_run(torch, dev, cfg, steps, label):
    """``Trainer`` on ``cfg`` for ``steps`` steps of 1 x HYBRID_FWD_SEQ from
    seed 0 (lr 1e-3, warmup 1, the schedule of 4 steps), each step's loss
    and a bit-level fingerprint of every parameter after it recorded, with
    every kernel's launches counted from 0.  Returns the trainer and the
    run's record."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_flash_attn as F
    from repro_torch.optim.tree import tree_items
    from repro_torch.train import TrainConfig, Trainer

    tc = TrainConfig(steps=4, lr=1e-3, warmup=1, log_every=1, seed=0)
    ds = SyntheticLMDataset(DataConfig(1, HYBRID_FWD_SEQ, seed=0), cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tc, ds, device=dev)
    prints = []
    step_fn = trainer.step_fn

    def recorded(state, batch):
        state, metrics = step_fn(state, batch)
        prints.append((float(metrics["loss"]), {
            key: int(bits(t).to(torch.int64).sum()) for key, t in tree_items(state["params"])}))
        return state, metrics

    trainer.step_fn = recorded
    counters = {"K2": ops.posit_div_fused_rowwise, "K6": F.posit_flash_attention_fwd,
                "K7": F.flash_backward_dq, "K8": F.flash_backward_dkv,
                "K9": ops.posit_softmax_fused, "K12r": ops.posit_round_value}
    zero_launches()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = trainer.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer.step_fn = step_fn
    got = {name: c.launches for name, c in counters.items()}
    flash = read_launches()
    got.update(K3=flash["K3"], K4=flash["K4"], K5=flash["K5"])
    losses = [h["loss"] for h in res["history"]]
    return trainer, {"label": label, "losses": losses, "prints": prints, "launches": got,
                     "step_s": [h["sec"] for h in res["history"]], "wall": wall,
                     "peak_bytes": torch.cuda.max_memory_allocated(), "ds": ds}


def phase_train_hybrid(torch, dev):
    """RecurrentGemma-2B at full width and HYBRID_TRAIN_LAYERS of its 26
    layers (layers 0, 1, 3, 4 RG-LRU, 2 and 5 local attention over 2048
    keys) trained by ``Trainer`` on 1 x HYBRID_FWD_SEQ tokens (f32
    masters, lr 1e-3, warmup 1, seed 0).

    Launches per step, from the code: every block (RG-LRU or attention)
    runs its two RMSNorms on K2, remat "full" runs each block's forward
    again in the backward, and the final RMSNorm runs once: K2 4L+1; each
    attention layer runs K6 in its forward and its recompute and K7 and K8
    once in the backward: K6 2 L_attn = 4, K7 = K8 = L_attn = 2; the RG-LRU
    has no division, the loss no posit kernel: no K3, K4, K5 or K9.

    Four steps at remat "full" (falling finite losses, the exact launches),
    one more traced; two steps at "dots" from the same seed, whose losses
    and parameters must be the "full" run's bits (the same launches: K6 is
    recomputed, as the reference's custom_vjp under ``checkpoint_dots``);
    two steps with ``grad_compress_format="posit16"``: one K12 round launch
    a gradient leaf a step, and step 1's rounded gradients the bits of the
    twin chain (quantize, dequantize) on the same gradients."""
    from repro_torch.configs import get_config
    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import posit_cast as cast
    from repro_torch.optim.tree import tree_items, tree_leaves
    from repro_torch.train import trainer as trainer_mod

    label = "training hybrid"
    gates = hybrid_backward_gates(torch, dev)
    torch.cuda.empty_cache()
    cfg = get_config("recurrentgemma_2b").replace(n_layers=HYBRID_TRAIN_LAYERS)
    L = cfg.n_layers
    La = sum(cfg.is_attn_layer(i) for i in range(L))
    steps = 4
    trainer, full = hybrid_training_run(torch, dev, cfg, steps, "full")
    params = trainer.state["params"]
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_leaves = len(tree_leaves(params))
    losses = full["losses"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{label}: losses {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    want = {"K2": 4 * L + 1, "K6": 2 * La, "K7": La, "K8": La, "K3": 0, "K4": 0, "K5": 0,
            "K9": 0, "K12r": 0}
    for name, per_step in want.items():
        check(full["launches"][name] == per_step * steps,
              f"{label}: {name} launched {full['launches'][name]} times, the path implies "
              f"{per_step * steps}")
    secs = full["step_s"]
    print(f"{label}: RecurrentGemma-2B at full width, {L} of 26 layers ({La} local attention, "
          f"{L - La} RG-LRU; {n_params / 1e9:.3f} B parameters, {n_leaves} leaves; "
          f"{cfg.numerics.div_format} {cfg.numerics.div_algo}, f32 masters, remat full), "
          f"{steps} steps of 1x{HYBRID_FWD_SEQ} tokens in {full['wall']:.2f} s; losses "
          f"{[round(x, 4) for x in losses]}; step wall times {[round(x, 3) for x in secs]} s "
          f"(each step's parameters fingerprinted, inside the step times); "
          f"{HYBRID_FWD_SEQ / min(secs):.1f} tokens/s at the fastest step; launches a step "
          + ", ".join(f"{k} {v // steps}" for k, v in full["launches"].items())
          + f" (K2 4L+1, K6 2L_attn, K7 and K8 L_attn); peak device memory "
          f"{full['peak_bytes'] / 2**30:.2f} GiB")

    # one more step under the profiler (not counted above)
    batch = {n: torch.from_numpy(x).to(dev) for n, x in full["ds"].batch_at(steps).items()}

    def step():
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        float(metrics["loss"])

    times, traced = profiled(torch, step, [*FLASH_FWD, "flash_bwd"])
    by = by_class(times, (("K7 flash dq", "flash_bwd_dq_kernel"),
                          ("K8 flash dk/dv", "flash_bwd_dkv_kernel"),
                          ("K6 flash fwd", FLASH_FWD), ("K2 rowwise", "rowwise_kernel")))
    busy = sum(by.values()) if times else None
    if busy is None:
        print(f"{label} step (traced): wall {traced:.1f} ms; torch.profiler showed no device "
              f"records in {PROFILE_TRIES} tries: busy and idle share not measured")
    else:
        print("%s step (traced): wall %.1f ms, device busy %.1f ms, idle share %.3f; %s" % (
            label, traced, busy, 1 - busy / traced,
            ", ".join(f"{k} {v:.2f} ms" for k, v in by.items())))
    del trainer, params, batch
    # remat "dots" from the same seed: the "full" run's bits, step by step
    trainer, dots = hybrid_training_run(torch, dev, cfg.replace(remat="dots"), 2, "dots")
    del trainer
    for k, got in dots["launches"].items():
        check(got == want[k] * 2, f"{label} dots: {k} launched {got} times, want {want[k] * 2}")
    same_training(f"{label} dots", dots, {"prints": full["prints"][:2]}, "the remat full run's")
    print(f"{label} dots: 2 steps, losses {[round(x, 4) for x in dots['losses']]}, every "
          f"step's loss and parameters the remat full run's bits; peak device memory "
          f"{dots['peak_bytes'] / 2**30:.2f} GiB (remat full: "
          f"{full['peak_bytes'] / 2**30:.2f} GiB); step wall times "
          f"{[round(x, 3) for x in dots['step_s']]} s")
    # posit16 gradient compression: K12's round kernel once a leaf, step 1's
    # rounded gradients the twin chain's bits
    seen = {}
    compress = trainer_mod.compress_gradients

    def checked(grads, fmt_name):
        out = compress(grads, fmt_name)
        if not seen:
            off = 0
            for (key, g), r in zip(tree_items(grads), tree_leaves(out)):
                gf, rf = g.reshape(-1), r.reshape(-1)
                for i in range(0, gf.numel(), 1 << 24):
                    twin = cast.dequantize_plain(POSIT16, cast.quantize_plain(
                        POSIT16, gf[i:i + (1 << 24)]))
                    got = rf[i:i + (1 << 24)]
                    nan = torch.isnan(twin)
                    bad = int((torch.isnan(got) != nan).sum()
                              + (bits(got[~nan]) != bits(twin[~nan])).sum())
                    check(bad == 0, f"{label} posit16: {key}: {bad} rounded gradients differ "
                                    "from the twin's")
                off += gf.numel()
            seen["elements"] = off
        return out

    trainer_mod.compress_gradients = checked
    try:
        trainer, comp = hybrid_training_run(
            torch, dev, cfg.with_numerics(grad_compress_format="posit16"), 2, "posit16")
    finally:
        trainer_mod.compress_gradients = compress
    del trainer
    check(comp["launches"]["K12r"] == n_leaves * 2,
          f"{label} posit16: K12 round launched {comp['launches']['K12r']} times, want one a "
          f"gradient leaf a step ({n_leaves * 2})")
    check(all(math.isfinite(x) for x in comp["losses"]), f"{label} posit16: {comp['losses']}")
    print(f"{label} posit16 gradients: 2 steps, losses {[round(x, 4) for x in comp['losses']]} "
          f"(uncompressed {[round(x, 4) for x in losses[:2]]}); K12 round {comp['launches']['K12r']}"
          f" launches (one a leaf a step, {n_leaves} leaves); step 1's {seen['elements']} "
          f"rounded gradients the twin's bits; peak device memory "
          f"{comp['peak_bytes'] / 2**30:.2f} GiB; step wall times "
          f"{[round(x, 3) for x in comp['step_s']]} s")
    out = {"K2": full["launches"]["K2"] + dots["launches"]["K2"] + comp["launches"]["K2"],
           "err": gates, "losses": losses, "step_s": secs, "peak_bytes": full["peak_bytes"],
           "dots_peak_bytes": dots["peak_bytes"], "busy_ms": busy, "traced_ms": traced,
           "K12r": comp["launches"]["K12r"], "n_leaves": n_leaves}
    for k in ("K6", "K7", "K8"):
        out[k] = full["launches"][k] + dots["launches"][k] + comp["launches"][k]
    out["rowwise"] = out["K2"]
    return out


def hybrid_rows(torch, dev):
    """K6, K3 prefill, K7 and K8 at RecurrentGemma's attention shape (1 x
    4096, 10/1 heads of 256, window 2048, posit16): device and call time,
    the plain twin's, the bound and SDPA (forward; backward for K7 and K8
    together) with the window as a boolean mask."""
    import torch.nn.functional as Fn

    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import posit_flash_attn as F
    from repro_torch.kernels.posit_div import datapath_plan

    H, KV, hd = HYBRID_HEADS
    S, win = HYBRID_FWD_SEQ, 2048
    plan = datapath_plan(POSIT16, DEFAULT_VARIANT)
    q, k, v = flash_inputs(torch, dev, 1, S, S, H, KV, hd, 32)
    keys = sum(min(i + 1, win) for i in range(S))          # attended (row, key) pairs
    i = torch.arange(S, device=dev)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < win)
    qs, ks, vs = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))
    lib = lambda: Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_ms = device_call_ms(torch, lib, iters=5)
    s0 = torch.tensor([0], dtype=torch.int32, device=dev)
    rows = {}
    for name, call, plain, extra in (
            ("K6 hd256 window", lambda: F.posit_flash_attention_fwd(POSIT16, q, k, v, True, win),
             lambda: F.posit_flash_attention_fwd_plain(POSIT16, q, k, v, True, win), 8 * S * H),
            ("K3 hd256 window prefill",
             lambda: F.posit_flash_attention(POSIT16, q, k, v, True, win, kv_start=s0),
             lambda: F.posit_flash_attention_plain(POSIT16, q, k, v, True, win, kv_start=s0),
             0)):
        dev_ms, src = device_kernel_ms(torch, call, FLASH_FWD, iters=5)
        # q read, o written (and m, l for K6), K and V read once
        nbytes = 8 * S * H * hd + extra + 2 * k.element_size() * S * KV * hd
        bms, by = bound_ms(nbytes, div_ops(plan, S * H * hd), 4 * H * keys * hd)
        rows[name] = {"shape": [1, S, S, H, KV, hd], "ms": dev_ms, "ms_from": src,
                      "call_ms": cuda_time_ms(call, iters=5),
                      "plain_ms": cuda_time_ms(plain, iters=2, warmup=1),
                      "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
    # the backward from K6's residuals; SDPA's backward on the same mask
    co = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(35))
    o, m, l = F.posit_flash_attention_fwd(POSIT16, q, k, v, True, win)
    args = (q, k, v, co, m, l, F._row_sums(co, o), True, win, 0, 1.0 / math.sqrt(hd))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qs, ks, vs))
    out = Fn.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)
    gs = co.transpose(1, 2).contiguous()
    lib_bwd = device_call_ms(torch, lambda: torch.autograd.grad(out, (qg, kg, vg), gs,
                                                                retain_graph=True), iters=5)
    plain_bwd = cuda_time_ms(lambda: F.flash_backward_plain(POSIT16, q, k, v, o, co, m, l, True,
                                                            win), iters=2, warmup=1)
    qo, kv = 4 * S * H * hd, k.element_size() * S * KV * hd
    rowv = 4 * H * S
    pairs = H * keys
    for name, call, kern, nbytes, flops in (
            ("K7 hd256 window", lambda: F.flash_backward_dq(POSIT16, plan, *args),
             "flash_bwd_dq_kernel", 3 * qo + 2 * kv + 3 * rowv, 6 * hd),
            ("K8 hd256 window", lambda: F.flash_backward_dkv(POSIT16, plan, *args),
             "flash_bwd_dkv_kernel", 2 * qo + 2 * kv + 3 * rowv + 2 * 2 * kv, 8 * hd)):
        dev_ms, src = device_kernel_ms(torch, call, [kern], iters=5)
        bms, by = bound_ms(nbytes, div_ops(plan, pairs), pairs * flops)
        rows[name] = {"shape": [1, S, S, H, KV, hd], "ms": dev_ms, "ms_from": src,
                      "call_ms": cuda_time_ms(call, iters=5), "plain_ms": plain_bwd,
                      "bound_ms": bms, "bound_by": by, "library_ms": lib_bwd}
    # gradient compression: K12's round kernel on one f32 gradient leaf (an
    # MLP matrix, 2560 x 7680), posit16
    from repro_torch.kernels import ops

    grad = torch.randn(2560, 7680, device=dev, generator=torch.Generator(
        device=dev).manual_seed(39)) * 1e-3
    call = lambda: ops.posit_round_value(POSIT16, grad)
    dev_ms, src = device_kernel_ms(torch, call, ["posit_round_kernel"], iters=20)
    bms, by = bound_ms(8 * grad.numel(), ROUND_OPS * grad.numel())
    rows["K12 round gradient leaf"] = {
        "shape": list(grad.shape), "ms": dev_ms, "ms_from": src, "call_ms": cuda_time_ms(call),
        "plain_ms": cuda_time_ms(lambda: ops.posit_round_plain(POSIT16, grad), iters=5),
        "bound_ms": bms, "bound_by": by, "library_ms": None}
    print_rows(rows)
    return rows


SSM_REQUESTS = 8            # requests of the ssm mix: 4 submitted, 4 more mid-flight
SSM_NEW = 16                # new tokens a request of the ssm mix
SSM_LONG_SEQ = 524288       # the long_500k cell's max_seq
SSM_FWD_SEQ = 4096          # tokens of the whole-sequence forward
SSM_CHECK_SEQ = 256         # the forward against the scanned prefill: tokens,
SSM_CHECK_LAYERS = 4        # layers of 64 (f32 compute, as the CPU test)
SSM_DECODE_RTOL = 2e-3      # tests/test_torch_ssm.py's decode-against-forward bound
SSM_K2_SHAPES = ((8, 2560), (8, 5120), (4096, 5120))   # K2's rows: d_model, d_inner


def ssm_model(torch, dev):
    """Mamba2-2.7B at full width and depth, random bf16 weights from seed
    0."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("mamba2-2.7b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tensors_of(params))
    print(f"ssm: Mamba2-2.7B ({cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, {cfg.ssm_heads} heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, "
          f"{cfg.ssm_groups} group, chunk {cfg.ssm_chunk}, conv width {cfg.conv_width}, vocab "
          f"{cfg.vocab} padded to {cfg.padded_vocab}): {n / 1e9:.3f} B random parameters in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "on the card")
    return cfg, params


def ssm_mix(cfg):
    """SSM_REQUESTS greedy requests, prompts of 16-64 tokens, SSM_NEW new
    tokens each (seed 9)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(9)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=SSM_NEW)
            for n in rng.integers(16, 65, SSM_REQUESTS)]


def k2_same_bits(torch, dev, label, shapes, seed):
    """K2 (posit16) at each (R, C) of ``shapes`` the bits of its twin."""
    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import ops

    g = torch.Generator(device="cpu").manual_seed(seed)
    for R, C in shapes:
        a = torch.randn(R, C, generator=g).to(dev)
        b = (torch.rand(R, 1, generator=g) + 0.5).to(dev)
        got = ops.posit_div_fused_rowwise(POSIT16, a, b)
        want = ops.posit_div_rowwise_plain(POSIT16, a, b)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"{label}: K2 at {R} x {C} differs from its twin")
    print(f"{label}: K2 at " + ", ".join(f"{R} x {C}" for R, C in shapes)
          + " bit-identical to its twin")


def ssm_products_difference(torch, dev, cfg, params):
    """Which bf16 products of layer 0 give row 0 other bits when more rows
    ride along (a pack's scan steps run them at M = N rows, a solo
    admission at M = 1)."""
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(8, 1, cfg.d_model, generator=g).to(dev, torch.bfloat16)
    y = torch.randn(8, 1, cfg.d_inner, generator=g).to(dev, torch.bfloat16)
    p = params["layers"][0]["ssm"]
    prods = {"in_proj": lambda M: torch.matmul(x[:M], p["in_proj"]),
             "out_proj": lambda M: torch.matmul(y[:M], p["out_proj"]),
             "head": lambda M: torch.matmul(x[:M], params["head"])}
    lost = [f"{n} (M=1 vs {M})" for n, f in prods.items() for M in (2, 4, 8)
            if not torch.equal(f(M)[:1], f(1))]
    print(f"ssm: products whose row 0 loses its bits when more rows ride along: "
          f"{', '.join(lost) if lost else 'none'}")


def phase_ssm(torch, dev, cfg, params):
    """Full-width Mamba2-2.7B at all its layers served from 8 dense slots
    with batch-axis packed admission (posit16): the ssm mix, its first 4
    requests submitted and the other 4 from the consuming loop at request
    0's tokens (mid-flight); every request finishes with SSM_NEW tokens of
    the vocabulary; per forward step (a scan step of a prefill, a decode
    step) exactly 2L + 1 K2 launches and no flash launch; the shortest
    request of each wave alone on a solo-admission engine its packed tokens,
    and the second of them on a ``kv_layout="paged"`` engine, which serves
    the family from dense slots (the reference's
    ``test_paged_recurrent_families_fall_back``); K2 at the decode step's
    rows against its twin; a traced decode step of 8 slots."""
    import numpy as np

    from repro_torch.serve import FinishReason, Request, ServeConfig, ServeEngine, TokenEvent

    reqs = ssm_mix(cfg)
    lens = np.array([len(r.tokens) for r in reqs])
    sc = ServeConfig.from_model(cfg, packed_prefill=True)
    eng = ServeEngine(cfg, params, sc, device=dev)
    eng.serve([Request(reqs[0].tokens[:8], max_new=2)])   # warm-up, not counted
    torch.cuda.synchronize()
    half = SSM_REQUESTS // 2
    late = iter(reqs[half:])

    def submit_late(ev):
        if isinstance(ev, TokenEvent) and ev.rid == 0:
            nxt = next(late, None)
            if nxt is not None:
                eng.submit(nxt)
    zero_hybrid_launches()
    t0 = time.perf_counter()
    for r in reqs[:half]:
        eng.submit(r)
    events = drain(eng.serve_stream(), submit_late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, flash = hybrid_launches()
    results = {ev.rid: ev.result for ev in events if type(ev).__name__ == "FinishEvent"}
    check(sorted(results) == list(range(len(reqs))),
          f"ssm: finished {sorted(results)}, submitted {len(reqs)}")
    outs = [results[i].tokens for i in range(len(reqs))]
    st = eng.last_serve_stats
    L = cfg.n_layers
    forwards = st["prefill_forwards"] + st["decode_steps"]
    check(k2 == (2 * L + 1) * forwards,
          f"ssm: K2 launched {k2} times, {forwards} forward steps imply {(2 * L + 1) * forwards}")
    check(flash == 0, f"ssm: {flash} flash launches; the family has no attention")
    check(st["faults"] == 0 and st["shed"] == 0 and st["packed_packs"] > 0,
          f"ssm: faults, sheds or no pack: {st}")
    for rid, r in results.items():
        check(r.finish is FinishReason.MAX_NEW and len(r.tokens) == SSM_NEW,
              f"ssm: request {rid} finished {r.finish} with {len(r.tokens)} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()),
              f"ssm: request {rid}: token out of the vocabulary")
    n_tok = sum(len(o) for o in outs)
    print(f"ssm: {L} layers served {len(reqs)} requests ({cfg.numerics.div_format} "
          f"{cfg.numerics.div_algo}; prompts {lens.min()}-{lens.max()} tokens, {SSM_NEW} new "
          f"each; {half} submitted, {len(reqs) - half} more at request 0's tokens) on "
          f"{sc.max_batch} slots, batch-axis packed admission: {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.2f} tokens/s; {forwards} forward steps ({st['prefill_forwards']} "
          f"scan steps in {st['packed_packs']} packs of {st['packed_segments']} requests with "
          f"{st['packed_dummies']} dummy rows and {st['admissions'] - st['packed_segments']} "
          f"solo admissions, {st['decode_steps']} decode steps); K2 {k2} launches (2L+1 = "
          f"{2 * L + 1} a forward step), no flash launch")
    probes = [min(range(0, half), key=lambda i: lens[i]),
              min(range(half, len(reqs)), key=lambda i: lens[i])]
    solo = ServeEngine(cfg, params, ServeConfig.from_model(cfg), device=dev)
    alone = {}
    for i in probes:
        alone[i] = solo.serve([reqs[i]])[0]
        if not np.array_equal(alone[i], outs[i]):
            ssm_products_difference(torch, dev, cfg, params)
            fail(f"ssm: request {i} alone gave {alone[i].tolist()}, packed {outs[i].tolist()}")
    paged = ServeEngine(cfg, params, ServeConfig.from_model(cfg, kv_layout="paged",
                                                             packed_prefill=True), device=dev)
    got = paged.serve([reqs[probes[1]]])[0]
    check(not paged._paged and paged.last_serve_stats["kv_layout"] == "dense"
          and np.array_equal(got, outs[probes[1]]),
          f"ssm: kv_layout='paged' gave {got.tolist()} for request {probes[1]} "
          f"({paged.last_serve_stats['kv_layout']} layout), packed {outs[probes[1]].tolist()}")
    print(f"ssm: requests {probes[0]} (first wave) and {probes[1]} (submitted mid-flight) alone "
          f"on a solo-admission engine the same tokens as packed; request {probes[1]} under "
          "kv_layout='paged' served from dense slots, the same tokens")
    k2_same_bits(torch, dev, "ssm", SSM_K2_SHAPES[:2], 8)
    step = decode_breakdown(torch, dev, cfg, params)
    return {"rowwise": k2, "tokens_per_s": n_tok / wall, "forwards": forwards, "outs": outs,
            "alone": alone[probes[1]], "probe": reqs[probes[1]], "step": step}


def phase_ssm_long(torch, dev, cfg, params, probe, alone):
    """The long_500k property: the 8-slot decode cache at max_seq
    SSM_LONG_SEQ has exactly the bytes it has at 512 (the SSD's conv window
    and state, no rows a position), and an engine at that max_seq serves
    ``probe`` with the tokens it had alone at max_seq 512, 2L + 1 K2
    launches a forward step."""
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeConfig, ServeEngine

    nbytes = lambda c: sum(t.numel() * t.element_size() for t in T.cache_leaves(c))
    sizes = {}
    for seq in (512, SSM_LONG_SEQ):
        c = T.init_cache(cfg, 8, seq, device=dev)
        sizes[seq] = nbytes(c)
        del c
    check(sizes[512] == sizes[SSM_LONG_SEQ],
          f"ssm long: the decode cache holds {sizes[SSM_LONG_SEQ]} bytes at max_seq "
          f"{SSM_LONG_SEQ}, {sizes[512]} at 512")
    eng = ServeEngine(cfg, params, ServeConfig.from_model(cfg, max_seq=SSM_LONG_SEQ), device=dev)
    zero_hybrid_launches()
    t0 = time.perf_counter()
    got = eng.serve([probe])[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, flash = hybrid_launches()
    st = eng.last_serve_stats
    forwards = st["prefill_forwards"] + st["decode_steps"]
    L = cfg.n_layers
    check(k2 == (2 * L + 1) * forwards and flash == 0,
          f"ssm long: K2 {k2} (want {(2 * L + 1) * forwards}), flash {flash} (want 0)")
    check(np.array_equal(got, alone), f"ssm long: max_seq {SSM_LONG_SEQ} gave {got.tolist()}, "
                                      f"max_seq 512 {alone.tolist()}")
    print(f"ssm long: the 8-slot decode cache holds {sizes[512] / 2**30:.3f} GiB at max_seq 512 "
          f"and at {SSM_LONG_SEQ}; one request ({len(probe.tokens)}-token prompt, {len(got)} "
          f"new) served at max_seq {SSM_LONG_SEQ} in {wall:.2f} s ({forwards} forward steps, "
          f"K2 {k2} launches), the tokens it had at 512")
    return {"rowwise": k2}


def phase_ssm_forward(torch, dev, cfg, params):
    """The whole-sequence forward of full-width Mamba2-2.7B on 1 x
    SSM_FWD_SEQ tokens through all its layers (the chunked SSD, chunks of
    256): exactly 2L + 1 K2 launches, no flash launch, finite states of the
    expected shape; at SSM_CHECK_SEQ tokens and SSM_CHECK_LAYERS layers
    with f32 compute, the forward's last-position logits against the
    scanned prefill's (the recurrence a token at a time) within
    SSM_DECODE_RTOL; K2 at every SSM_K2_SHAPES the bits of its twin."""
    import numpy as np

    from repro_torch.models import layers as Lyr
    from repro_torch.models import transformer as T

    L = cfg.n_layers
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (1, SSM_FWD_SEQ)))
    fcfg = cfg.replace(remat="none")
    with torch.inference_mode():
        T.forward(params, fcfg, {"tokens": toks[:, :256].to(dev)})   # warm-up, not counted
        torch.cuda.synchronize()
        zero_hybrid_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        h = T.forward(params, fcfg, {"tokens": toks.to(dev)})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    k2, flash = hybrid_launches()
    check(k2 == 2 * L + 1 and flash == 0,
          f"ssm forward: K2 launched {k2} times (want {2 * L + 1}), flash {flash} (want 0)")
    ok = tuple(h.shape) == (1, SSM_FWD_SEQ, cfg.d_model) and bool(torch.isfinite(h).all())
    check(ok, f"ssm forward: states {tuple(h.shape)}, finite {bool(torch.isfinite(h).all())}")
    print(f"ssm forward: 1 x {SSM_FWD_SEQ} tokens through {L} layers in {wall * 1e3:.1f} ms "
          f"({SSM_FWD_SEQ / wall:.0f} tokens/s), {peak / 2**30:.2f} GiB above the weights at its "
          f"peak: K2 {k2} launches (2L+1), no flash launch, finite states")
    del h
    # the chunked SSD against the recurrence, f32 compute at a cut depth
    ccfg, cparams = cut_model(fcfg, params, SSM_CHECK_LAYERS)
    x = toks[:, :SSM_CHECK_SEQ].to(dev)
    keep = Lyr.COMPUTE_DTYPE
    Lyr.COMPUTE_DTYPE = torch.float32
    try:
        with torch.inference_mode():
            full = Lyr.logits(cparams["head"], T.forward(cparams, ccfg, {"tokens": x})[:, -1:])
            cache = T.init_cache(ccfg, 1, SSM_CHECK_SEQ, device=dev, dtype=torch.float32)
            lg, _ = T.prefill(cparams, ccfg, x, cache)
    finally:
        Lyr.COMPUTE_DTYPE = keep
    full, lg = full.float()[..., :cfg.vocab], lg.float()[..., :cfg.vocab]
    err = float((lg - full).abs().max() / full.abs().max())
    check(bool(torch.isfinite(lg).all()) and err < SSM_DECODE_RTOL,
          f"ssm forward: the scanned prefill's last logits {err:.3g} of max|logit| from the "
          f"forward's (bound {SSM_DECODE_RTOL})")
    print(f"ssm forward: at 1 x {SSM_CHECK_SEQ} and {SSM_CHECK_LAYERS} layers, f32 compute, the "
          f"scanned prefill's last logits within {err:.3g} of max|logit| of the chunked "
          f"forward's (bound {SSM_DECODE_RTOL})")
    k2_same_bits(torch, dev, "ssm forward", SSM_K2_SHAPES, 9)
    return {"rowwise": k2, "err": err, "wall_ms": wall * 1e3}


def ssm_rows(torch, dev):
    """K2 at Mamba2-2.7B's rows (SSM_K2_SHAPES, posit16): device and call
    time, the twin's, the bound and torch.div's."""
    g = torch.Generator(device="cpu").manual_seed(36)
    rows = {f"K2 {R}x{C}": k2_row(torch, dev, g, R, C) for R, C in SSM_K2_SHAPES}
    print_rows(rows)
    return rows


# --------------------------------------------------------------- phase 5


PROFILE_TRIES = 3
MATMUL_NAMES = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "sm90")
# the flash forward's kernels (csrc/posit_flash_attn.cu): the decode loop
# (K3 with q_pos, K4) and the tile loop (K3 prefill, K5, K6); a parent
# checkout of the port before the decode loop has the one-row loop
# (flash_kernel) in its place.  A name missing here leaves a row's device
# time to CUDA events.
FLASH_FWD = ["flash_decode_kernel", "flash_kernel", "flash_tile_kernel"]


def profiled(torch, fn, want, counts=None, op_ms=None):
    """Run ``fn()`` under torch.profiler; return ``({kernel: device ms}, wall
    ms)`` over the CUDA kernels the trace shows (and fill ``counts`` with
    the launches it recorded of each, ``op_ms`` with the device ms of the
    kernels launched by each aten op it names, e.g. ``aten::bmm``).  A trace that shows none of the
    kernels named in ``want`` is taken again, up to PROFILE_TRIES times:
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
        if counts is not None:
            counts.clear()
        if op_ms is not None:
            for name in op_ms:
                op_ms[name] = sum(e.device_time_total for e in prof.events()
                                  if e.name == name) / 1e3
        for e in prof.key_averages():
            events += 1
            if str(getattr(e, "device_type", "")).endswith("CUDA") and e.self_device_time_total:
                times[e.key] = times.get(e.key, 0.0) + e.self_device_time_total / 1e3
                if counts is not None:
                    counts[e.key] = counts.get(e.key, 0) + e.count
        if any(w in k for k in times for w in want):
            return times, wall
        print(f"profiler: try {attempt + 1} of {PROFILE_TRIES} showed no {want} among "
              f"{len(times)} device kernels ({events} events)", file=sys.stderr)
    return {}, wall


def by_class(times, classes):
    """Sum ``times`` into the named classes (the first whose substring, or
    one of whose substrings, the kernel's name holds), then matmul and
    other."""
    by = dict.fromkeys([c for c, _ in classes] + ["matmul", "other"], 0.0)
    subs = lambda sub: [sub] if isinstance(sub, str) else sub
    for key, t in times.items():
        k = key.lower()
        cls = next((c for c, sub in classes if any(x in k for x in subs(sub))), None)
        if cls is None:
            cls = "matmul" if any(w in k for w in MATMUL_NAMES) else "other"
        by[cls] += t
    return by


def device_kernel_ms(torch, fn, names, iters=20):
    """Device time per launch of the CUDA kernel whose name holds one of
    ``names`` (each call launches one), and where it comes from:
    torch.profiler, the mean over the launches the trace recorded (one
    trace has kept only part of them), or, where no trace shows them, CUDA
    events around the calls (launch gaps included)."""
    for _ in range(3):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    counts = {}
    times, _ = profiled(torch, calls, names, counts)
    keys = [k for k in times if any(n in k for n in names)]
    total, seen = sum(times[k] for k in keys), sum(counts[k] for k in keys)
    if total > 0:
        return total / seen, ("torch.profiler" if seen == iters else
                              f"torch.profiler, {seen} of {iters} launches traced")
    return cuda_time_ms(fn, iters), "CUDA events"


def device_call_launches(torch, fn, iters=20):
    """``(device ms, launches)`` per call of ``fn()`` that launches several
    kernels (a library call's forward or backward, the posit-KV rounding):
    each kernel's mean launch time from torch.profiler times its launches
    per call, summed, so a trace that kept only part of the launches still
    counts each call whole; CUDA events around the calls (launches None)
    where no trace shows a kernel.  Host gaps make the events' time of such
    a call spread: SDPA's backward at the training shape took 0.64 to 1.14
    ms so in runs on an H100."""
    for _ in range(3):
        fn()
    counts = {}
    times, _ = profiled(torch, lambda: [fn() for _ in range(iters)], [""], counts)
    if times:
        per_call = {k: max(1, round(counts[k] / iters)) for k in times}
        return (sum(t / counts[k] * per_call[k] for k, t in times.items()),
                sum(per_call.values()))
    return cuda_time_ms(fn, iters), None


def device_call_ms(torch, fn, iters=20):
    """The device ms of ``device_call_launches``."""
    return device_call_launches(torch, fn, iters)[0]


def k2_row(torch, dev, g, R, C, fmt=None):
    """K2's timing row at R x C (posit16 unless ``fmt``), inputs drawn from
    ``g``: device and call time, the twin's, the bound and torch.div's."""
    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import datapath_plan

    fmt = fmt or POSIT16
    a = torch.randn(R, C, generator=g).to(dev)
    b = (torch.rand(R, 1, generator=g) + 0.5).to(dev)
    call = lambda: ops.posit_div_fused_rowwise(fmt, a, b)
    dev_ms, src = device_kernel_ms(torch, call, ["rowwise_kernel"])
    bms, by = bound_ms(8 * R * C + 4 * R, div_ops(datapath_plan(fmt, DEFAULT_VARIANT), R * C))
    # the yardstick: the same row-broadcast division in f32, no posit
    lib_ms, lib_src = device_kernel_ms(torch, lambda: torch.div(a, b), ["DivFunctor"])
    return {"shape": [R, C], "ms": dev_ms, "ms_from": src,
            "call_ms": cuda_time_ms(call),
            "plain_ms": cuda_time_ms(lambda: ops.posit_div_rowwise_plain(fmt, a, b), iters=5),
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, "library_from": lib_src}


def phase_timing(torch, dev):
    from repro_torch.core.posit import POSIT8, POSIT16, POSIT32, POSIT64
    from repro_torch.kernels.posit_div import datapath_plan

    plan = datapath_plan(POSIT16, "srt_r4_cs_of_fr")
    g = torch.Generator(device="cpu").manual_seed(5)
    rows = {}

    rowwise_row = lambda R, C, fmt=POSIT16: k2_row(torch, dev, g, R, C, fmt)

    rows["K2 decode"] = rowwise_row(8, 960)
    rows["K2 prefill"] = rowwise_row(256, 960)
    rows["K1"] = rowwise_row(1024, 1024)
    rows["K3 decode"] = flash_row(torch, dev, plan, 8, 1, 512, DECODE_POS,
                                  [0, 0, 5, 3, 9, 0, 14, 31])
    rows["K3 prefill"] = flash_row(torch, dev, plan, 1, 256, 256, [0], [56])
    rows["K3 f32 K/V decode"] = flash_row(torch, dev, plan, 8, 1, 512, DECODE_POS,
                                          [0, 0, 5, 3, 9, 0, 14, 31], kv_f32=True)
    # OLMoE's decode (16/16 heads of 128), dense and paged, timed here and
    # not after the MoE phase: there the profiler's sessions have come back
    # without device records, which left the row to CUDA events
    rows["K3 decode hd128"] = flash_row(torch, dev, plan, 8, 1, 512, DECODE_POS,
                                        [0, 0, 5, 3, 9, 0, 14, 31], MOE_HEADS)
    rows["K4 decode hd128"] = paged_row(torch, dev, POSIT16, DEFAULT_VARIANT, MOE_HEADS)
    rows["K3 f32 K/V prefill"] = flash_row(torch, dev, plan, 1, 256, 256, [0], [56],
                                           kv_f32=True)
    # the two-word frame on the model path: posit64 at the same shapes
    plan64 = datapath_plan(POSIT64, DEFAULT_VARIANT)
    rows["K2 posit64 decode"] = rowwise_row(8, 960, POSIT64)
    rows["K2 posit64 prefill"] = rowwise_row(256, 960, POSIT64)
    rows["K1 posit64"] = rowwise_row(1024, 1024, POSIT64)
    rows["K3 posit64 decode"] = flash_row(torch, dev, plan64, 8, 1, 512, DECODE_POS,
                                          [0, 0, 5, 3, 9, 0, 14, 31], fmt=POSIT64)
    rows["K3 posit64 prefill"] = flash_row(torch, dev, plan64, 1, 256, 256, [0], [56],
                                           fmt=POSIT64)
    # posit32 (one-word residual) and posit8 at the same shapes
    for fmt in (POSIT32, POSIT8):
        plan_n = datapath_plan(fmt, DEFAULT_VARIANT)
        rows[f"K3 posit{fmt.n} decode"] = flash_row(torch, dev, plan_n, 8, 1, 512, DECODE_POS,
                                                    [0, 0, 5, 3, 9, 0, 14, 31], fmt=fmt)
        rows[f"K3 posit{fmt.n} prefill"] = flash_row(torch, dev, plan_n, 1, 256, 256, [0],
                                                     [56], fmt=fmt)
    print_rows(rows)
    return rows


DECODE_POS = [47, 63, 92, 120, 151, 178, 199, 231]   # the timed decode slots' positions


def print_rows(rows):
    for name, r in rows.items():
        lens = f" segments {r['lens']}" if "lens" in r else ""
        rate = f", {r['per_s']:.4g} elements/s" if "per_s" in r else ""
        plain = "not measured" if r["plain_ms"] is None else f"{r['plain_ms']:.4f} ms"
        lib = r["library_ms"]
        if "library_from" in r:
            lib = f"{lib} ms ({r['library_from']})"
        dig = f", output digest {r['digest']}" if "digest" in r else ""
        print(f"timing {name} {r['shape']}{lens}: device {r['ms']} ms ({r['ms_from']}), per call "
              f"{r['call_ms']:.4f} ms{rate}, plain {plain}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), library {lib}{dig}")


def flash_row(torch, dev, plan, B, Sq, Sk, pos, start, heads=(15, 5, 64), fmt=None,
              kv_f32=False):
    """K3's timing row at ``plan``: decode (Sq == 1, one query at ``pos``)
    or a causal prefill, keys from ``start``, SDPA on the same masks as the
    yardstick; ``kv_f32``: K/V in f32 (bf16 values upcast)."""
    import torch.nn.functional as Fn

    from repro_torch.core.posit import POSIT16
    from repro_torch.kernels.posit_flash_attn import (
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    H, KV, hd = heads
    q, k, v = flash_inputs(torch, dev, B, Sq, Sk, H, KV, hd, 7)
    if kv_f32:
        k, v = k.float(), v.float()
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    start_t = torch.tensor(start, dtype=torch.int32, device=dev)
    if Sq == 1:
        kw = dict(kv_start=start_t, kv_len=pos_t + 1, q_pos=pos_t)
        keys = sum(p + 1 - s for p, s in zip(pos, start))  # attended (row, key) pairs
        real = sum(p >= s for p, s in zip(pos, start))      # rows that attend a key
        qp = pos_t[:, None]
    else:
        kw = dict(kv_start=start_t)
        keys = sum(max(0, i + 1 - s) for i in range(Sq) for s in start)
        real = sum(max(0, Sq - s) for s in start)
        qp = torch.arange(Sq, device=dev)[None, :].expand(B, Sq)
    fmt = fmt or POSIT16
    kw["variant"] = plan.variant
    call = lambda: posit_flash_attention(fmt, q, k, v, True, **kw)
    dev_ms, src = device_kernel_ms(torch, call, FLASH_FWD)
    # q of the real rows read, every output row written, the keys read
    nbytes = 4 * (real + B * Sq) * H * hd + 2 * k.element_size() * sum(
        min(Sk, p + 1) - s if Sq == 1 else Sk - s for p, s in zip(pos, start)) * KV * hd
    # the products at the tensor cores' rate, the divisions at the instruction rate
    bms, by = bound_ms(nbytes, div_ops(plan, real * H * hd), 4 * H * keys * hd)
    # library yardstick: one SDPA call with the same masks, f32 inputs
    kp = torch.arange(Sk, device=dev)
    mask = (kp[None, None, :] <= qp[:, :, None]) & (kp[None, None, :] >= start_t[:, None, None])
    qs, ks, vs = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))
    lib = lambda: Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask[:, None],
                                                   enable_gqa=True)
    row = {"shape": [B, Sq, Sk, H, KV, hd], "ms": dev_ms, "ms_from": src,
           "call_ms": cuda_time_ms(call),
           "plain_ms": cuda_time_ms(lambda: posit_flash_attention_plain(
               fmt, q, k, v, True, **kw), iters=3),
           "bound_ms": bms, "bound_by": by, "library_ms": device_call_ms(torch, lib)}
    if Sq == 1:
        row["digest"] = digest(call())
    return row


def moe_rows(torch, dev):
    """K9 at the router's shape (8 rows of 64 experts) and at 4096 rows,
    posit16, posit64 and posit32, and at a training step's 2048 rows
    (posit16), with torch.softmax as the yardstick."""
    from repro_torch.core.posit import POSIT16, POSIT32, POSIT64
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import datapath_plan

    plan = datapath_plan(POSIT16, "srt_r4_cs_of_fr")
    rows = {}
    cases = [(f, n + ("" if f is POSIT16 else f" posit{f.n}"), shape)
             for f in (POSIT16, POSIT64, POSIT32)
             for n, shape in (("K9 router", (8, 64)), ("K9 4096 rows", (4096, 64)))]
    for fmt, name, (R, C) in cases + [(POSIT16, "K9 training 2048 rows", (2048, 64))]:
        x = (torch.randn(R, C, generator=torch.Generator().manual_seed(17)) * 2).to(dev)
        call = lambda: ops.posit_softmax_fused(fmt, x)
        dev_ms, src = device_kernel_ms(torch, call, ["softmax_kernel"])
        # each element read and written once (f32), one division each
        bms, by = bound_ms(8 * R * C, div_ops(datapath_plan(fmt, DEFAULT_VARIANT), R * C))
        # the yardstick's device time as K9's, from the profiler
        lib_ms, lib_src = device_kernel_ms(torch, lambda: torch.softmax(x, dim=-1), ["oftmax"])
        rows[name] = {"shape": [R, C], "ms": dev_ms, "ms_from": src,
                      "call_ms": cuda_time_ms(call),
                      "plain_ms": cuda_time_ms(lambda: ops.posit_softmax_plain(fmt, x),
                                               iters=5),
                      "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                      "library_from": lib_src}
    print_rows(rows)
    return rows


# Integer operations of a cast per element, counted from posit_srt.cuh
# (each guarded shift as a compare, a shift and a select): float_to_posit is
# float_decompose (22), the field split (6) and encode (~100); posit_to_float
# is decode (~30) and ldexp_f32 with the sign and special selects (~20);
# round_value is float_decompose (22), round_fields (~35) and the f32 built
# from the fields with the special selects (~8), bf16's widening and
# conversion (~5).
QUANTIZE_OPS = 130
DEQUANTIZE_OPS = 50
ROUND_OPS = 70
KV_DECODE = (8, 1, 5, 64)      # a SmolLM decode step's K (and V) of one layer


def division_rows(torch, dev):
    """K10, K11 and K12 (quantize, dequantize), posit16, default plan, and
    the two-word frame (K10 posit64 default plan, K11 posit32
    srt_r4_scaled), at the reference benchmark's 64 x 1024 and at one 2^28
    chunk of the pair sweep: device time (torch.profiler), per-call time
    (CUDA events), the bound, the elements a second, and the twin's time at
    64 x 1024.  K11 and the dequantize take int32 words, as the sweep gives
    them (K11 writes int64 lanes).  Then K12's round kernel as the posit-KV
    path calls it, posit16 on bf16 K and V of a decode step's layer
    (KV_DECODE each) and of 2^27 elements each."""
    from repro_torch.core.posit import POSIT16, POSIT32, POSIT64
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import datapath_plan

    plan = datapath_plan(POSIT16, DEFAULT_VARIANT)
    plan64 = datapath_plan(POSIT64, DEFAULT_VARIANT)
    scaled32 = datapath_plan(POSIT32, "srt_r4_scaled")
    g = torch.Generator(device=dev).manual_seed(23)
    rows = {}
    for size, label in ((64 * 1024, "64x1024"), (CHUNK, "2^28")):
        a, b = (torch.rand(size, device=dev, generator=g) * 9.9 + 0.1 for _ in range(2))
        wa, wb = (ops.posit_quantize(POSIT16, t).to(torch.int32) for t in (a, b))
        sa, sb = (ops.posit_quantize(POSIT32, t).to(torch.int32) for t in (a, b))
        cases = {
            "K10 posit64": (lambda: ops.posit_div_fused(POSIT64, a, b), ["elementwise_kernel"],
                            12, div_ops(plan64, size),
                            lambda: ops.posit_div_fused_plain(POSIT64, a, b)),
            "K11 posit32 srt_r4_scaled": (
                lambda: ops.posit_div(POSIT32, sa, sb, "srt_r4_scaled"), ["div_kernel"], 16,
                div_ops(scaled32, size),
                lambda: ops.posit_div_plain(POSIT32, sa, sb, "srt_r4_scaled")),
            "K10": (lambda: ops.posit_div_fused(POSIT16, a, b), ["elementwise_kernel"],
                    12, div_ops(plan, size), lambda: ops.posit_div_fused_plain(POSIT16, a, b)),
            "K11": (lambda: ops.posit_div(POSIT16, wa, wb), ["div_kernel"], 16,
                    div_ops(plan, size), lambda: ops.posit_div_plain(POSIT16, wa, wb)),
            "K12 quantize": (lambda: ops.posit_quantize(POSIT16, a), ["::quantize_kernel"], 12,
                             QUANTIZE_OPS * size, lambda: ops.posit_quantize_plain(POSIT16, a)),
            "K12 dequantize": (lambda: ops.posit_dequantize(POSIT16, wa), ["dequantize_kernel"],
                               8, DEQUANTIZE_OPS * size,
                               lambda: ops.posit_dequantize_plain(POSIT16, wa)),
        }
        iters = 20 if size < CHUNK else 3
        # K10's yardstick: the same elementwise division in f32, no posit;
        # K11 (patterns in and out) and K12 (a cast to posit) have no torch
        # call that computes their function
        lib_ms, lib_src = device_kernel_ms(torch, lambda: torch.div(a, b), ["DivFunctor"],
                                           iters=iters)
        for name, (call, names, per_elem, ops_, plain) in cases.items():
            dev_ms, src = device_kernel_ms(torch, call, names, iters=iters)
            bms, by = bound_ms(per_elem * size, ops_)
            k10 = name.startswith("K10")
            rows[f"{name} {label}"] = {
                "shape": [size], "ms": dev_ms, "ms_from": src,
                "call_ms": cuda_time_ms(call, iters=iters),
                "plain_ms": cuda_time_ms(plain, iters=5) if size < CHUNK else None,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms if k10 else None,
                "per_s": size / (dev_ms * 1e-3)}
            if k10:
                rows[f"{name} {label}"]["library_from"] = lib_src
        del a, b, wa, wb, sa, sb
        torch.cuda.empty_cache()
    for shape, label in ((KV_DECODE, "decode"), ((1 << 27,), "2^27+2^27")):
        k, v = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        call = lambda: ops.posit_round_kv(POSIT16, k, v)
        size = 2 * k.numel()
        iters = 20 if size < CHUNK else 3
        dev_ms, src = device_kernel_ms(torch, call, ["posit_round_kernel"], iters=iters)
        bms, by = bound_ms(4 * size, ROUND_OPS * size)
        plain = lambda: [ops.posit_round_plain(POSIT16, t) for t in (k, v)]
        rows[f"K12 round kv {label}"] = {
            "shape": [2, *shape], "ms": dev_ms, "ms_from": src,
            "call_ms": cuda_time_ms(call, iters=iters),
            "plain_ms": cuda_time_ms(plain, iters=5) if size < CHUNK else None,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "per_s": size / (dev_ms * 1e-3)}
        del k, v
    torch.cuda.empty_cache()
    print_rows(rows)
    return rows


def paged_row(torch, dev, fmt, variant=DEFAULT_VARIANT, heads=(15, 5, 64)):
    """K4's timing row at the paged decode's shapes (8 slots, max_seq 512
    in pages of 16, paged admissions at start 0, ``heads`` = (H, KV, hd)),
    at ``fmt`` and ``variant``, SDPA on the gathered K/V as the yardstick."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.posit_div import datapath_plan
    from repro_torch.kernels.posit_flash_attn import (
        gather_pages,
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    H, KV, hd = heads
    bs = PAGED_BLOCK
    plan = datapath_plan(fmt, variant)
    q, pk, pv, bt = paged_inputs(torch, dev, 8, 512 // bs, bs, H, KV, hd, 8)
    pos_l, start_l = DECODE_POS, [0] * 8
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    kw = dict(kv_start=torch.tensor(start_l, dtype=torch.int32, device=dev),
              kv_len=pos + 1, q_pos=pos, block_tables=bt, variant=variant)
    call = lambda: posit_flash_attention(fmt, q, pk, pv, True, **kw)
    dev_ms, src = device_kernel_ms(torch, call, FLASH_FWD)
    # the keys each slot attends, and one table entry per page they touch
    keys = sum(p + 1 - s for p, s in zip(pos_l, start_l))
    pages = sum(p // bs - s // bs + 1 for p, s in zip(pos_l, start_l))
    nbytes = 2 * 4 * 8 * H * hd + 2 * 2 * keys * KV * hd + 4 * pages + 3 * 4 * 8
    bms, by = bound_ms(nbytes, div_ops(plan, 8 * H * hd), 4 * H * keys * hd)
    kd, vd = gather_pages(pk, bt), gather_pages(pv, bt)
    kp = torch.arange(kd.shape[1], device=dev)
    mask = (kp[None, :] <= pos[:, None])[:, None, None, :]
    qs, ks, vs = (t.float().transpose(1, 2).contiguous() for t in (q, kd, vd))
    lib = lambda: Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    return {"shape": [8, 1, 512, H, KV, hd], "ms": dev_ms, "ms_from": src,
            "call_ms": cuda_time_ms(call),
            "plain_ms": cuda_time_ms(lambda: posit_flash_attention_plain(fmt, q, pk, pv, True,
                                                                         **kw), iters=3),
            "bound_ms": bms, "bound_by": by, "library_ms": device_call_ms(torch, lib),
            "digest": digest(call())}


def layout_rows(torch, dev, fmt, pack, variant=DEFAULT_VARIANT):
    """K4 at the paged decode's shapes (``paged_row``) and K5 on a pack of
    the paged phase's most frequent shape, ``pack`` = (N, width, segment
    lengths), right-padded, at ``fmt`` and ``variant``."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.posit_div import datapath_plan
    from repro_torch.kernels.posit_flash_attn import (
        posit_flash_attention,
        posit_flash_attention_plain,
    )

    H, KV, hd = 15, 5, 64
    plan = datapath_plan(fmt, variant)
    tag = ("" if fmt.n == 16 else f" posit{fmt.n}") + ("" if variant == DEFAULT_VARIANT
                                                      else f" {variant}")
    rows = {f"K4{tag} decode": paged_row(torch, dev, fmt, variant)}

    N, P, lens = pack
    q, k, v, seg_q, seg, segs = packed_inputs(torch, dev, lens, P, 9, left=False)
    kw = dict(seg_q=seg_q, seg_kv=seg, variant=variant)
    call = lambda: posit_flash_attention(fmt, q, k, v, True, seg_len=P, **kw)
    dev_ms, src = device_kernel_ms(torch, call, FLASH_FWD)
    pairs = sum(n * (n + 1) // 2 for _, n in segs)        # block-diagonal causal pairs
    S, real = N * P, sum(lens)
    # q and K/V of the real rows read, every output row written, both id rows
    nbytes = 4 * (real + S) * H * hd + 2 * 2 * real * KV * hd + 2 * 4 * S
    bms, by = bound_ms(nbytes, div_ops(plan, real * H * hd), 4 * H * pairs * hd)
    ids = torch.arange(S, device=dev)
    mask = ((seg[0][None, :] == seg_q[0][:, None]) & (ids[None, :] <= ids[:, None]))
    mask = mask | (seg_q[0] < 0)[:, None]   # SDPA's fully masked rows are NaN: let pads attend
    qs, ks, vs = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))
    lib = lambda: Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask[None, None],
                                                  enable_gqa=True)
    rows[f"K5{tag} packed prefill"] = {
        "shape": [1, S, S, H, KV, hd], "lens": lens, "ms": dev_ms, "ms_from": src,
        "call_ms": cuda_time_ms(call),
        "plain_ms": cuda_time_ms(lambda: posit_flash_attention_plain(fmt, q, k, v, True,
                                                                     **kw), iters=3),
        "bound_ms": bms, "bound_by": by, "library_ms": device_call_ms(torch, lib)}
    return rows


def training_rows(torch, dev, fmt, kv_f32=False, variant=DEFAULT_VARIANT,
                  heads=(15, 5, 64)):
    """K6, K7 and K8 at the training path's shapes (B=8, S=256, causal), at
    ``fmt`` and ``variant``; ``kv_f32``: K/V in f32; ``heads``: (H, KV,
    head_dim), SmolLM's unless given (OLMoE's: MOE_HEADS)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels import posit_flash_attn as F

    B, S = 8, 256
    H, KV, hd = heads
    plan = F.datapath_plan(fmt, variant)
    tag = (("" if fmt.n == 16 else f" posit{fmt.n}") + (" f32 K/V" if kv_f32 else "")
           + ("" if variant == DEFAULT_VARIANT else f" {variant}")
           + ("" if heads == (15, 5, 64) else f" {H}/{KV} x {hd}"))
    q, k, v, co = training_inputs(torch, dev, B, S, 9, H, KV, hd)
    if kv_f32:
        k, v = k.float(), v.float()
    o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, variant=variant)
    args = backward_args(F, co, o, m, l, q, k, v)
    pairs = B * H * S * (S + 1) // 2            # attended (row, key) pairs
    qo = B * S * H * hd * 4                     # one f32 (B, S, H, hd) tensor
    kv = B * S * KV * hd * k.element_size()     # one (B, S, KV, hd) K/V tensor
    rowv = B * H * S * 4                        # one f32 (B*H, S) row vector
    # library yardsticks: SDPA forward, and SDPA backward for K7 and K8
    # together, on the same causal mask with f32 inputs
    qs, ks, vs = (t.float().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa = lambda: Fn.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                   enable_gqa=True)
    lib_fwd = device_call_ms(torch, lambda: sdpa().detach())
    out = sdpa()
    gs = co.transpose(1, 2).contiguous()
    lib_bwd = device_call_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), gs,
                                                                retain_graph=True))
    plain_bwd = cuda_time_ms(lambda: F.flash_backward_plain(fmt, q, k, v, o, co, m, l,
                                                            True, variant=variant), iters=3)

    def row(call, names, nbytes, ops_, plain_ms, library_ms, tensor_ops=0.0):
        dev_ms, src = device_kernel_ms(torch, call, names)
        bms, by = bound_ms(nbytes, ops_, tensor_ops)
        return {"shape": [B, S, S, H, KV, hd], "ms": dev_ms, "ms_from": src,
                "call_ms": cuda_time_ms(call),
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": library_ms}

    rows = {
        "K6" + tag: row(lambda: F.posit_flash_attention_fwd(fmt, q, k, v, True,
                                                             variant=variant),
                  FLASH_FWD, 2 * qo + 2 * kv + 2 * rowv, div_ops(plan, B * S * H * hd),
                  cuda_time_ms(lambda: F.posit_flash_attention_fwd_plain(
                      fmt, q, k, v, True, variant=variant), iters=3), lib_fwd, pairs * 4 * hd),
        # K6-K8: the products at the tensor cores' rate, the divisions at the
        # instruction rate
        "K7" + tag: row(lambda: F.flash_backward_dq(fmt, plan, *args),
                  ["flash_bwd_dq_kernel"], 3 * qo + 2 * kv + 3 * rowv,
                  div_ops(plan, pairs), plain_bwd, lib_bwd, pairs * 6 * hd),
        "K8" + tag: row(lambda: F.flash_backward_dkv(fmt, plan, *args),
                  ["flash_bwd_dkv_kernel"], 2 * qo + 2 * kv + 3 * rowv + 2 * 2 * kv,
                  div_ops(plan, pairs), plain_bwd, lib_bwd, pairs * 8 * hd),
    }
    return rows


PLAN_TABLE_FORMATS = (16, 32, 64)   # the paper's formats, every plan of each


def plan_table(torch, dev, pack):
    """Each kernel's time at every plan of posit16, posit32 and posit64 from
    CUDA events (per call, launch gaps included): K2 at 256 x 960, K3
    prefill at P=256, K5 on ``pack`` (the paged phase's most frequent
    shape), K6, K7 and K8 at B=8 x 256 and K9 at 4096 x 64, each beside its
    operation bound at that plan (div_ops: the datapath's iterations at its
    own cost; K3-K8's products at the TF32 tensor-core rate, as
    bound_ms counts them) and the paper's hardware model of the divider
    (``core/costmodel.estimate(fmt, variant, pipelined=False)``)."""
    from repro_torch.core import costmodel
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_flash_attn as F

    H, KV, hd = 15, 5, 64
    g = torch.Generator(device="cpu").manual_seed(71)
    a = torch.randn(256, 960, generator=g).to(dev)
    b = (torch.rand(256, 1, generator=g) + 0.5).to(dev)
    pq, pk, pv = flash_inputs(torch, dev, 1, 256, 256, H, KV, hd, 72)
    s56 = torch.tensor([56], dtype=torch.int32, device=dev)
    N, P, lens = pack
    sq, sk, sv, seg_q, seg, segs = packed_inputs(torch, dev, lens, P, 73, left=False)
    tq, tk, tv, co = training_inputs(torch, dev, 8, 256, 74)
    x = (torch.randn(4096, 64, generator=g) * 2).to(dev)
    pairs = 8 * H * 256 * 257 // 2                     # causal (row, key) pairs of K6-K8
    pack_pairs = sum(n * (n + 1) // 2 for _, n in segs)
    table = []
    for n in PLAN_TABLE_FORMATS:
        fmt = PositFormat(n)
        for variant in plan_variants(n):
            plan = F.datapath_plan(fmt, variant)
            o, m, l = F.posit_flash_attention_fwd(fmt, tq, tk, tv, True, variant=variant)
            args = backward_args(F, co, o, m, l, tq, tk, tv)
            calls = {   # name: (call, elements divided, other operations, tensor-core flops)
                "K2": (lambda: ops.posit_div_fused_rowwise(fmt, a, b, variant), 256 * 960, 0,
                       0),
                "K3": (lambda: F.posit_flash_attention(fmt, pq, pk, pv, True, kv_start=s56,
                                                       variant=variant),
                       200 * H * hd, 0, 4 * H * hd * 200 * 201 // 2),
                "K5": (lambda: F.posit_flash_attention(fmt, sq, sk, sv, True, variant=variant,
                                                       seg_q=seg_q, seg_kv=seg, seg_len=P),
                       sum(lens) * H * hd, 0, 4 * H * hd * pack_pairs),
                "K6": (lambda: F.posit_flash_attention_fwd(fmt, tq, tk, tv, True,
                                                           variant=variant),
                       8 * 256 * H * hd, 0, 4 * hd * pairs),
                "K7": (lambda: F.flash_backward_dq(fmt, plan, *args), pairs, 0, 6 * hd * pairs),
                "K8": (lambda: F.flash_backward_dkv(fmt, plan, *args), pairs, 0, 8 * hd * pairs),
                "K9": (lambda: ops.posit_softmax_fused(fmt, x, variant), 4096 * 64, 0, 0),
            }
            cost = costmodel.estimate(fmt, variant, pipelined=False)
            row = {"format": f"posit{n}", "variant": variant, "iterations": plan.iterations,
                   "ops_per_iteration": div_iteration_ops(plan),
                   "div_ops": div_ops(plan, 1), "hw_delay_fo4": cost.delay_fo4,
                   "hw_area_ge": cost.area_ge, "hw_energy_au": cost.energy_au}
            for name, (call, divides, other, tensor) in calls.items():
                row[f"{name}_ms"] = cuda_time_ms(call, iters=10, warmup=2)
                row[f"{name}_bound_ms"] = bound_ms(0, other + div_ops(plan, divides), tensor)[0]
            table.append(row)
    names = ("K2", "K3", "K5", "K6", "K7", "K8", "K9")
    print("plan table (CUDA events, ms per call; bound = operations / 33.45e12 a second, "
          "K3-K8's products / 495 TFLOP/s; hardware model: delay FO4, area GE): " + "; ".join(
              f"{r['format']} {r['variant']} it {r['iterations']} x {r['ops_per_iteration']} "
              f"ops, hw {r['hw_delay_fo4']:.1f} FO4 {r['hw_area_ge']:.0f} GE: " + ", ".join(
                  f"{k} {r[k + '_ms']:.4f} (bound {r[k + '_bound_ms']:.4f})" for k in names)
              for r in table))
    print(json.dumps({"plan_table": table}))
    return table


def decode_breakdown(torch, dev, cfg, params, paged: bool = False):
    """Profile decode steps of the full model at 8 slots (dense slots, or a
    paged pool in pages of 16 on identity tables): device time by kernel
    class, wall time, and the device's idle share.  A moe model's steps
    read every expert (the dispatch buffer is dense over the experts); an
    ssm model's read and write its whole state (the SSD's conv window and
    h), which its bound counts beside the weights."""
    import numpy as np

    from repro_torch.models import transformer as T

    bt = None
    if paged:
        mb = 512 // PAGED_BLOCK
        cache = T.init_paged_cache(cfg, 8 * mb + 1, PAGED_BLOCK, device=dev)
        bt = torch.arange(1, 8 * mb + 1, dtype=torch.int32, device=dev).reshape(8, mb)
    else:
        cache = T.init_cache(cfg, 8, 512, device=dev)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    start = torch.zeros(8, dtype=torch.int32, device=dev)
    tok = torch.from_numpy(np.arange(8, dtype=np.int64)[:, None] + 100).to(dev)
    step = lambda: T.decode_step(params, cfg, cache, tok, pos, start, bt, with_health=True)
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

        times, wall = profiled(torch, steps, [*FLASH_FWD, "rowwise_kernel"])
    classes = (("K2 rowwise", "rowwise_kernel"),)
    if cfg.family != "ssm":
        classes += ((("K4 flash, paged" if paged else "K3 flash"), FLASH_FWD),)
    if cfg.family == "moe":
        classes += (("K9 softmax", "softmax_kernel"),)
    if cfg.numerics.kv_cache_format:
        # the round kernel (a parent checkout's quantize and dequantize)
        classes += (("K12 casts", ("posit_round_kernel", "quantize_kernel")),)
    by = by_class({k: t / n for k, t in times.items()}, classes)
    busy = sum(by.values()) if times else None
    # every decode step reads all layer weights and the head once
    weight_bytes = sum(w.numel() * w.element_size() for w in tensors_of(params["layers"])) \
        + params["head"].numel() * 2
    state_bytes = 2 * sum(t.numel() * t.element_size() for t in T.cache_leaves(cache)) \
        if cfg.family == "ssm" else 0
    if busy is None:
        device = (f"torch.profiler showed no device records in {PROFILE_TRIES} tries: "
                  "busy and idle share not measured")
    else:
        device = "device busy %.3f ms, idle share %.3f; %s" % (
            busy, 1 - busy / wall_plain, ", ".join(f"{k} {v:.3f} ms" for k, v in by.items()))
    kv = cfg.numerics.kv_cache_format
    state = f", state read and written {state_bytes / 1e6:.1f} MB" if state_bytes else ""
    print("decode step (%s, %s, 8 slots, full width, %s%s): wall %.3f ms (%.3f ms traced), "
          "%s; weights read %.1f MB%s, bound %.4f ms" % (
              cfg.name, cfg.numerics.div_format, "paged" if paged else "dense",
              f", {kv} KV cache" if kv else "",
              wall_plain, wall / n, device,
              weight_bytes / 1e6, state, (weight_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3))
    return {"wall_ms": wall_plain, "busy_ms": busy, **by}


LAYOUT_NAMES = ("dense", "paged", "packed")   # csrc/posit_flash_attn.cu Layout


def plan_name(fields) -> str:
    """The Table IV variant of a ``Plan<n, radix, red, otf, scaled, nonrest,
    ...>`` instantiation (srt_r4_cs_of also stands for srt_r4_cs_of_fr, and
    srt_r2_cs_of for srt_r2_cs_of_fr: one datapath each)."""
    n, radix, red, otf, scaled, nonrest = fields[:6]
    if nonrest:
        return f"posit{n} nrd"
    if scaled:
        return f"posit{n} srt_r4_scaled"
    return f"posit{n} srt_r{radix}" + ("_cs" if red else "") + ("_of" if otf else "")


# K11's and K12's element types in a mangled name, by the kernel
WORD_NAMES = {"l": "int64", "j": "int32", "t": "uint16", "h": "uint8", "f": "f32"}


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name as its function, plan and (for the flash
    forward) layout, as "flash_kernel posit64 srt_r4_cs_of paged", with
    " hd256" where a flash kernel's head-dim class is not 128; K11's and
    K12's with their element type and, past one, their elements a thread,
    as "dequantize_kernel posit16 int32 x4"."""
    fn = re.search(r"\d([a-z][a-z_]*_kernel)I", mangled)
    plan = re.search(r"PlanI((?:L[ib]\d+E)+)E", mangled)
    fields = [int(x) for x in re.findall(r"L[ib](\d+)E", plan.group(1))] if plan else []
    width = re.search(r"_kernelILi(\d+)E", mangled)   # K12's casts: the format first
    what = (plan_name(fields) if fields else
            f"posit{width.group(1)}" if width else "posit?")
    name = f"{fn.group(1) if fn else mangled} {what}"
    if fn and fn.group(1).startswith("flash_bwd"):
        cls = re.search(r"EELi(\d+)EEEv", mangled)   # <P, kHd>: the head-dim class
        if cls and cls.group(1) != "128":
            name += f" hd{cls.group(1)}"
    elif fn and fn.group(1).startswith("flash"):
        layout = re.search(r"EELi(\d)E(?:Li(\d+)E)?EEv", mangled)
        if layout:
            name += f" {LAYOUT_NAMES[int(layout.group(1))]}"
            if layout.group(2) and layout.group(2) != "128":   # the tile loop's class
                name += f" hd{layout.group(2)}"
    elif fn:
        extra = re.search(r"E([a-z]?)Li(\d)EEEv", mangled)   # <..., type, V>
        if extra:
            word = WORD_NAMES.get(extra.group(1), "")
            if fn.group(1) == "posit_round_kernel" and word == "uint16":
                word = "bf16"
            name += (f" {word}" if word else "") + (
                f" x{extra.group(2)}" if extra.group(2) != "1" else "")
    return name


def ptxas_kernels(log: str):
    """``(kernel, registers, spill store bytes)`` for each kernel that
    ``-Xptxas -v`` reported, the kernel named by ``kernel_name``."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out.append((kernel_name(block.split("'", 1)[0]), int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0))
    return out


# the libraries whose posit16 kernels --time-kernels disassembles (and
# posit_fused_div's posit64 ones, and the forward's posit32 ones, whose tile
# loop runs on the tensor cores), and the opcodes it counts in each: the
# integer pipe's (compares, selects, branches, logic, adds, shifts, byte
# permutes), IMAD and MOV, the conversions and f32 multiplies the casts use,
# constant, global and local loads (a table looked up in memory, spills),
# shared loads, and the tensor cores' HMMA
SASS_LIBRARIES = ("posit_flash_attn_p16", "posit_flash_attn_p32", "posit_flash_bwd_p16",
                  "posit_fused_div", "posit_softmax", "posit_div", "posit_cast")
SASS_FORMATS = {"posit_fused_div": ("posit16", "posit64"), "posit_flash_attn_p32": ("posit32",)}
SASS_OPCODES = ("ISETP", "SEL", "BRA", "LOP3", "IADD3", "SHF", "PRMT", "IMAD", "MOV", "FLO", "I2F",
                "F2I", "FMUL", "FFMA", "FSETP", "LDC", "LDG", "LDL", "STL", "LDS", "SHFL",
                "HMMA")


def sass_counts(build, name: str):
    """``{kernel: {"instructions": n, opcode: n, ..., "digest": d}}``: the
    static SASS of every posit16 kernel of the built library ``name`` (or
    the formats SASS_FORMATS names for it) (``cuobjdump -sass``, beside
    ``nvcc``), its instructions counted in all and by SASS_OPCODES, and the
    sha256 prefix of its instructions' text without addresses (a parent
    checkout's kernel prints the same digest where its SASS is the same)."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", str(build._lib_path(name))], check=True,
                          capture_output=True, text=True, timeout=600).stdout
    formats = SASS_FORMATS.get(name, ("posit16",))
    out = {}
    for block in dump.split("Function : ")[1:]:
        name = kernel_name(block.split(None, 1)[0])
        if name.split()[1] not in formats:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", block)
        text = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", block)
        counts = collections.Counter(ops)
        out[name] = {"instructions": len(ops), **{o: counts.get(o, 0) for o in SASS_OPCODES},
                     "digest": hashlib.sha256("\n".join(text).encode()).hexdigest()[:16]}
    return out


# the libraries --time-kernels --only builds for each kernel it may time
# (K10's: K12's too, whose cast kernels' SASS gives the old casts' cost)
FLASH_FWD_LIBRARIES = ("posit_flash_attn_p16", "posit_flash_attn_p32", "posit_flash_attn_p64_r4")
# K3 and K4's digests take every format and posit64's nrd too
DECODE_LIBRARIES = FLASH_FWD_LIBRARIES + ("posit_flash_attn_p8", "posit_flash_attn_p64_r2")
ONLY_LIBRARIES = {
    "K2": ("posit_fused_div",),
    "K3": FLASH_FWD_LIBRARIES,
    "K7": FLASH_FWD_LIBRARIES + ("posit_flash_bwd_p16", "posit_flash_bwd_p32",
                                 "posit_flash_bwd_p64_r4"),
    "K9": ("posit_softmax",),
    "K10": ("posit_fused_div", "posit_cast"),
    "K11": ("posit_div",),
    "K12": ("posit_cast",),
}
ONLY_LIBRARIES["K5"] = ONLY_LIBRARIES["K6"] = ONLY_LIBRARIES["K3"]
ONLY_LIBRARIES["K3"] = ONLY_LIBRARIES["K4"] = DECODE_LIBRARIES
ONLY_LIBRARIES["K8"] = ONLY_LIBRARIES["K7"]
# --time-kernels' K2 and K10 shapes: decode, prefill and the training
# step's RMSNorm rows, 1024 x 1024; the reference benchmark's 64 x 1024 and
# 2^24 and 2^28 elements
K2_SHAPES = ((8, 960), (256, 960), (2048, 960), (1024, 1024), (8, 2048), (8, 2560), (8, 5120),
             (4096, 5120))
K10_SIZES = ((64 * 1024, "64x1024"), (1 << 24, "2^24"), (1 << 28, "2^28"))


def decode_digests(torch, dev, F, dense_in, paged_in, pos):
    """The digest of K3 decode's and K4's outputs on ``--time-kernels``'
    decode inputs (``dense_in`` = q, k, v, kv_start; ``paged_in`` = q, the
    pools and the table; the slots at ``pos``) in every format at the
    default plan and ``nrd``, on bf16 K/V and on f32 K/V holding values bf16
    cannot (``f32_values``): a parent checkout's run prints the same
    digests where the two give the same bits."""
    from repro_torch.core.posit import PositFormat

    q, k, v, start = dense_in
    gq, gk, gv, bt = paged_in
    kf, vf, gkf, gvf = (f32_values(torch, t, 40 + i) for i, t in enumerate((k, v, gk, gv)))
    out = {}
    for n in (8, 16, 32, 64):
        for variant in (DEFAULT_VARIANT, "nrd"):
            fmt = PositFormat(n)
            for kv, kd, vd, pk, pv in (("bf16", k, v, gk, gv), ("f32", kf, vf, gkf, gvf)):
                tag = f"posit{n} {variant} {kv} K/V"
                out[f"K3 decode {tag}"] = digest(F.posit_flash_attention(
                    fmt, q, kd, vd, True, kv_start=start, kv_len=pos + 1, q_pos=pos,
                    variant=variant))
                out[f"K4 decode {tag}"] = digest(F.posit_flash_attention(
                    fmt, gq, pk, pv, True, kv_len=pos + 1, q_pos=pos, block_tables=bt,
                    variant=variant))
    return out


def tile_digests(torch, dev, F, formats):
    """The digests of the tile loop's outputs at head_dim <= 128 (K3
    prefill at 1 x 256, 15/5 heads of 64, kv_start 56, and at 1 x 96, 16/16
    heads of 128 with a 48-key window; K6's o, m and l at 2 x 256, 15/5
    heads of 64) in ``formats`` at the default plan, on bf16 K/V and on f32
    K/V bf16 cannot hold: a parent checkout's run prints the same digests
    where its tile loop gives the same bits."""
    from repro_torch.core.posit import PositFormat

    s56 = torch.tensor([56], dtype=torch.int32, device=dev)
    cases = {"K3 prefill hd64": (flash_inputs(torch, dev, 1, 256, 256, 15, 5, 64, 61),
                                 dict(kv_start=s56)),
             "K3 prefill hd128 window": (flash_inputs(torch, dev, 1, 96, 96, 16, 16, 128, 62),
                                         dict(window=48))}
    tq, tk, tv, _ = training_inputs(torch, dev, 2, 256, 63)
    out = {}
    for n in formats:
        fmt = PositFormat(n)
        for kv in ("bf16", "f32"):
            for name, ((q, k, v), kw) in cases.items():
                if kv == "f32":
                    k, v = f32_values(torch, k, 64), f32_values(torch, v, 65)
                out[f"{name} posit{n} {kv} K/V"] = digest(F.posit_flash_attention(
                    fmt, q, k, v, True, **kw))
            k6k, k6v = (tk, tv) if kv == "bf16" else (f32_values(torch, tk, 66),
                                                      f32_values(torch, tv, 67))
            o, m, l = F.posit_flash_attention_fwd(fmt, tq, k6k, k6v, True)
            out[f"K6 posit{n} {kv} K/V"] = "/".join(digest(t) for t in (o, m, l))
    return out


def backward_digests(torch, dev, F, formats):
    """The digests of K7's dq and K8's dk, dv at head_dim <= 128 (2 x 256,
    15/5 heads of 64, causal; 1 x 96, 16/16 heads of 128 with a 48-key
    window), from K6's residuals, in ``formats`` at the default plan, on
    bf16 K/V and on f32 K/V bf16 cannot hold: a parent checkout's run prints
    the same digests where its backward gives the same bits."""
    from repro_torch.core.posit import PositFormat

    cases = {"hd64": (training_inputs(torch, dev, 2, 256, 68), 0),
             "hd128 window": (training_inputs(torch, dev, 1, 96, 69, *MOE_HEADS), 48)}
    out = {}
    for n in formats:
        fmt = PositFormat(n)
        plan = F.datapath_plan(fmt, DEFAULT_VARIANT)
        for kv in ("bf16", "f32"):
            for name, ((q, k, v, co), win) in cases.items():
                if kv == "f32":
                    k, v = f32_values(torch, k, 70), f32_values(torch, v, 71)
                o, m, l = F.posit_flash_attention_fwd(fmt, q, k, v, True, win)
                args = (q, k, v, co, m, l, F._row_sums(co, o), True, win, 0,
                        1.0 / math.sqrt(q.shape[-1]))
                tag = f"{name} posit{n} {kv} K/V"
                out[f"K7 {tag}"] = digest(F.flash_backward_dq(fmt, plan, *args))
                out[f"K8 {tag}"] = "/".join(digest(t) for t in
                                            F.flash_backward_dkv(fmt, plan, *args))
    return out


def division_digests(torch, dev):
    """The digests of K11's, K12's and the posit-KV rounding's outputs on
    fixed inputs: K11 at every plan it is built for (posit8 and posit10 on
    every pair, posit16 and posit32 on 2^20 random pairs, int64 lanes in);
    K12's quantize of 2^20 random f32 bit patterns and the specials, its
    dequantize of every posit8/16 pattern (2^20 random posit32 ones) as
    int64 lanes and int32 words; ``layers._kv_round`` at posit8, posit16
    and posit32 on bf16 K holding every bf16 bit pattern (NaNs, infs,
    subnormals) and on f32 K holding the f32 samples, V random, both a
    decode step's layout.  A parent checkout's run prints the same digests
    where the bits are the same."""
    from repro_torch.configs import get_config
    from repro_torch.core.posit import PositFormat
    from repro_torch.kernels import ops
    from repro_torch.kernels.posit_div import one_word_pairs, planned_pairs
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(41)
    out = {}
    plans = [(f, v) for f, v, _ in planned_pairs() if f.n <= 32] + [
        (f, v) for f, v, _ in one_word_pairs((PositFormat(10),))]
    rand = {n: [torch.randint(0, 1 << n, (1 << 20,), generator=g).to(dev) for _ in range(2)]
            for n in (16, 32)}
    for fmt, variant in plans:
        n = fmt.n
        px, pd = rand[n] if n in rand else (
            m.reshape(-1).to(dev) for m in torch.meshgrid(torch.arange(1 << n),
                                                          torch.arange(1 << n), indexing="ij"))
        out[f"K11 posit{n} {variant}"] = digest(ops.posit_div(fmt, px, pd, variant))
    x = torch.randint(-2 ** 31, 2 ** 31, (1 << 20,), generator=g).to(torch.int32)
    x = torch.cat([f32_specials(torch), x.view(torch.float32)]).to(dev)
    cfg = get_config("smollm_360m", smoke=True)
    for n in (8, 16, 32):
        fmt = PositFormat(n)
        p = torch.arange(1 << n, device=dev) if n < 32 else rand[32][0]
        out[f"K12 quantize posit{n}"] = digest(ops.posit_quantize(fmt, x))
        out[f"K12 dequantize posit{n}"] = digest(ops.posit_dequantize(fmt, p))
        out[f"K12 dequantize posit{n} int32"] = digest(ops.posit_dequantize(fmt, p.to(torch.int32)))
        kcfg = cfg.with_numerics(kv_cache_format=f"posit{n}")
        kb = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(torch.float32)
        kb = kb.to(torch.bfloat16).reshape(-1, 1, 4, 64).to(dev)
        kf = x[: (x.numel() // 256) * 256].reshape(-1, 1, 4, 64)
        for k in (kb, kf):
            v = torch.randn(KV_DECODE, generator=g).to(k.dtype).to(dev)
            rk, rv = layers._kv_round(k, v, kcfg)
            out[f"K12 _kv_round posit{n} {str(k.dtype)[6:]}"] = digest(
                torch.cat([rk.reshape(-1), rv.reshape(-1)]))
    return out


def time_kernels(torch, dev, src: str, repeats: int = 3, only=None) -> None:
    """An A/B of the kernels both packages have, from the package under
    ``src``: each library's build seconds (all built in parallel, as the
    main run builds them), its ptxas report (each posit16 kernel's
    registers and spill stores, and every K7, K8, K9 and tile-loop
    instantiation's), the static SASS of the posit16 K2-K8, K10 and K12
    kernels and the posit64 K2 and K10 ones (``sass_counts``), and the
    device time per launch of K3 (the timing phase's decode and prefill
    rows; decode at OLMoE's 16/16 heads of 128 and on f32 K/V too), K4 (the
    paged decode; at 16/16 x 128 and at posit64 nrd too), K5 (an 8 x 256
    pack), K6-K8 (the training rows), K9 (8 x 64 and 4096 x 64), K3, K4,
    K5-K9 at posit32 and posit64 too, K2 at
    K2_SHAPES (posit16 and posit64) and K10 at K10_SIZES (posit16, posit32
    and posit64), all at the default plan; K2 and K10 per call too; K11
    (posit16, posit32 srt_r4_scaled) and K12 (quantize, dequantize) at the
    division rows' 64 x 1024 and 2^28, ``layers._kv_round`` at posit16 on a
    decode step's bf16 K and V (KV_DECODE) and on 2^27 + 2^27 (its device
    time the sum of every kernel it launches, its launches a call beside
    it), all per call too; K7 and K8 at RecurrentGemma's 10/1 heads of 256
    with the window where the package's backward takes them; with K3 or K4,
    the digests of ``decode_digests``, with K3, K5 or K6 those of
    ``tile_digests``, with K7 or K8 those of ``backward_digests``, with K11
    or K12 those of ``division_digests``.  Run it
    from a parent checkout's ``src`` and from this one, in turns, on one
    card, after an edit to a kernel source or to the shared
    ``posit_srt.cuh``.  ``only`` (kernel names among ONLY_LIBRARIES'): build
    just their libraries and time just their rows, for an A/B of one
    kernel's design variants."""
    from repro_torch.core.posit import POSIT16, POSIT32, POSIT64
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import posit_flash_attn as F

    out = {"src": src, "build_s": {}, "ptxas": {}, "ptxas_posit16": {}, "ptxas_k7_k9": {},
           "ptxas_tile": {}, "ptxas_decode": {}}
    # every library at once, one nvcc each, as the main run builds them
    names = list(getattr(_build, "LIBRARIES", _build.SOURCES))
    if only:
        names = [n for n in names if any(n in ONLY_LIBRARIES[k] for k in only)]
    t0 = time.perf_counter()
    out["build_s"] = {n: round(t, 2) for n, t in _build.build(names).items()}
    out["build_wall_s"] = round(time.perf_counter() - t0, 2)
    out["sass"] = {}
    for n in names:
        if n in SASS_LIBRARIES:
            out["sass"].update(sass_counts(_build, n))
        kernels = ptxas_kernels(_build.ptxas_log(n))
        out["ptxas"][n] = {"kernels": len(kernels),
                           "max_registers": max((r for _, r, _ in kernels), default=0),
                           "spill_store_bytes": sum(sp for _, _, sp in kernels)}
        out["ptxas_posit16"].update({k: [r, sp] for k, r, sp in kernels
                                     if k.split()[1] == "posit16"})
        out["ptxas_k7_k9"].update({k: [r, sp] for k, r, sp in kernels
                                   if k.split()[0] in ("flash_bwd_dq_kernel",
                                                       "flash_bwd_dkv_kernel", "softmax_kernel",
                                                       "warp_softmax_kernel")})
        out["ptxas_tile"].update({k: [r, sp] for k, r, sp in kernels
                                  if k.split()[0] == "flash_tile_kernel"})
        out["ptxas_decode"].update({k: [r, sp] for k, r, sp in kernels
                                    if k.split()[0] in ("flash_decode_kernel", "flash_kernel")})
    plan = F.datapath_plan(POSIT16, "srt_r4_cs_of_fr")
    H, KV, hd = 15, 5, 64
    q, k, v = flash_inputs(torch, dev, 8, 1, 512, H, KV, hd, 7)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 5, 3, 9, 0, 14, 31], dtype=torch.int32, device=dev)
    qp, kp, vp = flash_inputs(torch, dev, 1, 256, 256, H, KV, hd, 7)
    s56 = torch.tensor([56], dtype=torch.int32, device=dev)
    tq, tk, tv, co = training_inputs(torch, dev, 8, 256, 9)
    args_of = {}

    def bwd(fmt):
        """K7 / K8's inputs at ``fmt``, from its K6 forward (run once)."""
        if fmt.n not in args_of:
            o, m, l = F.posit_flash_attention_fwd(fmt, tq, tk, tv, True)
            args_of[fmt.n] = backward_args(F, co, o, m, l, tq, tk, tv)
        return args_of[fmt.n]

    x = torch.randn(4096, 64, device=dev) * 2
    router = torch.randn(8, 64, device=dev) * 2
    gq, gk, gv, bt = paged_inputs(torch, dev, 8, 32, 16, H, KV, hd, 8)
    sq, sk, sv, seg_q, seg, _ = packed_inputs(torch, dev, pack_lens(8, 256), 256, 9,
                                              left=False)
    wq, wk, wv = flash_inputs(torch, dev, 8, 1, 512, *MOE_HEADS, 7)
    wgq, wgk, wgv, wbt = paged_inputs(torch, dev, 8, 32, 16, *MOE_HEADS, 8)
    dense = lambda f, k_, v_, q_=q, variant=DEFAULT_VARIANT: F.posit_flash_attention(
        f, q_, k_, v_, True, kv_start=start, kv_len=pos + 1, q_pos=pos, variant=variant)
    paged = lambda f, q_, k_, v_, bt_, variant=DEFAULT_VARIANT: F.posit_flash_attention(
        f, q_, k_, v_, True, kv_len=pos + 1, q_pos=pos, block_tables=bt_, variant=variant)
    calls = {
        "K3 decode": (lambda: dense(POSIT16, k, v), FLASH_FWD),
        "K3 decode hd128": (lambda: dense(POSIT16, wk, wv, wq), FLASH_FWD),
        "K3 decode f32 K/V": (lambda: dense(POSIT16, k.float(), v.float()), FLASH_FWD),
        "K3 decode posit32": (lambda: dense(POSIT32, k, v), FLASH_FWD),
        "K3 decode posit64": (lambda: dense(POSIT64, k, v), FLASH_FWD),
        "K4 decode": (lambda: paged(POSIT16, gq, gk, gv, bt), FLASH_FWD),
        "K4 decode hd128": (lambda: paged(POSIT16, wgq, wgk, wgv, wbt), FLASH_FWD),
        "K4 decode posit32": (lambda: paged(POSIT32, gq, gk, gv, bt), FLASH_FWD),
        "K4 decode posit64": (lambda: paged(POSIT64, gq, gk, gv, bt), FLASH_FWD),
        "K4 decode posit64 nrd": (lambda: paged(POSIT64, gq, gk, gv, bt, "nrd"), FLASH_FWD),
        "K7": (lambda: F.flash_backward_dq(POSIT16, plan, *bwd(POSIT16)),
               ["flash_bwd_dq_kernel"]),
        "K8": (lambda: F.flash_backward_dkv(POSIT16, plan, *bwd(POSIT16)),
               ["flash_bwd_dkv_kernel"]),
        "K9 8x64": (lambda: ops.posit_softmax_fused(POSIT16, router), ["softmax_kernel"]),
        "K9 4096x64": (lambda: ops.posit_softmax_fused(POSIT16, x), ["softmax_kernel"]),
    }
    # the tile loop (K3 prefill, K5, K6) in every format
    for fmt in (POSIT16, POSIT32, POSIT64):
        tag = "" if fmt is POSIT16 else f" posit{fmt.n}"
        calls.update({
            f"K3 prefill{tag}": (lambda f=fmt: F.posit_flash_attention(f, qp, kp, vp, True,
                                                                       kv_start=s56), FLASH_FWD),
            f"K5 8x256{tag}": (lambda f=fmt: F.posit_flash_attention(
                f, sq, sk, sv, True, seg_q=seg_q, seg_kv=seg, seg_len=256), FLASH_FWD),
            f"K6{tag}": (lambda f=fmt: F.posit_flash_attention_fwd(f, tq, tk, tv, True),
                         FLASH_FWD),
        })
    for fmt in (POSIT32, POSIT64):
        plan_n = F.datapath_plan(fmt, "srt_r4_cs_of_fr")
        calls.update({
            f"K7 posit{fmt.n}": (lambda f=fmt, p=plan_n: F.flash_backward_dq(f, p, *bwd(f)),
                                 ["flash_bwd_dq_kernel"]),
            f"K8 posit{fmt.n}": (lambda f=fmt, p=plan_n: F.flash_backward_dkv(f, p, *bwd(f)),
                                 ["flash_bwd_dkv_kernel"]),
            f"K9 8x64 posit{fmt.n}": (lambda f=fmt: ops.posit_softmax_fused(f, router),
                                      ["softmax_kernel"]),
            f"K9 4096x64 posit{fmt.n}": (lambda f=fmt: ops.posit_softmax_fused(f, x),
                                         ["softmax_kernel"]),
        })
    # K7 and K8 at RecurrentGemma's 10/1 heads of 256 (1 x 4096, window
    # 2048), where the package's backward takes head_dim 256
    if F.head_dim_max("backward") >= 256:
        hq, hk, hv = flash_inputs(torch, dev, 1, HYBRID_FWD_SEQ, HYBRID_FWD_SEQ,
                                  *HYBRID_HEADS, 33)
        hco = torch.randn(hq.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(34))
        ho, hm, hl = F.posit_flash_attention_fwd(POSIT16, hq, hk, hv, True, 2048)
        hargs = (hq, hk, hv, hco, hm, hl, F._row_sums(hco, ho), True, 2048, 0,
                 1.0 / math.sqrt(HYBRID_HEADS[2]))
        calls.update({
            "K7 hd256 window": (lambda: F.flash_backward_dq(POSIT16, plan, *hargs),
                                ["flash_bwd_dq_kernel"]),
            "K8 hd256 window": (lambda: F.flash_backward_dkv(POSIT16, plan, *hargs),
                                ["flash_bwd_dkv_kernel"])})
    # K2 at posit16 (posit64 at decode and prefill), K10 at posit16, posit32
    # and posit64; each also timed per call (CUDA events: the wrapper's host
    # time where it exceeds the kernel's)
    per_call = []
    k2_inputs = {}
    for fmt in (POSIT16, POSIT64):
        for R, C in K2_SHAPES:
            a2 = torch.randn(R, C, device=dev)
            b2 = torch.rand(R, 1, device=dev) + 0.5
            tag = "" if fmt is POSIT16 else f" posit{fmt.n}"
            calls[f"K2 {R}x{C}{tag}"] = (
                lambda f=fmt, a2=a2, b2=b2: ops.posit_div_fused_rowwise(f, a2, b2),
                ["rowwise_kernel"])
            per_call.append(f"K2 {R}x{C}{tag}")
            k2_inputs[f"K2 {R}x{C}{tag}"] = (fmt, a2, b2)
    for size, label in K10_SIZES:
        a1 = torch.rand(size, device=dev) * 9.9 + 0.1
        b1 = torch.rand(size, device=dev) * 9.9 + 0.1
        for fmt in (POSIT16, POSIT32, POSIT64):
            tag = "" if fmt is POSIT16 else f" posit{fmt.n}"
            calls[f"K10 {label}{tag}"] = (
                lambda f=fmt, a1=a1, b1=b1: ops.posit_div_fused(f, a1, b1),
                ["elementwise_kernel"])
            per_call.append(f"K10 {label}{tag}")
    # K11 and K12 at the division rows' sizes (int32 words in, as the pair
    # sweep gives them), posit16 and K11 at posit32 srt_r4_scaled; the
    # posit-KV rounding as the model calls it (None: every kernel it launches)
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    gd = torch.Generator(device=dev).manual_seed(23)
    for size, label in (K10_SIZES[0], K10_SIZES[2]):
        a1, b1 = (torch.rand(size, device=dev, generator=gd) * 9.9 + 0.1 for _ in range(2))
        wa, wb = (ops.posit_quantize(POSIT16, t).to(torch.int32) for t in (a1, b1))
        sa, sb = (ops.posit_quantize(POSIT32, t).to(torch.int32) for t in (a1, b1))
        calls.update({
            f"K11 {label}": (lambda wa=wa, wb=wb: ops.posit_div(POSIT16, wa, wb), ["div_kernel"]),
            f"K11 {label} posit32 srt_r4_scaled": (
                lambda sa=sa, sb=sb: ops.posit_div(POSIT32, sa, sb, "srt_r4_scaled"),
                ["div_kernel"]),
            f"K12 quantize {label}": (lambda a1=a1: ops.posit_quantize(POSIT16, a1),
                                      ["::quantize_kernel"]),
            f"K12 dequantize {label}": (lambda wa=wa: ops.posit_dequantize(POSIT16, wa),
                                        ["dequantize_kernel"])})
        per_call += [f"K11 {label}", f"K11 {label} posit32 srt_r4_scaled",
                     f"K12 quantize {label}", f"K12 dequantize {label}"]
    kcfg = get_config("smollm_360m", smoke=True).with_numerics(kv_cache_format="posit16")
    for shape, label in ((KV_DECODE, "decode"), ((1 << 27,), "2^27+2^27")):
        kk, kv_ = (torch.randn(shape, device=dev, generator=gd).to(torch.bfloat16)
                   for _ in range(2))
        calls[f"K12 _kv_round {label}"] = (lambda kk=kk, kv_=kv_: layers._kv_round(kk, kv_, kcfg),
                                           None)
        per_call.append(f"K12 _kv_round {label}")
    if not only or {"K3", "K4"} & set(only):
        out["digests"] = decode_digests(torch, dev, F, (q, k, v, start), (gq, gk, gv, bt), pos)
    if not only or {"K3", "K5", "K6"} & set(only):
        fmts = [n for n in (8, 16, 32, 64) if f"posit_flash_attn_p{n}" in names
                or f"posit_flash_attn_p{n}_r4" in names]
        out.setdefault("digests", {}).update(tile_digests(torch, dev, F, fmts))
    if not only or {"K11", "K12"} & set(only):
        out.setdefault("digests", {}).update(division_digests(torch, dev))
    if not only or {"K7", "K8"} & set(only):
        fmts = [n for n in (8, 16, 32, 64) if f"posit_flash_bwd_p{n}" in names
                or f"posit_flash_bwd_p{n}_r4" in names]
        out.setdefault("digests", {}).update(backward_digests(torch, dev, F, fmts))
    if only:
        calls = {name: call for name, call in calls.items() if name.split()[0] in only}
    out["ms"] = {name: [] for name in calls}
    out["call_ms"] = {name: [] for name in per_call if name in calls}
    out["launches"] = {}
    out["from"] = []
    for _ in range(repeats):
        for name, (fn, names) in calls.items():
            iters = 5 if "2^28" in name or "2^27" in name else 20
            if names is None:   # every kernel the call launches
                ms, launches = device_call_launches(torch, fn, iters=iters)
                out["launches"][name] = launches
                how = "torch.profiler, every kernel" if launches else "CUDA events"
            else:
                ms, how = device_kernel_ms(torch, fn, names, iters=iters)
            out["ms"][name].append(ms)
            out["from"].append(how)
            if name in out["call_ms"]:   # many calls: the host's time is noisy
                out["call_ms"][name].append(cuda_time_ms(fn, iters=iters if iters < 20 else 200))
    # K2's bound and the same row-broadcast division by torch.div (f32, no posit)
    out["k2_bound_ms"], out["k2_torch_div_ms"] = {}, {}
    for name, (fmt, a2, b2) in k2_inputs.items():
        if name in calls:
            R, C = a2.shape
            out["k2_bound_ms"][name] = bound_ms(8 * R * C + 4 * R, div_ops(
                F.datapath_plan(fmt, DEFAULT_VARIANT), R * C))[0]
            out["k2_torch_div_ms"][name] = device_kernel_ms(
                torch, lambda a2=a2, b2=b2: torch.div(a2, b2), ["DivFunctor"])[0]
    print(json.dumps({"kernel_timing": out}))


def main() -> int:
    src = SRC
    ab_only = "--time-kernels" in sys.argv[1:]
    if "--src" in sys.argv[1:]:
        src = os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repository")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, src)
    if ab_only:
        from repro_torch.models.transformer import resolve_device

        only = None
        if "--only" in sys.argv[1:]:
            only = sys.argv[sys.argv.index("--only") + 1].split(",")
            check(only and set(only) <= set(ONLY_LIBRARIES),
                  f"--only takes kernels among {sorted(ONLY_LIBRARIES)}")
        time_kernels(torch, resolve_device("cuda:0"), src, only=only)
        print(gpu_line())
        return 0
    from repro_torch.core.posit import POSIT16, POSIT32, POSIT64
    from repro_torch.kernels import _build
    from repro_torch.kernels.posit_div import datapath_plan
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
    print(f"setup: {len(secs)} libraries built in parallel in {time.perf_counter() - t0:.1f} s")
    for n in secs:
        kernels = ptxas_kernels(_build.ptxas_log(n))
        by_fmt = collections.defaultdict(list)
        for k, r, sp in kernels:
            by_fmt[k.split()[1]].append((r, sp))
        print(f"setup: {n}: {secs[n]:.1f} s, {len(kernels)} kernels; ptxas per format: " +
              "; ".join(f"{f} {len(v)} kernels, at most {max(r for r, _ in v)} registers, "
                        f"{sum(sp for _, sp in v)} bytes of spill stores"
                        for f, v in sorted(by_fmt.items(), key=lambda fv: (len(fv[0]), fv[0]))))
        new = [f"{k} {r}/{sp}" for k, r, sp in kernels if k.split()[1] == "posit64"]
        if new and _build.LIBRARIES[n][0] in _build.PER_FORMAT + ("posit_softmax",):
            print(f"setup: ptxas {n}, posit64 kernels (registers/spill store bytes): "
                  + "; ".join(new))

    took = {"setup": time.perf_counter() - T_START}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        took[name] = took.get(name, 0.0) + time.perf_counter() - t
        return out

    div_err = timed("K1+K2", phase_rowwise, torch, dev)
    flash_err = timed("K3", phase_flash, torch, dev)
    paged_err = timed("K4", phase_paged_kernel, torch, dev)
    packed_err, packs_held = timed("K5", phase_packed_kernel, torch, dev)
    suffix_err = timed("K3 suffix", phase_suffix, torch, dev)
    softmax_err = timed("K9", phase_softmax, torch, dev)
    k11 = timed("K11", phase_pattern_div, torch, dev)
    cast_err = timed("K12", phase_casts, torch, dev)
    fused = timed("K10", phase_fused_chained, torch, dev)
    fused["K10"] += timed("K10", phase_f32_sweep, torch, dev)
    two = timed("two-word", phase_two_word, torch, dev)
    grid = timed("grid", phase_grid, torch, dev)
    timed("model", phase_model_small, torch, dev)
    for div_format in ("posit64", "posit32", "posit8"):
        timed("model", phase_model_small, torch, dev, "smollm_360m", div_format)
    timed("model", phase_model_small, torch, dev, "olmoe_1b_7b")
    timed("model", phase_model_small, torch, dev, "recurrentgemma_2b")
    train_err = timed("K6-K8", phase_flash_train, torch, dev)
    f32_err = timed("f32 K/V", phase_f32_kv, torch, dev)
    for div_format in ("posit16", "posit64", "posit32", "posit8"):
        timed("train", phase_train_small, torch, dev, div_format)
    timed("train", phase_train_small, torch, dev, "posit16", "olmoe_1b_7b")
    cfg, params = timed("main", full_model, torch, dev)
    path = timed("main", phase_main, torch, dev, cfg, params)
    cfg64 = cfg.with_numerics(div_format="posit64")
    path64 = timed("posit64", phase_main, torch, dev, cfg64, params, "posit64")
    differ = sum(not (a.shape == b.shape and bool((a == b).all()))
                 for a, b in zip(path["outs"], path64["outs"]))
    print(f"posit64: {differ} of {len(path['outs'])} requests' tokens differ from the "
          f"posit16 run's; {path64['tokens_per_s']:.1f} tokens/s against "
          f"{path['tokens_per_s']:.1f}")
    # posit32 and posit8 division through every SmolLM path: K2, K3 dense
    cfgs = {n: cfg.with_numerics(div_format=f"posit{n}") for n in NEW_FORMATS}
    paths = {}
    for n in NEW_FORMATS:
        label = f"posit{n}"
        paths[n] = timed(label, phase_main, torch, dev, cfgs[n], params, label)
        differ = sum(not np.array_equal(a, b) for a, b in zip(path["outs"], paths[n]["outs"]))
        print(f"{label}: {differ} of {len(path['outs'])} requests' tokens differ from the "
              f"posit16 run's; {paths[n]['tokens_per_s']:.1f} tokens/s against "
              f"{path['tokens_per_s']:.1f}")
    paged = timed("paged", phase_paged, torch, dev, cfg, params, packs_held)
    paged64 = timed("paged posit64", phase_paged, torch, dev, cfg64, params, packs_held,
                    "paged posit64", path64["outs"])
    # the paper's NRD baseline, posit64's longest datapath (63 non-restoring
    # iterations): the same requests, counts and tokens as the default plan's
    label = "paged posit64 nrd"
    paged64nrd = timed(label, phase_paged, torch, dev, cfg64.with_numerics(div_algo="nrd"),
                       params, packs_held, label, same_as=paged64["outs"])
    counts = {k: paged64nrd[k] for k in ("rowwise", "K3", "K4", "K5")}
    check(counts == {k: paged[k] for k in counts},
          f"{label}: launches {counts}, the posit16 paged run's {({k: paged[k] for k in counts})}")
    print(f"{label}: the posit16 paged run's launch counts ({counts})")
    pageds = {}
    for n in NEW_FORMATS:
        label = f"paged posit{n}"
        pageds[n] = timed(label, phase_paged, torch, dev, cfgs[n], params, packs_held, label,
                          paths[n]["outs"])
        counts = {k: pageds[n][k] for k in ("rowwise", "K3", "K4", "K5")}
        check(counts == {k: paged[k] for k in counts},
              f"{label}: launches {counts}, the posit16 paged run's "
              f"{ {k: paged[k] for k in counts} }")
        differ = sum(not np.array_equal(a, b) for a, b in zip(paged["outs"], pageds[n]["outs"]))
        print(f"{label}: the posit16 paged run's launch counts ({counts}); {differ} of "
              f"{len(paged['outs'])} requests' tokens differ from the posit16 paged run's")
    kv = timed("posit-KV", phase_posit_kv, torch, dev, *cut_model(cfg, params, POSIT_KV_LAYERS),
               packs_held)
    # the live session: submit / serve_stream, snapshot and restore, faults,
    # deadlines, stream_async, and the serving launcher
    stream = timed("stream", phase_stream, torch, dev, cfg, params, path["outs"], card)
    stream_paged = timed("stream paged", phase_stream_paged, torch, dev, cfg, params,
                         packs_held, paged["outs"], card)
    timed("launcher", phase_launcher, src)
    train = timed("training", phase_train_main, torch, dev)
    train64 = timed("training posit64", phase_train_main, torch, dev, "posit64", record=True)
    label = "training posit64 srt_r2_cs"
    train64r2 = timed(label, phase_train_main, torch, dev, "posit64", "srt_r2_cs", record=True,
                      profile=False)
    same_training(label, train64r2, train64)
    train32 = timed("training posit32", phase_train_main, torch, dev, "posit32")
    rows = timed("timing", phase_timing, torch, dev)
    for fmt, pg in ((POSIT16, paged), (POSIT64, paged64), (POSIT32, pageds[32])):
        rows.update(timed("timing", layout_rows, torch, dev, fmt, pg["pack"]))
        rows.update(timed("timing", training_rows, torch, dev, fmt))
    rows.update(timed("timing", training_rows, torch, dev, POSIT16, kv_f32=True))
    # posit64 nrd, the longest datapath: the forward's tile loop and K7/K8
    nrd64 = datapath_plan(POSIT64, "nrd")
    rows["K3 posit64 nrd prefill"] = timed("timing", flash_row, torch, dev, nrd64, 1, 256, 256,
                                           [0], [56], fmt=POSIT64)
    rows.update(timed("timing", layout_rows, torch, dev, POSIT64, paged64["pack"], "nrd"))
    rows.update(timed("timing", training_rows, torch, dev, POSIT64, variant="nrd"))
    print_rows({k: v for k, v in rows.items()
                if k[:2] in ("K4", "K5", "K6", "K7", "K8") or k == "K3 posit64 nrd prefill"})
    timed("plan table", plan_table, torch, dev, paged["pack"])
    rows.update(timed("timing", division_rows, torch, dev))
    timed("timing", decode_breakdown, torch, dev, cfg, params)
    timed("timing", decode_breakdown, torch, dev, cfg, params, paged=True)
    timed("timing", decode_breakdown, torch, dev, cfg64, params, paged=True)
    timed("timing", decode_breakdown, torch, dev, cfg.with_numerics(kv_cache_format="posit16"),
          params)
    timed("timing", decode_breakdown, torch, dev, cfg64, params)
    # the SmolLM state goes before OLMoE's 13.8 GB of weights come in
    del cfg, cfg64, cfgs, params
    gc.collect()
    torch.cuda.empty_cache()
    mcfg, mparams = timed("moe", moe_model, torch, dev)
    moe = timed("moe", phase_moe, torch, dev, mcfg, mparams)
    timed("timing", decode_breakdown, torch, dev, mcfg, mparams)
    moe_paged = timed("moe paged", phase_moe_paged, torch, dev, mcfg, mparams)
    timed("timing", decode_breakdown, torch, dev, mcfg, mparams, paged=True)
    # posit64 division through the router (K9, K2) and attention (K3 at hd
    # 128): the mix's first MOE64_REQUESTS requests, for the script's time
    mcfg64 = mcfg.with_numerics(div_format="posit64")
    moe64 = timed("moe posit64", phase_moe, torch, dev, mcfg64, mparams, MOE64_REQUESTS,
                  "moe posit64")
    differ = sum(not np.array_equal(a, b) for a, b in zip(moe["outs"], moe64["outs"]))
    print(f"moe posit64: {differ} of {MOE64_REQUESTS} requests' tokens differ from the "
          f"posit16 run's; {moe64['tokens_per_s']:.2f} tokens/s against "
          f"{moe['tokens_per_s']:.2f}")
    timed("timing", decode_breakdown, torch, dev, mcfg64, mparams)
    # posit64 srt_r4_cs (radix 4 without on-the-fly conversion): the mix's
    # first request, the default plan's tokens
    label = "moe posit64 srt_r4_cs"
    moe64r4 = timed(label, phase_moe, torch, dev, mcfg64.with_numerics(div_algo="srt_r4_cs"),
                    mparams, 1, label)
    off = [i for i, (a, b) in enumerate(zip(moe64r4["outs"], moe64["outs"]))
           if not np.array_equal(a, b)]
    check(not off, f"{label}: requests {off} differ from the default plan's posit64 run")
    print(f"{label}: request 0 the default plan's posit64 tokens, bit for bit")
    # posit32 (K9, K2, K3 on the one-word residual), the same 4 requests
    mcfg32 = mcfg.with_numerics(div_format="posit32")
    moe32 = timed("moe posit32", phase_moe, torch, dev, mcfg32, mparams, MOE64_REQUESTS,
                  "moe posit32")
    differ = sum(not np.array_equal(a, b) for a, b in zip(moe["outs"], moe32["outs"]))
    print(f"moe posit32: {differ} of {MOE64_REQUESTS} requests' tokens differ from the "
          f"posit16 run's; {moe32['tokens_per_s']:.2f} tokens/s against "
          f"{moe['tokens_per_s']:.2f}")
    # OLMoE's serving state goes before its training state (about 53 GB at
    # the AdamW update: 7 f32 trees of 1.88 B parameters) comes in
    del mcfg, mcfg64, mcfg32, mparams
    gc.collect()
    torch.cuda.empty_cache()
    train_moe = timed("training moe", phase_train_moe, torch, dev)
    rows.update(timed("timing", moe_rows, torch, dev))
    moe_train_rows = timed("timing", training_rows, torch, dev, POSIT16, heads=MOE_HEADS)
    print_rows(moe_train_rows)
    rows.update(moe_train_rows)
    # the hybrid family: RecurrentGemma-2B served (ring buffers, RG-LRU
    # state), its ring wrapped at 3 of 26 layers, and its whole-sequence
    # forward through the tile loop at head_dim 256
    hcfg, hparams = timed("hybrid", hybrid_model, torch, dev)
    hybrid = timed("hybrid", phase_hybrid, torch, dev,
                   *cut_model(hcfg, hparams, HYBRID_SERVE_LAYERS))
    hybrid_wrap = timed("hybrid wrap", phase_hybrid_wrap, torch, dev, hcfg, hparams)
    hybrid_fwd = timed("hybrid forward", phase_hybrid_forward, torch, dev, hcfg, hparams)
    timed("timing", decode_breakdown, torch, dev, hcfg, hparams)
    del hcfg, hparams
    gc.collect()
    torch.cuda.empty_cache()
    # hybrid training at 6 of 26 layers: K6-K8 at head_dim 256 with the window
    train_hybrid = timed("training hybrid", phase_train_hybrid, torch, dev)
    rows.update(timed("timing", hybrid_rows, torch, dev))
    # the ssm family: Mamba2-2.7B served at full width and depth (per-slot
    # conv and SSM state), its decode state at long_500k's max_seq, and its
    # whole-sequence forward through the chunked SSD
    scfg, sparams = timed("ssm", ssm_model, torch, dev)
    ssm = timed("ssm", phase_ssm, torch, dev, scfg, sparams)
    ssm_long = timed("ssm long", phase_ssm_long, torch, dev, scfg, sparams, ssm["probe"],
                     ssm["alone"])
    ssm_fwd = timed("ssm forward", phase_ssm_forward, torch, dev, scfg, sparams)
    del scfg, sparams
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(timed("timing", ssm_rows, torch, dev))
    print("posit8: one-step flips against the twins (K3-K6: outputs one posit8 step "
          f"off; K7/K8: gradients beyond {BWD_TOL}), gate share {POSIT8_FLIP_SHARE}: " +
          ", ".join(f"{k} {f} of {e} ({f / max(e, 1):.2e})"
                    for k, (f, e) in sorted(FLIPS8.items())))
    print("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
          + f"; total {time.perf_counter() - T_START:.1f} s")

    def entry(name, source, replaces, launches, err, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err,
                "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    csrc = "src/repro_torch/kernels/csrc/"
    runs = (path, path64, paged, paged64, train, train64, moe, moe64, train32, moe32,
            *paths.values(), *pageds.values(), paged64nrd, train64r2, moe64r4, moe_paged,
            train_moe, stream, stream_paged, hybrid, hybrid_wrap, hybrid_fwd, train_hybrid,
            ssm, ssm_long, ssm_fwd)
    ssm_k2 = sum(r["rowwise"] for r in (ssm, ssm_long, ssm_fwd))

    def launches(name):
        """``name``'s launches over every main path's run."""
        return sum(r.get(name, 0) for r in runs)

    kernels = [
        entry("K1 posit SRT datapath, one-word and two-word frames (inlined in K2-K11)",
              csrc + "posit_srt.cuh", "src/repro/kernels/posit_div.py:433",
              sum(launches(n) for n in ("rowwise", "K3", "K4", "K5", "K6", "K7", "K8", "K9"))
              + fused["K10"] + k11["launches"] + k11["K10"] + fused["K11"] + two["K10"]
              + two["K11"],
              div_err, rows["K1"]),
        entry("K2 rowwise fused posit divide", csrc + "posit_fused_div.cu",
              "src/repro/kernels/posit_fused_div.py:149", launches("rowwise") - ssm_k2, div_err,
              rows["K2 decode"]),
        entry("K2 at Mamba2-2.7B's rows (the block and final RMSNorms at 2560 columns, the "
              "gated norm at 5120; this line's times at a decode step's 8 x 5120)",
              csrc + "posit_fused_div.cu", "src/repro/kernels/posit_fused_div.py:149", ssm_k2,
              div_err, rows["K2 8x5120"]),
        entry("K3 posit flash attention, dense decode (the decode loop, flash_decode_kernel: "
              "a row's kv tiles over the block's warps)",
              csrc + "posit_flash_attn.cu", "src/repro/kernels/posit_flash_attn.py:330",
              launches("K3") - launches("K3 tile"),
              max(flash_err, grid["K3"], f32_err["K3"]), rows["K3 decode"]),
        entry("K3 posit flash attention, dense prefill (the tile loop, flash_tile_kernel; "
              "K5 and K6 run it too)", csrc + "posit_flash_attn.cu",
              "src/repro/kernels/posit_flash_attn.py:330", launches("K3 tile"),
              max(flash_err, suffix_err, f32_err["K3"], hybrid_fwd["err"]), rows["K3 prefill"]),
        entry("K4 posit flash attention, paged decode", csrc + "posit_flash_attn.cu",
              "src/repro/kernels/posit_flash_attn.py:330", launches("K4"),
              max(paged_err, f32_err["K4"]), rows["K4 decode"]),
        entry("K5 posit flash attention, packed prefill", csrc + "posit_flash_attn.cu",
              "src/repro/kernels/posit_flash_attn.py:330", launches("K5"),
              max(packed_err, f32_err["K5"]), rows["K5 packed prefill"]),
        entry("K6 posit flash attention forward saving (m, l)", csrc + "posit_flash_attn.cu",
              "src/repro/kernels/posit_flash_attn.py:330",
              launches("K6") - hybrid_fwd["K6"] - train_hybrid["K6"],
              max(train_err["K6"], f32_err["K6"]), rows["K6"]),
        entry("K6 at head_dim 256 with a 2048-key window (the tile loop's kTileHdMax class: "
              "RecurrentGemma-2B's whole-sequence forward and training)",
              csrc + "posit_flash_attn.cu", "src/repro/kernels/posit_flash_attn.py:330",
              hybrid_fwd["K6"] + train_hybrid["K6"], hybrid_fwd["err"],
              rows["K6 hd256 window"]),
        entry("K7 posit flash attention backward, dq", csrc + "posit_flash_bwd.cu",
              "src/repro/kernels/posit_flash_attn.py:601", launches("K7") - train_hybrid["K7"],
              max(train_err["K7"], f32_err["K7"]), rows["K7"]),
        entry("K7 at head_dim 256 with a 2048-key window (the backward's kBwdHdMax class: "
              "RecurrentGemma-2B's training)", csrc + "posit_flash_bwd.cu",
              "src/repro/kernels/posit_flash_attn.py:601", train_hybrid["K7"],
              train_hybrid["err"]["K7"], rows["K7 hd256 window"]),
        entry("K8 posit flash attention backward, dk and dv", csrc + "posit_flash_bwd.cu",
              "src/repro/kernels/posit_flash_attn.py:626", launches("K8") - train_hybrid["K8"],
              max(train_err["K8"], grid["K8"], f32_err["K8"]), rows["K8"]),
        entry("K8 at head_dim 256 with a 2048-key window (the backward's kBwdHdMax class: "
              "RecurrentGemma-2B's training)", csrc + "posit_flash_bwd.cu",
              "src/repro/kernels/posit_flash_attn.py:626", train_hybrid["K8"],
              train_hybrid["err"]["K8"], rows["K8 hd256 window"]),
        entry("K9 fused posit softmax (MoE router)", csrc + "posit_softmax.cu",
              "src/repro/kernels/posit_fused_div.py:210", launches("K9"), softmax_err,
              rows["K9 router"]),
        entry("K10 elementwise fused posit divide", csrc + "posit_fused_div.cu",
              "src/repro/kernels/posit_fused_div.py:103", fused["K10"] + two["K10"] + k11["K10"],
              0.0,
              rows["K10 64x1024"]),
        entry("K11 posit divide on bit patterns", csrc + "posit_div.cu",
              "src/repro/kernels/posit_div.py:652", k11["launches"] + fused["K11"] + two["K11"],
              0.0, rows["K11 64x1024"]),
        entry("K12 f32 -> posit quantize", csrc + "posit_cast.cu",
              "src/repro/kernels/posit_cast.py:43", fused["K12q"], cast_err,
              rows["K12 quantize 64x1024"]),
        entry("K12 posit -> f32 dequantize", csrc + "posit_cast.cu",
              "src/repro/kernels/posit_cast.py:65", fused["K12dq"], cast_err,
              rows["K12 dequantize 64x1024"]),
        entry("K12 round to the posit grid, K and V of a layer in one launch (the posit-KV "
              "path; the reference rounds with its jnp codec, no Pallas kernel)",
              csrc + "posit_cast.cu", "src/repro/kernels/posit_cast.py:43, :65", kv["K12r"],
              max(cast_err, kv["err"]), rows["K12 round kv decode"]),
        entry("K12 round to the posit grid, one gradient leaf a launch (gradient compression, "
              "grad_compress_format; the reference rounds with its jnp codec, no Pallas "
              "kernel)", csrc + "posit_cast.cu", "src/repro/kernels/posit_cast.py:43, :65",
              train_hybrid["K12r"], 0.0, rows["K12 round gradient leaf"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
