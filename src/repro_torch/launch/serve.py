"""Serving launcher: drive a request stream through the continuous-batching
engine (or the static batch path with ``--static``) on one device.

    python -m repro_torch.launch.serve --arch smollm-360m [--smoke] \\
        [--requests N] [--max-new 16] [--batch 4] [--max-seq 256] \\
        [--kv-layout paged --block-size 16 --packed-prefill --shared-prefix LEN] \\
        [--stream | --emit-async] [--deadline-ms MS] [--max-queue N] \\
        [--max-queue-wait-ms MS] [--strict] [--posit-kv posit16] [--device cuda]

``--arch`` takes smollm-360m, olmoe-1b-7b, recurrentgemma-2b or
mamba2-2.7b (the ssm family: Mamba2, served from dense slots of constant-size
state; ``--kv-layout paged`` serves it from dense slots too, as the
reference's engine does).

``--stream`` consumes the engine's live event stream (tokens print as they
come), ``--emit-async`` drains it on a worker thread behind a bounded
queue.  ``--deadline-ms``, ``--max-queue`` and ``--max-queue-wait-ms`` set
the robustness limits (a request past its budget finishes ``DEADLINE``, a
submit past the queue bound ``SHED``).  The run ends with a summary line,
the time to first token and per-token latency percentiles and the finish
mix (``# slo:``), the pack and pool counters (``# packed:``, ``# paged:``)
and one line per request.

``--device`` defaults to ``cuda``; ``--device cpu`` runs the kernels' plain
twins.  The reference launcher's ``--attn-backend xla`` is not ported
(``ROADMAP.md`` §1 item 6: the port runs the fused numerics only) and exits
with an error; nor are its ``--tp``, ``--tp-groups`` and ``--replicas`` (§1
item 8, sharding and replicas) or ``--warmup`` (§1 item 2), which the
parser refuses as unrecognized.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import (FinishEvent, Request, ServeConfig, ServeEngine, TokenEvent,
                               stream_async)


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help="smollm-360m, olmoe-1b-7b, recurrentgemma-2b or mamba2-2.7b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests in the stream (default 2x batch)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4, help="decode slots (max_batch)")
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--posit-kv", type=str, default=None,
                    help="posit format of the KV cache (kv_cache_format)")
    ap.add_argument("--attn-backend", choices=["xla", "fused"], default="fused",
                    help="only 'fused' is ported")
    ap.add_argument("--static", action="store_true",
                    help="serve fixed batches to completion instead of the "
                         "continuous slot scheduler")
    ap.add_argument("--kv-layout", choices=["dense", "paged"], default="dense")
    ap.add_argument("--block-size", type=int, default=16,
                    help="rows of a KV page (paged; a power of two in [8, 128])")
    ap.add_argument("--packed-prefill", action="store_true",
                    help="admit each sweep's prompts as packed prefills")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="LEN",
                    help="prepend one shared LEN-token system prompt to half the "
                         "stream (the paged pool's prefix sharing)")
    ap.add_argument("--stream", action="store_true",
                    help="submit every request up front and print tokens as they "
                         "come from the live event stream")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="each request's budget from submission")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue: a submit past it sheds")
    ap.add_argument("--max-queue-wait-ms", type=float, default=None,
                    help="the queue-wait deadline of every request")
    ap.add_argument("--strict", action="store_true",
                    help="raise where a request would shed")
    ap.add_argument("--emit-async", action="store_true",
                    help="drain the event stream on a worker thread behind a "
                         "bounded queue (implies --stream)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.attn_backend != "fused":
        ap.error(f"--attn-backend {args.attn_backend} is not ported (ROADMAP.md §1 item 6); "
                 "the port serves the fused posit numerics only")
    if args.emit_async:
        args.stream = True
    cfg = get_config(args.arch, smoke=args.smoke, max_batch=args.batch,
                     max_seq=args.max_seq)
    if args.posit_kv:
        cfg = cfg.with_numerics(kv_cache_format=args.posit_kv)
    dev = T.resolve_device(args.device)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    sc = ServeConfig.from_model(
        cfg, temperature=args.temperature, kv_layout=args.kv_layout,
        block_size=args.block_size, max_queue=args.max_queue,
        max_queue_wait_ms=args.max_queue_wait_ms, packed_prefill=args.packed_prefill,
        strict=args.strict)
    eng = ServeEngine(cfg, params, sc, device=dev)

    # a mixed-length stream, more requests than slots, so that slots free and
    # re-admit mid-flight; --shared-prefix makes every other one fork one
    # system prompt, which the paged layout serves from shared pages
    n_req = args.requests or 2 * args.batch
    rng = np.random.default_rng(0)
    sys_p = (rng.integers(1, cfg.vocab, size=args.shared_prefix).astype(np.int32)
             if args.shared_prefix else np.zeros(0, np.int32))
    reqs = []
    for i in range(n_req):
        p = rng.integers(1, cfg.vocab, size=int(rng.integers(3, 12))).astype(np.int32)
        if args.shared_prefix and i % 2 == 0:
            p = np.concatenate([sys_p, p])
        reqs.append(Request(p, max_new=int(rng.integers(max(1, args.max_new // 2),
                                                        args.max_new + 1)),
                            deadline_ms=args.deadline_ms))

    t0 = time.perf_counter()
    results = {}
    if args.stream:
        for r in reqs:
            eng.submit(r)
        stream = stream_async(eng) if args.emit_async else eng.serve_stream()
        for ev in stream:
            if isinstance(ev, TokenEvent):
                print(f"req{ev.rid} += {ev.token}")
            elif isinstance(ev, FinishEvent):
                results[ev.rid] = ev.result
        outs = [results[i].tokens for i in sorted(results)]
    elif args.static:
        outs = eng.serve_static(reqs)
    else:
        outs = eng.serve(reqs)
        results = dict(enumerate(eng.last_results or []))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    mode = "stream" if args.stream else "static batches" if args.static else "continuous"
    print(f"# {mode}: {n_req} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, slots={args.batch}, kv_layout={args.kv_layout})")
    st = eng.last_serve_stats
    if st and not args.static:
        ttft, lats = st["ttft_ms"], st["token_latency_ms"]
        print(f"# slo: ttft_ms p50={_pct(ttft, 50):.1f} p99={_pct(ttft, 99):.1f}  "
              f"token_latency_ms p50={_pct(lats, 50):.2f} p99={_pct(lats, 99):.2f}  "
              f"finish={dict(st['finish_reasons'])}  faults={st['faults']} "
              f"deadline={st['deadline_evictions']} shed={st['shed']}")
    if st and st.get("packed_prefill"):
        print(f"# packed: packs={st['packed_packs']} segments={st['packed_segments']} "
              f"dummies={st['packed_dummies']}")
    if st and st.get("kv_layout") == "paged":
        print(f"# paged: block_size={st['block_size']} "
              f"peak_blocks={st['peak_blocks_in_use']}/{st['pool_blocks']} "
              f"prefix_hit_rate={st['prefix_hit_rate']:.0%} "
              f"({st['prefix_hit_tokens']}/{st['prompt_tokens']} prompt tokens served "
              "from shared pages)")
    for i, o in enumerate(outs):
        tag = f" [{results[i].finish.value}]" if i in results and results[i].detail else ""
        print(f"req{i}: prompt={reqs[i].tokens.tolist()} -> {np.asarray(o).tolist()}{tag}")
    return {"outputs": outs, "results": results, "stats": st}


if __name__ == "__main__":
    main()
