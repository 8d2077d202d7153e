"""Serving example for the PyTorch/CUDA port: continuous batching on the
slot engine, a paged run whose requests share a system prompt, then the
live event stream with a request submitted mid-flight and a tight deadline.

    PYTHONPATH=src python examples/serve_lm_torch.py        # on the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --smoke

The port's counterpart of ``examples/serve_lm.py``.  With ``--kv-layout
paged`` (the second run) the attention KV lives in a refcounted block pool:
every other request opens with the same 16-token system prompt, whose pages
later admissions share instead of prefilling them again, and the tokens
stay those of the dense layout.  The streaming half consumes tokens as
they are produced, submits a request while the engine decodes, and shows
each request's structured ``FinishReason``: the tight deadline finishes
``DEADLINE`` with its partial output.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import FinishEvent, Request, ServeConfig, ServeEngine, TokenEvent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--block-size", type=int, default=16,
                    help="rows of a KV page in the paged run (power of two in [8, 128])")
    ap.add_argument("--packed-prefill", action="store_true",
                    help="admit each sweep's prompts as packed prefills")
    args = ap.parse_args(argv)

    dev = T.resolve_device(args.device)
    cfg = get_config("smollm-360m", smoke=args.smoke, max_batch=4, max_seq=160)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    # a stream twice as long as the slot count: short requests finish, free
    # their slot, and the queue admits the next one mid-flight; every other
    # request opens with one 16-token system prompt
    rng = np.random.default_rng(0)
    sys_p = rng.integers(1, cfg.vocab, size=16).astype(np.int32)
    reqs = []
    for i, (n, m) in enumerate(((5, 24), (9, 8), (3, 24), (7, 12), (4, 16), (11, 8),
                                (6, 24), (8, 10))):
        p = rng.integers(1, cfg.vocab, size=n).astype(np.int32)
        reqs.append(Request(np.concatenate([sys_p, p]) if i % 2 == 0 else p, max_new=m))
    runs = {}
    for layout in ("dense", "paged"):
        eng = ServeEngine(cfg, params, ServeConfig.from_model(
            cfg, kv_layout=layout, block_size=args.block_size,
            packed_prefill=args.packed_prefill), device=dev)
        t0 = time.perf_counter()
        runs[layout] = outs = eng.serve(reqs)
        dt = time.perf_counter() - t0
        total = sum(len(o) for o in outs)
        print(f"kv_layout={layout}: {len(reqs)} requests, {total} tokens in {dt:.2f}s "
              f"({total / dt:.1f} tok/s, slots={cfg.serve_max_batch})")
        st = eng.last_serve_stats
        if st["packed_prefill"]:
            print(f"  packed: packs={st['packed_packs']} segments={st['packed_segments']} "
                  f"dummies={st['packed_dummies']}")
        if layout == "paged":
            print(f"  paged: peak_blocks={st['peak_blocks_in_use']}/{st['pool_blocks']} "
                  f"prefix_hit_rate={st['prefix_hit_rate']:.0%} "
                  f"({st['prefix_hit_tokens']}/{st['prompt_tokens']} prompt tokens from "
                  "shared pages)")
        for i, o in enumerate(outs[:2]):
            print(f"  req{i}: {reqs[i].tokens.tolist()} -> {o[:10].tolist()}...")
    same = all(np.array_equal(a, b) for a, b in zip(runs["dense"], runs["paged"]))
    print(f"paged tokens {'=' if same else '!='} dense tokens")

    # ---------------------------------------------------- streaming + statuses
    print("\nstreaming (live admission + deadline):")
    eng = ServeEngine(cfg, params, ServeConfig.from_model(cfg), device=dev)
    rng = np.random.default_rng(1)
    prompt = lambda n: rng.integers(1, cfg.vocab, size=n).astype(np.int32)
    eng.submit(Request(prompt(6), max_new=12))
    eng.submit(Request(prompt(4), max_new=64, deadline_ms=1.0))
    got, results, submitted_late = {}, {}, False
    for ev in eng.serve_stream():
        if isinstance(ev, TokenEvent):
            got.setdefault(ev.rid, []).append(ev.token)
            if not submitted_late and len(got.get(0, [])) >= 3:
                eng.submit(Request(prompt(5), max_new=4))      # mid-flight
                submitted_late = True
        elif isinstance(ev, FinishEvent):
            results[ev.rid] = ev.result
    for rid in sorted(results):
        r = results[rid]
        ttft = None if r.ttft_ms is None else round(r.ttft_ms, 1)
        print(f"  req{rid}: finish={r.finish.value:9s} tokens={len(r.tokens)} "
              f"ttft_ms={ttft}" + (f" ({r.detail})" if r.detail else ""))
    return runs, results


if __name__ == "__main__":
    main()
