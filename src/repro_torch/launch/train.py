"""Training launcher on one device.

    python -m repro_torch.launch.train --arch smollm-360m [--smoke] \\
        [--steps N] [--global-batch 8] [--seq-len 256] [--microbatches 1] \\
        [--lr 3e-4] [--ckpt-dir DIR] [--ckpt-every 50] [--device cuda]

Trains the fused posit numerics (posit16 SRT division, the posit flash
kernels forward and backward) on ``SyntheticLMDataset``.  ``--device``
defaults to ``cuda``; ``--device cpu`` runs the kernels' plain twins.  The
reference launcher's ``--distributed``, ``--posit-division``,
``--attn-backend`` and ``--grad-compress`` are not ported: the port has one
numerics and one device (``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.train import CheckpointManager, TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(steps=args.steps, microbatches=args.microbatches, lr=args.lr,
                     ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
                     ckpt_dir=args.ckpt_dir)
    ds = SyntheticLMDataset(DataConfig(args.global_batch, args.seq_len), cfg)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    try:
        res = Trainer(cfg, tc, ds, ckpt, device=args.device).run()
    finally:
        if ckpt is not None:
            ckpt.close()
    last = res["history"][-1]
    print(f"final: step {last['step']} loss {last['loss']:.4f} "
          f"({len(res['stragglers'])} straggler events)")
    return res


if __name__ == "__main__":
    main()
