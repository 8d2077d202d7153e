"""LR schedules (multiplier form, composed with ``AdamWConfig.lr``).

Port of the reference package's ``optim/schedule.py``: each schedule maps a
step (an int or an integer tensor) to a float32 multiplier tensor on the
step's device, computed in float32 as the reference does.
"""

from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(warmup: int, total: int, final_frac: float = 0.1):
    """Linear warmup to 1, then a cosine down to ``final_frac`` at ``total``."""

    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return f


def wsd_schedule(warmup: int, total: int, decay_frac: float = 0.1):
    """Warmup-stable-decay: linear warmup, flat, linear cooldown."""

    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        decay_start = total * (1 - decay_frac)
        dec = torch.clamp(1.0 - (s - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
        return torch.where(s < warmup, warm, torch.where(s < decay_start, 1.0, dec))

    return f
