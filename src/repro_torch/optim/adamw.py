"""AdamW on the port's parameter tree.

Port of the reference package's ``optim/adamw.py``, with its order of
operations: clip by the global gradient norm, update the moments, correct
their bias, then ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, with
weight decay on every leaf.  ``torch.optim.AdamW`` is not used: it decays
the weights in another order and so rounds differently.

The optimizer state mirrors the parameter tree (``m``, ``v``) plus an
int32 ``step``; :func:`adamw_update` returns new trees and leaves its
inputs as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[Any], Any]] = None


def adamw_init(params):
    """Zero moments shaped like ``params`` and step 0 (on the params'
    device)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (float32), leaves summed in
    the tree's flattening order."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(g.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step: returns ``(new_params, new_state, metrics)`` with
    ``grad_norm`` and ``lr`` as float32 tensors."""
    step = state["step"] + 1
    step_f = step.to(torch.float32)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule else torch.ones_like(step_f))

    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip
             else torch.ones_like(gnorm))

    b1t = 1.0 - cfg.b1 ** step_f
    b2t = 1.0 - cfg.b2 ** step_f

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1t
        vh = v / b2t
        new_p = p - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p)
        return new_p.to(p.dtype), m, v

    outs = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = (_select(outs, i) for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}, {
        "grad_norm": gnorm, "lr": lr}


def _select(outs, i: int):
    """The ``i``-th entry of every ``(p, m, v)`` leaf tuple of ``outs``."""
    if isinstance(outs, dict):
        return {k: _select(o, i) for k, o in outs.items()}
    if isinstance(outs, list):
        return [_select(o, i) for o in outs]
    return outs[i]
