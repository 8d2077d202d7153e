"""Microbatched training loop on one device.

Port of the reference package's ``train/trainer.py``.  The train step:
  * splits the global batch into ``microbatches`` and accumulates float32
    gradients over them (bounds activation memory at large model scale),
  * rounds the gradients to a posit grid when
    ``cfg.numerics.grad_compress_format`` is set (``optim.grad_compress``),
  * applies AdamW (+ cosine schedule, clipping) on f32 master params.

The host loop adds checkpoint/restore (atomic, resumable), straggler
watermarks, deterministic data (any step regenerates its batch) and metric
logging.  The reference's sharded production mesh, and the compressed
all-reduce over it, are not ported (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.grad_compress import compress_gradients
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    log_every: int = 10
    ckpt_every: int = 0          # 0 = disabled
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    seed: int = 0
    straggler_factor: float = 3.0


def init_train_state(cfg: ModelConfig, tc: TrainConfig, device="cuda") -> Dict[str, Any]:
    """f32 master parameters drawn from ``tc.seed`` on ``device``, and zero
    AdamW state."""
    device = T.resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(tc.seed)
    params = T.init_params(cfg, gen, device=device, dtype=torch.float32)
    return {"params": params, "opt": adamw_init(params)}


def loss_and_grads(params, cfg: ModelConfig, batch):
    """``((loss, metrics), grads)`` of ``T.train_loss`` at ``params``, all
    detached; the grads form a tree shaped like ``params``."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = T.train_loss(leaves, cfg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: a new state and
    float32 scalar tensors ``loss``, ``nll``, ``zloss``, ``tokens``, ``acc``,
    ``grad_norm`` and ``lr``."""
    opt_cfg = AdamWConfig(
        lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
        schedule=cosine_schedule(tc.warmup, tc.steps),
    )

    def split_micro(batch):
        out = []
        for name, x in batch.items():
            if x.shape[0] % tc.microbatches:
                raise ValueError(f"batch of {x.shape[0]} does not split into "
                                 f"{tc.microbatches} microbatches")
            out.append((name, x.chunk(tc.microbatches)))
        return [{name: parts[i] for name, parts in out} for i in range(tc.microbatches)]

    def train_step(state, batch):
        params = state["params"]
        if tc.microbatches == 1:
            (loss, metrics), grads = loss_and_grads(params, cfg, batch)
        else:
            g_acc, loss, ms = None, 0.0, []
            for mb in split_micro(batch):
                (l, m), g = loss_and_grads(params, cfg, mb)
                g_acc = g if g_acc is None else tree_map(torch.add, g_acc, g)
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda g: g / tc.microbatches, g_acc)
            loss = loss / tc.microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        if cfg.numerics.grad_compress_format:
            grads = compress_gradients(grads, cfg.numerics.grad_compress_format)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, params, grads, state["opt"])
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


class StragglerMonitor:
    """Per-step wall-time watermarks; flags steps >> median (straggler/hang)."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.durations: list = []
        self.window = window
        self.flagged: list = []

    def record(self, step: int, dt: float) -> bool:
        self.durations.append(dt)
        hist = self.durations[-self.window:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if dt > self.factor * med:
                self.flagged.append((step, dt, med))
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)
                return True
        return False


class Trainer:
    """Host-side loop on one device: data, train step, checkpointing, resume."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, dataset,
                 ckpt_manager=None, train_step=None, state=None, device="cuda"):
        self.cfg = cfg
        self.tc = tc
        self.dataset = dataset
        self.ckpt = ckpt_manager
        self.device = T.resolve_device(device)
        self.step_fn = train_step or make_train_step(cfg, tc)
        self.monitor = StragglerMonitor(tc.straggler_factor)
        self.state = state if state is not None else init_train_state(cfg, tc, self.device)
        self.start_step = 0
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(like=self.state)
            if restored is not None:
                self.state, self.start_step = restored
                log.info("resumed from checkpoint at step %d", self.start_step)

    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train from the start (or resumed) step to ``steps``; returns the
        logged ``history`` (float metrics plus ``step`` and ``sec``), the
        ``final_step`` and the flagged ``stragglers``."""
        steps = steps if steps is not None else self.tc.steps
        history = []
        for step in range(self.start_step, steps):
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in self.dataset.batch_at(step).items()}
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])     # waits for the step to finish
            dt = time.perf_counter() - t0
            self.monitor.record(step, dt)
            if step % self.tc.log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"], m["sec"] = step, dt
                history.append(m)
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            if self.ckpt is not None and self.tc.ckpt_every and (
                    step + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(self.state, step + 1)
        if self.ckpt is not None and self.tc.ckpt_every:
            self.ckpt.save(self.state, steps, wait=True)
        return {"history": history, "final_step": steps,
                "stragglers": self.monitor.flagged}
