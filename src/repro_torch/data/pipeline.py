"""Deterministic, shardable synthetic data.

Port of the reference package's ``data/pipeline.py`` (numpy only, so the
batches are the reference's bits): ``SyntheticLMDataset`` generates
reproducible pseudo-token streams from a counter-based hash, so any (step,
host) pair regenerates its exact batch and a checkpoint needs no data state
beyond the step counter.  The port's only family is dense, so batches hold
``tokens`` alone; the reference's ``make_batch_specs`` (JAX shape stand-ins)
has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    markov_order: int = 2   # gives synthetic data learnable structure


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """xorshift-mult avalanche hash on uint32 (vectorized, deterministic)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


class SyntheticLMDataset:
    """Counter-based synthetic LM tokens with short-range structure."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{num_hosts} hosts")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.host_batch = cfg.global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        vocab = self.model_cfg.vocab
        rows = np.arange(self.host_batch) + self.host_id * self.host_batch
        ctr = (np.uint32(c.seed) + _hash_u32(
            np.uint32(step) + _hash_u32(rows.astype(np.uint32))[:, None]
            * np.uint32(2654435761)))
        pos = np.arange(c.seq_len, dtype=np.uint32)[None, :]
        h = _hash_u32(ctr + pos)
        tokens = (h % np.uint32(max(vocab - 1, 1))).astype(np.int32)
        # inject learnable bigram structure: every other token repeats prev+1
        rep = (pos % np.uint32(self.cfg.markov_order + 1)) != 0
        shifted = np.roll(tokens, 1, axis=1)
        tokens = np.where(rep, (shifted + 1) % max(vocab - 1, 1), tokens)
        return {"tokens": tokens}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
