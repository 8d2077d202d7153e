"""Model configuration: the dense-, moe- and hybrid-family fields the
serving and training paths read.

Port of the reference package's ``models/config.py``, cut to what the
fused-posit paths read: attention always runs on the posit flash kernel
(the reference's ``attn_backend="fused"``) and the divisions on the fused
SRT kernels, and its backward is always the recompute flash backward (the
reference's ``attn_bwd="fused"``).  The dense and moe families serve (dense
KV slots or the paged pool) and train; the hybrid family (RG-LRU blocks and
local attention, one attention layer in ``attn_period``) serves from dense
slots and runs its whole-sequence ``forward``.  The other families (ssm,
encdec, vlm), tensor parallelism and ``remat="dots"`` come with later slices
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.numerics.formats import NumericsConfig


FAMILIES = ("dense", "moe", "hybrid")


def _pad_to(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # "dense" | "moe" | "hybrid"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (RG-LRU + local attention, 1 attn per `attn_period`) ---
    attn_period: int = 0        # 3 -> layers i % 3 == 2 are attention
    local_window: int = 0
    lru_width: int = 0
    conv_width: int = 4
    rope_theta: float = 500000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    numerics: NumericsConfig = dataclasses.field(default_factory=NumericsConfig)
    serve_max_batch: int = 8     # persistent decode slots in the engine
    serve_max_seq: int = 512     # per-slot KV-cache rows (prompt + new)
    remat: str = "full"          # full (recompute each block in the
    #                              backward) | none

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        self.numerics.validate()
        if self.family not in FAMILIES:
            raise NotImplementedError(f"family {self.family!r} is not ported; have "
                                      f"{FAMILIES} (ROADMAP.md)")
        if self.family == "moe" and not 0 < self.experts_per_token <= self.n_experts:
            raise ValueError(f"moe needs 0 < experts_per_token <= n_experts; got "
                             f"{self.experts_per_token} of {self.n_experts}")
        if self.family == "hybrid" and (self.attn_period < 1 or self.local_window < 1):
            raise ValueError(f"hybrid needs attn_period >= 1 and local_window >= 1; got "
                             f"{self.attn_period} and {self.local_window}")
        if self.remat == "dots":
            raise NotImplementedError("remat='dots' is not ported (ROADMAP.md)")
        if self.remat not in ("full", "none"):
            raise ValueError(f"unknown remat {self.remat!r}; expected 'full' or 'none'")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (as the reference pads it)."""
        return _pad_to(self.vocab, 256)

    def is_attn_layer(self, i: int) -> bool:
        """Is layer ``i`` an attention layer (every layer but the hybrid
        family's recurrent ones)?"""
        if self.family != "hybrid":
            return True
        return i % self.attn_period == (self.attn_period - 1)

    def with_numerics(self, **kw) -> "ModelConfig":
        """Merge ``kw`` into the existing numerics (e.g. only
        ``kv_cache_format`` overridden)."""
        return dataclasses.replace(self, numerics=dataclasses.replace(self.numerics, **kw))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
