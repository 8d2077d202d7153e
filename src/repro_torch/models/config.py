"""Model configuration: the dense-family fields the serving and training
paths read.

Port of the reference package's ``models/config.py``, cut to what the
dense fused-posit paths read: attention always runs on the posit flash
kernel (the reference's ``attn_backend="fused"``) and the divisions on the
fused SRT kernels, and its backward is always the recompute flash backward
(the reference's ``attn_bwd="fused"``).  Other families (moe, ssm, hybrid,
encdec, vlm), tensor parallelism and ``remat="dots"`` come with later
slices (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.numerics.formats import NumericsConfig


def _pad_to(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
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
        if self.remat == "dots":
            raise NotImplementedError("remat='dots' is not ported (ROADMAP.md)")
        if self.remat not in ("full", "none"):
            raise ValueError(f"unknown remat {self.remat!r}; expected 'full' or 'none'")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (as the reference pads it)."""
        return _pad_to(self.vocab, 256)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
