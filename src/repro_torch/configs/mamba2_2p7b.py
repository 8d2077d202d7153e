"""Mamba2-2.7B — SSD (state-space duality), attention-free [arXiv:2405.21060]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, ssm_state=16, ssm_headdim=32, ssm_chunk=64,
    vocab=512,
)
