"""OLMoE-1B-7B — MoE 64 experts top-8 [arXiv:2409.02060; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, rope_theta=10000.0,
    n_experts=64, experts_per_token=8,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab=512, n_experts=8, experts_per_token=2,
)
