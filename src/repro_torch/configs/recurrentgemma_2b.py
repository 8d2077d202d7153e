"""RecurrentGemma-2B — RG-LRU + local attention, 1:2 [arXiv:2402.19427; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, rope_theta=10000.0,
    attn_period=3, local_window=2048, lru_width=2560,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab=512, local_window=64, lru_width=128,
)
