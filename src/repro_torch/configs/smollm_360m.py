"""SmolLM-360M — llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, head_dim=32,
    d_ff=192, vocab=512,
)
