"""qwen3-4b [dense] 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]. head_dim=128 (explicit in HF config)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adam",
    learning_rate=3e-4,
    remat=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, param_dtype="float32", compute_dtype="float32",
)
