"""qwen3-1.7b [dense] 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
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
