"""yi-6b [dense] 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
— llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=5e6,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adam",
    learning_rate=3e-4,
    remat=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
    param_dtype="float32", compute_dtype="float32",
)
