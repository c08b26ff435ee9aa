"""mamba2-370m [ssm] 48L d_model=1024 (attn-free) vocab=50280, ssm_state=128
— SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,          # unused (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adam",
    learning_rate=6e-4,
    remat=True,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, vocab_size=128, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, param_dtype="float32", compute_dtype="float32",
)
