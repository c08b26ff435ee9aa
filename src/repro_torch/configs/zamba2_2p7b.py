"""zamba2-2.7b [hybrid] 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242].

54 Mamba2 layers; one *weight-shared* full-attention transformer block is
applied every 6 mamba layers (9 applications), consuming
concat(hidden, initial_embedding) per the Zamba trick.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    attn_period=6,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adam",
    learning_rate=3e-4,
    remat=True,
)

SMOKE = CONFIG.with_(
    n_layers=4, attn_period=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=128, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    param_dtype="float32", compute_dtype="float32",
)
