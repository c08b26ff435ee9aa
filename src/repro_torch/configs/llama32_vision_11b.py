"""llama-3.2-vision-11b [vlm] 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

40 total decoder layers are interpreted as 32 self-attn + 8 gated cross-attn
(one per 4 self layers), matching the HF layout. The vision frontend is a
STUB per the assignment: input_specs() provides precomputed patch embeddings
[B, 1601, d_model] (560px / 14px patches + CLS).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=32,
    cross_attn_period=4,   # 32/4 = 8 cross-attn blocks -> 40 blocks total
    n_patches=1601,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    rope_theta=5e5,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adam",
    learning_rate=3e-4,
    remat=True,
)

SMOKE = CONFIG.with_(
    n_layers=4, cross_attn_period=2, n_patches=16, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=128,
    param_dtype="float32", compute_dtype="float32",
)
