"""arctic-480b [moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: every layer runs a dense FFN residual (d_ff=4864) in
parallel with a 128-expert top-2 MoE (expert d_ff=4864). Adam's fp32 moments
for 468B expert params exceed 16 GB/chip even fully sharded on 256 chips, so
training cells default to Adafactor (recorded in EXPERIMENTS.md §Roofline).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    moe_d_ff=4864,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    vocab_size=32_000,
    rope_theta=1e4,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adafactor",
    learning_rate=1e-2,
    remat=True,
)

SMOKE = CONFIG.with_(
    capacity_factor=8.0,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, moe_d_ff=96,
    n_experts=8, top_k=2, vocab_size=128, remat=False,
    param_dtype="float32", compute_dtype="float32",
)
