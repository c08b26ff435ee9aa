"""deepseek-v2-lite-16b [moe] 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64e top-6 — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf].

Note: the assignment line says "2 shared+160 routed"; 160 routed belongs to
full DeepSeek-V2. The HF config for V2-Lite is 64 routed + 2 shared, top-6,
which we implement (see DESIGN.md §5). Layer 0 is a dense-FFN MLA layer
(first_dense_layers=1) with d_ff=10944; experts use moe_d_ff=1408.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    moe_d_ff=1408,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    vocab_size=102_400,
    rope_theta=1e4,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adam",
    learning_rate=3e-4,
    remat=True,
)

SMOKE = CONFIG.with_(
    capacity_factor=8.0,
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, moe_d_ff=32,
    n_experts=8, n_shared_experts=2, top_k=2, first_dense_layers=1,
    kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
    vocab_size=128, param_dtype="float32", compute_dtype="float32",
)
