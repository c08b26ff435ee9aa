"""seamless-m4t-large-v2 [audio] 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Interpreted as 24 encoder + 24 decoder layers (speech encoder and text
decoder are both 24L in SeamlessM4T-large). The audio frontend is a STUB per
the assignment: input_specs() provides precomputed frame embeddings
[B, S, d_model].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    rope_theta=1e4,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer="adam",
    learning_rate=3e-4,
    remat=True,
)

SMOKE = CONFIG.with_(
    n_layers=4, enc_layers=2, dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=128,
    param_dtype="float32", compute_dtype="float32",
)
