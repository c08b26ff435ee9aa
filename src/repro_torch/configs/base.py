"""Architecture / run configuration dataclasses and the config registry.

Every assigned architecture lives in ``repro/configs/<id>.py`` exposing:

  CONFIG  -- the exact published configuration (full scale)
  SMOKE   -- a reduced configuration of the same family for CPU smoke tests

Configs are looked up by id via :func:`get_config` (used by ``--arch`` in the
launchers).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class ModelConfig:
    """Superset config covering all supported model families."""

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm | paper-*

    # -- transformer core ---------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 256
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                  # expert hidden size (d_ff used for dense parts)
    dense_residual: bool = False       # arctic-style parallel dense MLP
    first_dense_layers: int = 0        # deepseek: leading dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- MLA (deepseek) -----------------------------------------------------
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # -- SSM (mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # -- hybrid (zamba2) ------------------------------------------------------
    attn_period: int = 0               # shared attn block every N mamba layers

    # -- enc-dec (seamless) ---------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0

    # -- vlm (llama-3.2 vision) ----------------------------------------------
    cross_attn_period: int = 0         # one cross-attn block per N self-attn layers
    n_patches: int = 0                 # stub frontend: precomputed patch embeddings

    # -- numerics -------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # -- training defaults ----------------------------------------------------
    optimizer: str = "adam"            # adam | sgd | momentum | adafactor
    learning_rate: float = 1e-3
    remat: bool = False                # activation checkpointing over layer scan
    zero1: bool = True                 # shard optimizer state over the data axis
    # roofline-exact lowering: XLA's cost_analysis counts while-loop bodies
    # once, so the dry-run lowers a fully-unrolled variant for FLOP/collective
    # extraction (production programs keep the scan).
    unroll_layers: bool = False

    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The four assigned LM shapes (identical across all ten architectures),
# plus the paper-technique cell: one asynchronous aggregation round over a
# cohort of K=32 client updates (global_batch carries K).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
    "fl_round": ShapeConfig("fl_round", 0, 32, "flround"),
}

# Architectures capable of long_500k decode (sub-quadratic sequence mixing).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")

ARCH_IDS: Sequence[str] = (
    "qwen3-1.7b",
    "granite-8b",
    "yi-6b",
    "qwen3-4b",
    "llama-3.2-vision-11b",
    "zamba2-2.7b",
    "deepseek-v2-lite-16b",
    "arctic-480b",
    "mamba2-370m",
    "seamless-m4t-large-v2",
)

_MODULE_FOR: dict[str, str] = {
    "qwen3-1.7b": "qwen3_1p7b",
    "granite-8b": "granite_8b",
    "yi-6b": "yi_6b",
    "qwen3-4b": "qwen3_4b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "zamba2-2.7b": "zamba2_2p7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "arctic-480b": "arctic_480b",
    "mamba2-370m": "mamba2_370m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    # the paper's own four models
    "paper-mnist": "paper_mnist",
    "paper-femnist": "paper_femnist",
    "paper-shakespeare": "paper_shakespeare",
    "paper-speech": "paper_speech",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a runnable cell? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "pure full-attention arch: O(S^2) at 524k; skipped per assignment"
    return True, ""
