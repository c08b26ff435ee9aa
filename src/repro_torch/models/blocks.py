"""Residual blocks (twin of the decoder part of ``repro.models.blocks``):
the SwiGLU FFN and the pre-norm decoder block of GQA or MLA attention and a
dense FFN or an MoE (with Arctic's parallel dense residual FFN). The
mamba, zamba and cross-attention blocks come with later slices and
raise."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ParamFactory, later_slice, rms_norm,
                                       swiglu)

SSM_SLICE = "the SSM + hybrid slice"


# -- dense FFN ----------------------------------------------------------------


def init_ffn(pf: ParamFactory, d_model: int, d_ff: int) -> None:
    pf.param("w_gate", (d_model, d_ff))
    pf.param("w_up", (d_model, d_ff))
    pf.param("w_down", (d_ff, d_model))


def ffn_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = swiglu(torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype)),
               torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype)))
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))


# -- standard decoder block (GQA or MLA attention + dense FFN or MoE) ---------


def init_decoder_block(pf: ParamFactory, cfg: ModelConfig, *,
                       kind: str) -> None:
    """kind: 'dense' | 'moe' | 'mla_dense' | 'mla_moe'."""
    d = cfg.d_model
    pf.param("ln_attn", (d,), init="ones")
    pf.param("ln_mlp", (d,), init="ones")
    with pf.scope("attn"):
        if kind.startswith("mla"):
            attn.init_mla(pf, cfg)
        else:
            attn.init_gqa(pf, cfg)
    with pf.scope("mlp"):
        if kind.endswith("moe"):
            moe_mod.init_moe(pf, cfg)
            if cfg.dense_residual:
                with pf.scope("dense_res"):
                    init_ffn(pf, d, cfg.d_ff)
        else:
            init_ffn(pf, d, cfg.d_ff)


def decoder_block(p: dict, x: torch.Tensor, cfg: ModelConfig, positions, *,
                  kind: str, cache: Optional[dict] = None, pos=None,
                  causal: bool = True):
    """Returns (y, new_cache, aux_loss); a dense block's aux loss is 0."""
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    attn_fn = attn.mla_forward if kind.startswith("mla") else attn.gqa_forward
    a, new_cache = attn_fn(p["attn"], h, cfg, positions, cache=cache, pos=pos,
                           causal=causal)
    x = x + a
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if kind.endswith("moe"):
        m, aux = moe_mod.moe_forward(p["mlp"], h, cfg)
        if cfg.dense_residual:
            m = m + ffn_forward(p["mlp"]["dense_res"], h)
    else:
        m = ffn_forward(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, new_cache, aux


init_mamba_block = later_slice("init_mamba_block", SSM_SLICE)
mamba_block = later_slice("mamba_block", SSM_SLICE)
init_zamba_shared = later_slice("init_zamba_shared", SSM_SLICE)
zamba_shared_block = later_slice("zamba_shared_block", SSM_SLICE)
init_cross_block = later_slice("init_cross_block", attn.CROSS_SLICE)
cross_block = later_slice("cross_block", attn.CROSS_SLICE)
