"""Residual blocks (twin of ``repro.models.blocks``): the SwiGLU FFN, the
pre-norm decoder block of GQA or MLA attention and a dense FFN or an MoE
(with Arctic's parallel dense residual FFN), the Mamba2 block,
Zamba2's shared attention block and the cross-attention block (gated for
the VLM's image layers)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamFactory, rms_norm, swiglu


# -- dense FFN ----------------------------------------------------------------


def init_ffn(pf: ParamFactory, d_model: int, d_ff: int) -> None:
    pf.param("w_gate", (d_model, d_ff), ("d_model", "ffn"))
    pf.param("w_up", (d_model, d_ff), ("d_model", "ffn"))
    pf.param("w_down", (d_ff, d_model), ("ffn", "d_model"))


def ffn_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = swiglu(torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype)),
               torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype)))
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))


# -- standard decoder block (GQA or MLA attention + dense FFN or MoE) ---------


def init_decoder_block(pf: ParamFactory, cfg: ModelConfig, *,
                       kind: str) -> None:
    """kind: 'dense' | 'moe' | 'mla_dense' | 'mla_moe'."""
    d = cfg.d_model
    pf.param("ln_attn", (d,), ("d_model",), init="ones")
    pf.param("ln_mlp", (d,), ("d_model",), init="ones")
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


# -- mamba2 block --------------------------------------------------------------


def init_mamba_block(pf: ParamFactory, cfg: ModelConfig) -> None:
    pf.param("ln", (cfg.d_model,), ("d_model",), init="ones")
    with pf.scope("mixer"):
        ssm_mod.init_mamba2(pf, cfg)


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, decode: bool = False):
    """Returns (y, new_cache); ``decode`` takes one token against
    ``cache``, else the full sequence (a new cache when ``cache`` is not
    None, ``{}`` included)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if decode:
        y, new_cache = ssm_mod.mamba2_decode_step(p["mixer"], h, cfg, cache)
    else:
        y, new_cache = ssm_mod.mamba2_forward(p["mixer"], h, cfg, cache=cache)
    return x + y, new_cache


# -- zamba2 shared attention block ---------------------------------------------
# The shared block consumes concat(hidden, initial embedding) (the Zamba
# trick), projects back to d_model, then runs a dense decoder block whose
# weights every application shares.


def init_zamba_shared(pf: ParamFactory, cfg: ModelConfig) -> None:
    d = cfg.d_model
    pf.param("w_concat", (2 * d, d), ("d_model", None))
    pf.param("ln_in", (2 * d,), ("d_model",), init="ones")
    init_decoder_block(pf, cfg, kind="dense")


def zamba_shared_block(p: dict, x: torch.Tensor, x0: torch.Tensor,
                       cfg: ModelConfig, positions, *, cache=None, pos=None,
                       causal: bool = True):
    """Returns (y, new_cache): ``x`` plus the block's delta, ``x + (y -
    h)`` as the reference writes it (in bf16 it rounds otherwise than the
    block's own residual sum)."""
    h = torch.cat([x, x0], dim=-1)
    h = rms_norm(h, p["ln_in"], cfg.norm_eps)
    h = torch.einsum("bse,ed->bsd", h, p["w_concat"].to(x.dtype))
    y, new_cache, _ = decoder_block(p, h, cfg, positions, kind="dense",
                                    cache=cache, pos=pos, causal=causal)
    return x + (y - h), new_cache


# -- cross-attention block (vision / enc-dec) ----------------------------------


def init_cross_block(pf: ParamFactory, cfg: ModelConfig, *,
                     gated: bool) -> None:
    d = cfg.d_model
    pf.param("ln", (d,), ("d_model",), init="ones")
    with pf.scope("xattn"):
        attn.init_cross(pf, cfg, gated=gated)
    pf.param("ln_mlp", (d,), ("d_model",), init="ones")
    with pf.scope("mlp"):
        init_ffn(pf, d, cfg.d_ff)


def cross_block(p: dict, x: torch.Tensor, kv: dict, cfg: ModelConfig, *,
                gated: bool) -> torch.Tensor:
    """Pre-norm cross attention over ``kv`` (gated when ``gated``), then
    the SwiGLU FFN, which no gate scales."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    x = x + attn.cross_forward(p["xattn"], h, kv, gated=gated)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + ffn_forward(p["mlp"], h)
