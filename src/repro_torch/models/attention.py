"""Attention: grouped-query self attention with optional qk-norm,
DeepSeek's multi-head latent attention (MLA) with its compressed KV cache,
and cross attention over a memory (image patches, encoder states), gated
or plain (twin of ``repro.models.attention``).

Functional, as the reference: ``gqa_forward(params, x, ...)`` takes and
returns a KV cache dict for decode. A cache is a fixed-length sequence
buffer written at a scalar position ``pos``; attention masks to ``index <=
pos + i`` for the i-th new token. The write is out of place (a clone of the
caller's buffer with the new rows set), as the reference's
``dynamic_update_slice`` returns a new array.

Attention is plain torch (``einsum`` and ``softmax``), as the reference
computes it outside any Pallas kernel: K/V repeated to the query heads, the
logits in fp32 scaled by ``hd**-0.5``, masked with ``NEG_INF = -2**30``, the
probabilities cast to V's dtype. MLA keeps the reference's two branches:
with a cache (prefill into a cache, and decode) the absorbed form, which
never expands per-head K/V over the cache; without one the expanded form.
The reference's sharding hints (``shard_act``, ``seq_parallel``) change no
value and have no twin here; the caches' logical axes
(``gqa_cache_axes``, ``mla_cache_axes``) are the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamFactory, apply_rope, rms_norm

NEG_INF = -2.0**30


def init_gqa(pf: ParamFactory, cfg: ModelConfig) -> None:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    pf.param("wq", (d, h, hd), ("d_model", "heads", "head_dim"))
    pf.param("wk", (d, k, hd), ("d_model", "kv_heads", "head_dim"))
    pf.param("wv", (d, k, hd), ("d_model", "kv_heads", "head_dim"))
    pf.param("wo", (h, hd, d), ("heads", "head_dim", "d_model"))
    if cfg.qk_norm:
        pf.param("q_norm", (hd,), ("head_dim",), init="ones")
        pf.param("k_norm", (hd,), ("head_dim",), init="ones")


def _gqa_core(q, k, v, *, causal: bool, q_pos=None):
    """q [B,S,H,hd], k/v [B,T,K,hd]; GQA grouping H = K*g. Returns
    [B,S,H,hd] in V's dtype. K/V are repeated to the query heads."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scale = hd ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        qp = q_pos if q_pos is not None else torch.arange(S, device=q.device)
        mask = qp[:, None] >= torch.arange(T, device=q.device)[None, :]
        logits = torch.where(mask[None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _write(buf: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """``buf`` [B,T,...] with ``new`` [B,S,...] written at ``pos`` along the
    sequence, out of place; the start is clamped so the rows fit, as
    ``lax.dynamic_update_slice`` clamps it."""
    start = min(max(int(pos), 0), buf.shape[1] - new.shape[1])
    out = buf.clone()
    out[:, start:start + new.shape[1]] = new.to(buf.dtype)
    return out


def gqa_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, cache: Optional[dict] = None,
                pos=None, causal: bool = True):
    """Self attention. With ``cache`` (decode, or prefill into a cache):
    writes this step's K/V at ``pos`` and attends over slots <= its query
    position. Returns (out, new_cache)."""
    S = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        pos = int(pos)
        ck = _write(cache["k"], k, pos)
        cv = _write(cache["v"], v, pos)
        new_cache = {"k": ck, "v": cv}
        # absolute positions of the S query tokens; causal over the buffer
        q_pos = pos + torch.arange(S, device=x.device)
        out = _gqa_core(q, ck.to(x.dtype), cv.to(x.dtype), causal=True,
                        q_pos=q_pos)
    else:
        out = _gqa_core(q, k, v, causal=causal)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, new_cache


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq_len: int,
                    dtype) -> dict:
    """The cache's leaves as ``meta`` tensors: shapes and dtypes, nothing
    allocated (the reference's ``ShapeDtypeStruct``s)."""
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.hd())
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


def gqa_cache_axes() -> dict:
    return {"k": ("batch", "kv_seq", "kv_heads", None),
            "v": ("batch", "kv_seq", "kv_heads", None)}


# ----------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV cache, decoupled RoPE key, absorbed decode
# ----------------------------------------------------------------------------


def init_mla(pf: ParamFactory, cfg: ModelConfig) -> None:
    d, h = cfg.d_model, cfg.n_heads
    L, nope, rope_d, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                           cfg.v_head_dim)
    pf.param("wq", (d, h, nope + rope_d), ("d_model", "heads", "head_dim"))
    pf.param("w_dkv", (d, L), ("d_model", "lora"))
    pf.param("kv_norm", (L,), ("lora",), init="ones")
    pf.param("w_uk", (L, h, nope), ("lora", "heads", "head_dim"))
    pf.param("w_uv", (L, h, vd), ("lora", "heads", "head_dim"))
    pf.param("w_kpe", (d, rope_d), ("d_model", "head_dim"))
    pf.param("wo", (h, vd, d), ("heads", "head_dim", "d_model"))


def _masked_probs(logits: torch.Tensor, mask: torch.Tensor, dtype):
    logits = torch.where(mask, logits, NEG_INF)
    return torch.softmax(logits, dim=-1).to(dtype)


def mla_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, cache: Optional[dict] = None,
                pos=None, causal: bool = True):
    """MLA. With ``cache`` (``{"c": [B,T,L], "k_pe": [B,T,rope]}``): this
    step's compressed ``c`` and rotary key are written at ``pos`` and the
    queries attend in the absorbed form (``q_nope . w_uk`` against ``c``,
    the context through ``w_uv``). Returns (out, new_cache)."""
    B, S, _ = x.shape
    dt = x.dtype
    nope = cfg.qk_nope_dim
    scale = (nope + cfg.qk_rope_dim) ** -0.5
    f32 = torch.float32
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c = rms_norm(torch.einsum("bsd,dl->bsl", x, p["w_dkv"].to(dt)),
                 p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(torch.einsum("bsd,dr->bsr", x, p["w_kpe"].to(dt)),
                      positions, cfg.rope_theta, has_heads=False)

    if cache is not None:
        pos = int(pos)
        cc = _write(cache["c"], c, pos)
        cpe = _write(cache["k_pe"], k_pe, pos)
        new_cache = {"c": cc, "k_pe": cpe}
        T = cc.shape[1]
        q_pos = pos + torch.arange(S, device=x.device)
        mask = (q_pos[:, None] >= torch.arange(T, device=x.device)[None, :])
        # absorbed attention: per-head K/V never expanded over the cache
        q_abs = torch.einsum("bshn,lhn->bshl", q_nope, p["w_uk"].to(dt))
        logits = (torch.einsum("bshl,btl->bhst", q_abs.to(f32), cc.to(f32))
                  + torch.einsum("bshr,btr->bhst", q_pe.to(f32),
                                 cpe.to(f32))) * scale
        probs = _masked_probs(logits, mask[None, None], dt)
        ctx = torch.einsum("bhst,btl->bshl", probs, cc.to(dt))
        out = torch.einsum("bshl,lhv->bshv", ctx, p["w_uv"].to(dt))
    else:
        new_cache = None
        k_nope = torch.einsum("bsl,lhn->bshn", c, p["w_uk"].to(dt))
        v = torch.einsum("bsl,lhv->bshv", c, p["w_uv"].to(dt))
        logits = (torch.einsum("bshn,bthn->bhst", q_nope.to(f32),
                               k_nope.to(f32))
                  + torch.einsum("bshr,btr->bhst", q_pe.to(f32),
                                 k_pe.to(f32))) * scale
        if causal:
            ar = torch.arange(S, device=x.device)
            mask = ar[:, None] >= ar[None, :]
            probs = _masked_probs(logits, mask[None, None], dt)
        else:
            probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhst,bthv->bshv", probs, v)
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(dt))
    return y, new_cache


def mla_cache_shape(cfg: ModelConfig, batch: int, seq_len: int,
                    dtype) -> dict:
    """The MLA cache's leaves as ``meta`` tensors: the compressed ``c``
    [B, T, kv_lora_rank] and the rotary key ``k_pe`` [B, T, qk_rope_dim]."""
    return {"c": torch.empty((batch, seq_len, cfg.kv_lora_rank), dtype=dtype,
                             device="meta"),
            "k_pe": torch.empty((batch, seq_len, cfg.qk_rope_dim),
                                dtype=dtype, device="meta")}


def mla_cache_axes() -> dict:
    return {"c": ("batch", "kv_seq", "lora"), "k_pe": ("batch", "kv_seq", None)}


# ----------------------------------------------------------------------------
# Cross attention (vision / encoder-decoder)
# ----------------------------------------------------------------------------


def init_cross(pf: ParamFactory, cfg: ModelConfig, *,
               gated: bool = False) -> None:
    """GQA's projections without qk-norm; ``gated`` adds a scalar ``gate``
    drawn as zero, so a fresh gated block adds nothing until it trains."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    pf.param("wq", (d, h, hd), ("d_model", "heads", "head_dim"))
    pf.param("wk", (d, k, hd), ("d_model", "kv_heads", "head_dim"))
    pf.param("wv", (d, k, hd), ("d_model", "kv_heads", "head_dim"))
    pf.param("wo", (h, hd, d), ("heads", "head_dim", "d_model"))
    if gated:
        pf.param("gate", (), (), init="zeros")


def cross_kv(p: dict, memory: torch.Tensor) -> dict:
    """K/V over the memory [B, M, d] (image patches, encoder states), in
    the memory's dtype: computed once a prefill and kept in the cache."""
    k = torch.einsum("bmd,dhk->bmhk", memory, p["wk"].to(memory.dtype))
    v = torch.einsum("bmd,dhk->bmhk", memory, p["wv"].to(memory.dtype))
    return {"k": k, "v": v}


def cross_forward(p: dict, x: torch.Tensor, kv: dict, *,
                  gated: bool = False) -> torch.Tensor:
    """Every query attends to every memory slot (no mask, no rope); with
    ``gated`` the output is scaled by ``tanh(gate)``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    out = _gqa_core(q, kv["k"].to(x.dtype), kv["v"].to(x.dtype), causal=False)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if gated:
        y = y * torch.tanh(p["gate"].to(y.dtype))
    return y
