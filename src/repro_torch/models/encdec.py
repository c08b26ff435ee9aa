"""Encoder-decoder LM, the seamless-m4t family (twin of
``repro.models.encdec``). The audio frontend is a stub, as in the
reference: the batch carries precomputed frame embeddings ``frames [B,
S_enc, d_model]``; the transformer backbone (encoder self attention,
decoder self and cross attention) is real.

API (functional, as the reference):

    lm = EncDecLM(cfg)
    params = lm.init(generator)                    # or device="meta"
    enc = lm.encode(params, frames)
    logits, caches, aux = lm.apply(params, {"frames": ..., "tokens": ...})
    loss, metrics = lm.loss(params, batch)
    struct = lm.cache_struct(batch, cache_len, enc_len)   # meta tensors
    logits, caches = lm.decode_step(params, caches, tokens, pos)

Params keep the reference's names, shapes and leaf order: ``tok_embed``,
``ln_enc``, ``ln_f``, ``head`` (always untied), ``encoder`` (``enc_layers``
dense decoder blocks run unmasked, stacked on a leading axis) and
``decoder`` (``dec_layers`` blocks of causal self attention, plain cross
attention over the encoder's output and a SwiGLU FFN, stacked likewise).
Each stacked leaf is drawn in place (``init_stacked``). The reference's
``lax.scan`` over either stack is a Python loop; its ``jax.checkpoint``
(``cfg.remat``) is ``torch.utils.checkpoint`` around each layer under
plain autograd, and no remat under ``torch.func`` transforms (see
``models.lm``). Decode reads every decoder layer's cross K/V from the
cache and never runs the encoder again.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models.common import (ParamFactory, init_stacked, rms_norm,
                                       softmax_cross_entropy, stacked_axes)
from repro_torch.models.lm import _dtype, _remat_active, _stacked, _zeros

Params = Any


def _init_dec_block(pf: ParamFactory, cfg: ModelConfig) -> None:
    d = cfg.d_model
    pf.param("ln_self", (d,), ("d_model",), init="ones")
    with pf.scope("self"):
        attn.init_gqa(pf, cfg)
    pf.param("ln_cross", (d,), ("d_model",), init="ones")
    with pf.scope("cross"):
        attn.init_cross(pf, cfg, gated=False)
    pf.param("ln_mlp", (d,), ("d_model",), init="ones")
    with pf.scope("mlp"):
        blk.init_ffn(pf, d, cfg.d_ff)


def _dec_block(p: dict, x: torch.Tensor, enc_kv: dict, cfg: ModelConfig,
               positions, *, cache=None, pos=None):
    """Returns (y, new self-attention cache or None)."""
    h = rms_norm(x, p["ln_self"], cfg.norm_eps)
    a, new_cache = attn.gqa_forward(p["self"], h, cfg, positions,
                                    cache=cache, pos=pos, causal=True)
    x = x + a
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
    x = x + attn.cross_forward(p["cross"], h, enc_kv, gated=False)
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + blk.ffn_forward(p["mlp"], h), new_cache


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pdtype = _dtype(cfg.param_dtype)
        self.cdtype = _dtype(cfg.compute_dtype)

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Params:
        """Params drawn from ``generator`` on its device (or on ``device``;
        ``"meta"`` draws nothing): the factory's four leaves, then the
        encoder, then the decoder, in the order of the reference's key
        split."""
        return self._init(generator, device)[0]

    def param_axes(self) -> dict:
        """The logical axes of every param, shaped as the params (the
        reference's second return of ``init``)."""
        return self._init(None, "meta")[1]

    def _init(self, generator, device) -> tuple[Params, dict]:
        cfg = self.cfg
        pf = ParamFactory(generator, self.pdtype, device)
        pf.param("tok_embed", (cfg.vocab_size, cfg.d_model),
                 ("vocab", "d_model"), init="embed")
        pf.param("ln_enc", (cfg.d_model,), ("d_model",), init="ones")
        pf.param("ln_f", (cfg.d_model,), ("d_model",), init="ones")
        pf.param("head", (cfg.d_model, cfg.vocab_size), ("d_model", "vocab"))
        params, axes = pf.params, pf.axes
        enc = lambda pf_: blk.init_decoder_block(pf_, cfg, kind="dense")
        dec = lambda pf_: _init_dec_block(pf_, cfg)
        params["encoder"] = init_stacked(enc, generator, cfg.enc_layers,
                                         self.pdtype, device=pf.device)
        params["decoder"] = init_stacked(dec, generator, cfg.dec_layers,
                                         self.pdtype, device=pf.device)
        axes["encoder"], axes["decoder"] = stacked_axes(enc), stacked_axes(dec)
        return params, axes

    # ---------------------------------------------------------------- encode
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, S_enc, d] -> the encoder's output [B, S_enc, d] in the
        compute dtype: every layer unmasked, then ``ln_enc``."""
        cfg = self.cfg
        x = frames.to(self.cdtype)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = _remat_active(cfg)

        def layer(p_i, x):
            return blk.decoder_block(p_i, x, cfg, positions, kind="dense",
                                     causal=False)[0]

        for i in range(cfg.enc_layers):
            p_i = tree_map(lambda t: t[i], params["encoder"])
            x = (checkpoint(layer, p_i, x, use_reentrant=False) if remat
                 else layer(p_i, x))
        return rms_norm(x, params["ln_enc"], cfg.norm_eps)

    # ------------------------------------------------------------- full pass
    def _decoder(self, params, x, positions, caches, pos, enc_out=None):
        """Every decoder layer in order over the cross K/V (computed from
        ``enc_out``, or read from ``caches["cross"]`` in decode).
        ``caches`` None or ``{"self": [L, ...], "cross": [L, ...] or
        None}`` (None in a prefill). Returns (x, new caches or None)."""
        cfg = self.cfg
        dec = params["decoder"]
        remat = _remat_active(cfg)

        def layer(p_i, x, c_i, kv):
            if kv is None:
                kv = attn.cross_kv(p_i["cross"], enc_out)
            y, nc = _dec_block(p_i, x, kv, cfg, positions, cache=c_i,
                               pos=pos)
            return y, nc, kv

        new_self, new_kv = [], []
        for i in range(cfg.dec_layers):
            p_i = tree_map(lambda t: t[i], dec)
            c_i = kv = None
            if caches is not None:
                c_i = tree_map(lambda t: t[i], caches["self"])
                if caches["cross"] is not None:
                    kv = tree_map(lambda t: t[i], caches["cross"])
            if remat:
                x, nc, kv = checkpoint(layer, p_i, x, c_i, kv,
                                       use_reentrant=False)
            else:
                x, nc, kv = layer(p_i, x, c_i, kv)
            if caches is not None:
                new_self.append(nc)
                new_kv.append(kv)
        if caches is None:
            return x, None
        return x, {"self": tree_map(_stacked, *new_self),
                   "cross": (tree_map(_stacked, *new_kv)
                             if caches["cross"] is None else caches["cross"])}

    def apply(self, params: Params, batch: dict, *, make_cache: bool = False,
              cache_len: Optional[int] = None):
        """batch: {'frames': [B,S_enc,d], 'tokens': [B,S] int}. Returns
        (logits [B,S,V], caches_or_None, aux_loss = 0); with ``make_cache``
        the decoder's self K/V are written at 0 into caches of
        ``cache_len`` (default S) and ``caches["cross"]`` holds every
        decoder layer's K/V over the encoder's output."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = params["tok_embed"][tokens.long()].to(self.cdtype)
        positions = torch.arange(S, device=x.device)
        caches = None
        if make_cache:
            caches = {"self": _zeros(self.cache_struct(
                B, cache_len or S, enc_out.shape[1])["self"], x.device),
                "cross": None}
        x, caches = self._decoder(params, x, positions, caches,
                                  0 if make_cache else None, enc_out)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._head(params, x), caches, aux

    def _head(self, params, x):
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return torch.einsum("bsd,dv->bsv", x, params["head"].to(x.dtype))

    def loss(self, params: Params, batch: dict):
        logits, _, aux = self.apply(params, batch)
        targets = batch["targets"]
        mask = targets >= 0
        ce = softmax_cross_entropy(logits, torch.clamp(targets, min=0), mask)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    def cache_struct(self, batch: int, cache_len: int, enc_len: int) -> dict:
        """The cache tree as ``meta`` tensors: ``{"self": {"k", "v":
        [dec_layers, B, cache_len, K, hd]}, "cross": {"k", "v":
        [dec_layers, B, enc_len, K, hd]}}``, in the compute dtype."""
        cfg = self.cfg

        def stacked(one):
            return {k: torch.empty((cfg.dec_layers,) + tuple(v.shape),
                                   dtype=v.dtype, device="meta")
                    for k, v in one.items()}

        return {"self": stacked(attn.gqa_cache_shape(
                    cfg, batch, cache_len, self.cdtype)),
                "cross": stacked(attn.gqa_cache_shape(
                    cfg, batch, enc_len, self.cdtype))}

    def cache_axes(self) -> dict:
        """The logical axes of ``cache_struct``'s leaves (the reference's
        second return of ``cache_struct``)."""
        self_axes = {k: ("layers",) + v
                     for k, v in attn.gqa_cache_axes().items()}
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"self": self_axes, "cross": {"k": kv, "v": kv}}

    def decode_step(self, params: Params, caches: Params,
                    tokens: torch.Tensor, pos):
        """tokens [B, 1]; pos the write index (an int or a 0-d tensor).
        Returns (logits [B,1,V], new caches); the caller's caches are not
        written, and the cross K/V are handed on as they are."""
        x = params["tok_embed"][tokens.long()].to(self.cdtype)
        pos = int(pos)
        positions = pos + torch.arange(1, device=x.device)
        x, new_caches = self._decoder(params, x, positions, caches, pos)
        return self._head(params, x), new_caches
