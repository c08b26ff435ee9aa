"""Decoder-only language model, ``family="dense"`` (Qwen3, Granite, Yi)
and ``family="moe"`` (DeepSeek-V2-Lite: MLA attention, an MLA-dense first
layer, shared + routed experts; Arctic: GQA, 128 experts top-2 and a
parallel dense residual FFN) (twin of ``repro.models.lm``).

API (functional, as the reference):

    lm = DecoderLM(cfg)
    params = lm.init(generator)                    # or device="meta"
    logits, caches, aux = lm.apply(params, batch)  # train / prefill
    loss, metrics = lm.loss(params, batch)
    struct = lm.cache_struct(batch, cache_len)     # meta tensors
    logits, caches = lm.decode_step(params, caches, tokens, pos)

Params keep the reference's names, shapes and leaf order: ``tok_embed``,
``ln_f``, ``head`` (untied only), ``layers = {"first": [], "stack": {...}}``
with every stack leaf on a leading layers axis; the ``first``
``first_dense_layers`` layers are the family's dense kind (``mla_dense``
for DeepSeek). The reference's ``lax.scan`` over the stack is a Python
loop over that axis, summing the layers' MoE aux losses in its order; its
``jax.checkpoint`` (``cfg.remat``) is ``torch.utils.checkpoint`` around
each layer under plain autograd. Under ``torch.func`` transforms (the
cohort trainer's ``vmap(grad_and_value)``) torch's checkpoint raises
("don't yet support saved tensor hooks"), so there the layers run without
it; remat changes no value either way. The SSM, hybrid and VLM families
come with later slices and raise.
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
                                       softmax_cross_entropy)

Params = Any

FAMILY_SLICE = {"ssm": blk.SSM_SLICE, "hybrid": blk.SSM_SLICE,
                "vlm": attn.CROSS_SLICE, "encdec": attn.CROSS_SLICE}
FAMILIES = ("dense", "moe")


def _dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def block_kind(cfg: ModelConfig) -> str:
    mla = "mla_" if cfg.kv_lora_rank else ""
    return f"{mla}moe" if cfg.n_experts else f"{mla}dense" if mla else "dense"


def _remat_active(cfg: ModelConfig) -> bool:
    return (cfg.remat and torch.is_grad_enabled()
            and not torch._C._are_functorch_transforms_active())


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"DecoderLM family {cfg.family!r} ({cfg.name}) comes with a "
                f"later slice of the port "
                f"({FAMILY_SLICE.get(cfg.family, 'not planned')})")
        self.cfg = cfg
        self.kind = block_kind(cfg)
        self.dense_kind = self.kind.replace("moe", "dense")
        self.pdtype = _dtype(cfg.param_dtype)
        self.cdtype = _dtype(cfg.compute_dtype)

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Params:
        """Params drawn from ``generator`` on its device (or on ``device``;
        ``"meta"`` draws nothing): the embedding factory's params first
        (``tok_embed``, ``ln_f``, ``head``), then the layers, in the order
        of the reference's key split."""
        cfg = self.cfg
        pf = ParamFactory(generator, self.pdtype, device)
        pf.param("tok_embed", (cfg.vocab_size, cfg.d_model), init="embed")
        pf.param("ln_f", (cfg.d_model,), init="ones")
        if not cfg.tie_embeddings:
            pf.param("head", (cfg.d_model, cfg.vocab_size))
        params = pf.params
        first = []
        for _ in range(cfg.first_dense_layers):
            pf1 = ParamFactory(generator, self.pdtype, pf.device)
            blk.init_decoder_block(pf1, cfg, kind=self.dense_kind)
            first.append(pf1.params)
        stack = init_stacked(
            lambda pf_: blk.init_decoder_block(pf_, cfg, kind=self.kind),
            generator, cfg.n_layers - cfg.first_dense_layers, self.pdtype,
            device=pf.device)
        params["layers"] = {"first": first, "stack": stack}
        return params

    # --------------------------------------------------------------- helpers
    def _embed(self, params, tokens):
        return params["tok_embed"][tokens.long()].to(self.cdtype)

    def _head(self, params, x):
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x,
                                params["tok_embed"].to(x.dtype))
        return torch.einsum("bsd,dv->bsv", x, params["head"].to(x.dtype))

    def _layers(self, params, x, positions, caches, pos):
        """Every layer in order; ``caches`` None (no cache) or
        ``{"first": [...], "stack": {k: [L, ...]}}``. Returns (x, new
        caches or None, aux)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def layer(p_i, x, c_i, kind=self.kind):
            return blk.decoder_block(p_i, x, cfg, positions, kind=kind,
                                     cache=c_i, pos=pos)

        new_first = []
        for i, p_i in enumerate(params["layers"]["first"]):
            c_i = caches["first"][i] if caches is not None else None
            x, nc, a = layer(p_i, x, c_i, self.dense_kind)
            aux = aux + a
            new_first.append(nc)
        stack = params["layers"]["stack"]
        new_stack = []
        remat = _remat_active(cfg)
        for i in range(cfg.n_layers - cfg.first_dense_layers):
            p_i = tree_map(lambda t: t[i], stack)
            c_i = (tree_map(lambda t: t[i], caches["stack"])
                   if caches is not None else None)
            if remat:
                x, nc, a = checkpoint(layer, p_i, x, c_i, use_reentrant=False)
            else:
                x, nc, a = layer(p_i, x, c_i)
            aux = aux + a
            new_stack.append(nc)
        if caches is None:
            return x, None, aux
        return x, {"first": new_first,
                   "stack": tree_map(lambda *xs: torch.stack(xs),
                                     *new_stack)}, aux

    # ---------------------------------------------------- full-sequence pass
    def apply(self, params: Params, batch: dict, *, make_cache: bool = False,
              cache_len: Optional[int] = None):
        """batch: {'tokens': [B,S] int}. Returns (logits [B,S,V],
        caches_or_None, aux_loss); with ``make_cache`` the K/V of the S
        tokens are written at 0 into caches of ``cache_len`` (default S)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        caches = (self._attn_cache_zeros(B, cache_len or S, x.device)
                  if make_cache else None)
        x, caches, aux = self._layers(params, x, positions, caches,
                                      0 if make_cache else None)
        return self._head(params, x), caches, aux

    # ------------------------------------------------------------------ loss
    def loss(self, params: Params, batch: dict):
        logits, _, aux = self.apply(params, batch)
        targets = batch["targets"]
        mask = targets >= 0
        ce = softmax_cross_entropy(logits, torch.clamp(targets, min=0), mask)
        return ce + aux, {"ce": ce, "aux": aux}

    # ----------------------------------------------------------- cache utils
    def cache_struct(self, batch: int, cache_len: int) -> dict:
        """The cache tree as ``meta`` tensors (shapes and dtypes):
        ``{"first": [one] * first_dense_layers, "stack": [L, ...] one}``,
        ``one`` the MLA cache (``c``, ``k_pe``) when ``kv_lora_rank``,
        else the GQA cache (``k``, ``v``)."""
        cfg = self.cfg
        shape = (attn.mla_cache_shape if cfg.kv_lora_rank
                 else attn.gqa_cache_shape)
        one = shape(cfg, batch, cache_len, self.cdtype)
        n = cfg.n_layers - cfg.first_dense_layers
        return {"first": [dict(one) for _ in range(cfg.first_dense_layers)],
                "stack": {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                         device="meta")
                          for k, v in one.items()}}

    def _attn_cache_zeros(self, B: int, T: int, device) -> dict:
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device),
                        self.cache_struct(B, T))

    # ----------------------------------------------------------- decode step
    def decode_step(self, params: Params, caches: Params,
                    tokens: torch.Tensor, pos):
        """tokens [B, 1]; pos the write index (an int or a 0-d tensor).
        Returns (logits [B,1,V], new caches); the caller's caches are not
        written."""
        x = self._embed(params, tokens)
        pos = int(pos)
        positions = pos + torch.arange(1, device=x.device)
        x, new_caches, _ = self._layers(params, x, positions, caches, pos)
        return self._head(params, x), new_caches
