"""Decoder-only language model (twin of ``repro.models.lm``):
``family="dense"`` (Qwen3, Granite, Yi), ``family="moe"``
(DeepSeek-V2-Lite: MLA attention, an MLA-dense first layer, shared +
routed experts; Arctic: GQA, 128 experts top-2 and a parallel dense
residual FFN), ``family="ssm"`` (Mamba2: every layer a Mamba2 block),
``family="hybrid"`` (Zamba2: chunks of ``attn_period`` Mamba2 blocks, each
chunk followed by one attention block whose weights all chunks share) and
``family="vlm"`` (Llama-3.2-Vision: chunks of one gated cross-attention
block over the image patches, then ``cross_attn_period`` dense self
layers). The enc-dec family is ``models.encdec.EncDecLM``.

API (functional, as the reference):

    lm = DecoderLM(cfg)
    params = lm.init(generator)                    # or device="meta"
    logits, caches, aux = lm.apply(params, batch)  # train / prefill
                                                   # (vlm: batch["patches"])
    loss, metrics = lm.loss(params, batch)
    struct = lm.cache_struct(batch, cache_len)     # meta tensors
    logits, caches = lm.decode_step(params, caches, tokens, pos)

Params keep the reference's names, shapes and leaf order: ``tok_embed``,
``ln_f``, ``head`` (untied only), and ``layers``: ``{"first": [],
"stack": {...}}`` for dense and moe, every stack leaf on a leading layers
axis, the ``first`` ``first_dense_layers`` layers the family's dense kind
(``mla_dense`` for DeepSeek); ``{"stack": {...}}`` for ssm; ``{"shared":
{...}, "stack": {...}}`` for hybrid, the stack's leaves ``[n_chunks,
attn_period, ...]`` (views of one ``[L, ...]`` allocation); ``{"cross":
{...}, "stack": {...}}`` for vlm, the self layers' stack ``[n_cross,
cross_attn_period, ...]`` (views likewise) beside the ``n_cross`` gated
cross blocks stacked on a leading axis. The reference's ``lax.scan`` over
the stack is a Python loop over that axis, summing the layers' MoE aux
losses in its order; its ``jax.checkpoint`` (``cfg.remat``) is
``torch.utils.checkpoint`` under plain autograd, around each layer, and
for hybrid and vlm around each whole chunk, as the reference's scopes.
Under ``torch.func`` transforms (the cohort trainer's
``vmap(grad_and_value)``) torch's checkpoint raises ("don't yet support
saved tensor hooks"), so there the layers run without it; remat changes
no value either way.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamFactory, init_stacked, map_axes,
                                       rms_norm, softmax_cross_entropy,
                                       stacked_axes)

Params = Any

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
MAMBA_FAMILIES = ("ssm", "hybrid")


def _dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def block_kind(cfg: ModelConfig) -> str:
    mla = "mla_" if cfg.kv_lora_rank else ""
    return f"{mla}moe" if cfg.n_experts else f"{mla}dense" if mla else "dense"


def _stacked(*xs: torch.Tensor) -> torch.Tensor:
    return torch.stack(xs)


def _zeros(struct, device):
    """Zeros shaped as a tree of ``meta`` tensors, on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), struct)


def _remat_active(cfg: ModelConfig) -> bool:
    return (cfg.remat and torch.is_grad_enabled()
            and not torch._C._are_functorch_transforms_active())


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"DecoderLM does not handle family "
                             f"{cfg.family} ({cfg.name})")
        period = {"hybrid": ("attn_period", cfg.attn_period),
                  "vlm": ("cross_attn_period", cfg.cross_attn_period)}
        if cfg.family in period and cfg.n_layers % period[cfg.family][1]:
            name, n = period[cfg.family]
            raise ValueError(
                f"{cfg.name}: {cfg.n_layers} layers do not split into "
                f"chunks of {name} {n}")
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
        (``tok_embed``, ``ln_f``, ``head``), then the layers (for hybrid
        the stack, then the shared block; for vlm the self layers, then
        the cross blocks), in the order of the reference's key split."""
        return self._init(generator, device)[0]

    def param_axes(self) -> dict:
        """The logical axes of every param (a tree of tuples shaped as the
        params), the reference's second return of ``init``."""
        return self._init(None, "meta")[1]

    def _init(self, generator, device) -> tuple[Params, dict]:
        cfg = self.cfg
        pf = ParamFactory(generator, self.pdtype, device)
        pf.param("tok_embed", (cfg.vocab_size, cfg.d_model),
                 ("vocab", "d_model"), init="embed")
        pf.param("ln_f", (cfg.d_model,), ("d_model",), init="ones")
        if not cfg.tie_embeddings:
            pf.param("head", (cfg.d_model, cfg.vocab_size),
                     ("d_model", "vocab"))
        params, axes = pf.params, pf.axes
        again = lambda a: ("layers",) + a     # a chunked stack's 2nd axis
        if cfg.family in MAMBA_FAMILIES:
            block = lambda pf_: blk.init_mamba_block(pf_, cfg)
            stack = init_stacked(block, generator, cfg.n_layers, self.pdtype,
                                 device=pf.device)
            params["layers"] = {"stack": stack}
            axes["layers"] = {"stack": stacked_axes(block)}
            if cfg.family == "hybrid":
                n_chunks = cfg.n_layers // cfg.attn_period
                params["layers"]["stack"] = tree_map(
                    lambda t: t.view(n_chunks, cfg.attn_period,
                                     *t.shape[1:]), stack)
                axes["layers"]["stack"] = map_axes(axes["layers"]["stack"],
                                                   again)
                pf_s = ParamFactory(generator, self.pdtype, pf.device)
                blk.init_zamba_shared(pf_s, cfg)
                params["layers"]["shared"] = pf_s.params
                axes["layers"]["shared"] = pf_s.axes
            return params, axes
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_period
            block = lambda pf_: blk.init_decoder_block(pf_, cfg, kind="dense")
            cross_block = lambda pf_: blk.init_cross_block(pf_, cfg,
                                                           gated=True)
            stack = init_stacked(block, generator, cfg.n_layers, self.pdtype,
                                 device=pf.device)
            cross = init_stacked(cross_block, generator, n_cross, self.pdtype,
                                 device=pf.device)
            params["layers"] = {
                "stack": tree_map(lambda t: t.view(
                    n_cross, cfg.cross_attn_period, *t.shape[1:]), stack),
                "cross": cross}
            axes["layers"] = {"stack": map_axes(stacked_axes(block), again),
                              "cross": stacked_axes(cross_block)}
            return params, axes
        first, first_axes = [], []
        for _ in range(cfg.first_dense_layers):
            pf1 = ParamFactory(generator, self.pdtype, pf.device)
            blk.init_decoder_block(pf1, cfg, kind=self.dense_kind)
            first.append(pf1.params)
            first_axes.append(pf1.axes)
        block = lambda pf_: blk.init_decoder_block(pf_, cfg, kind=self.kind)
        stack = init_stacked(block, generator,
                             cfg.n_layers - cfg.first_dense_layers,
                             self.pdtype, device=pf.device)
        params["layers"] = {"first": first, "stack": stack}
        axes["layers"] = {"first": first_axes, "stack": stacked_axes(block)}
        return params, axes

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
                   "stack": tree_map(_stacked, *new_stack)}, aux

    def _mamba_layers(self, params, x, positions, caches, pos,
                      decode: bool):
        """The ssm and hybrid families' layers in order. ``caches`` None
        (no cache) or ``{"stack": ..., "shared": ...}`` (``shared`` for
        hybrid only): in a prefill (not ``decode``) ``stack`` is None, each
        mamba layer making its state from the forward, and ``shared`` the
        zeroed K/V of every shared-block application; in decode both hold
        the states the step reads. Returns (x, new caches or None)."""
        cfg = self.cfg
        stack = params["layers"]["stack"]
        remat = _remat_active(cfg)

        def mamba(p_i, x, c_i):
            return blk.mamba_block(p_i, x, cfg, cache=c_i, decode=decode)

        def state(c, i=None):
            """The mamba state of layer ``c`` (of chunk ``c``'s layer
            ``i``) for the call: None without a cache, {} in a prefill."""
            if caches is None:
                return None
            if caches["stack"] is None:
                return {}
            idx = (c,) if i is None else (c, i)
            return tree_map(lambda t: t[idx], caches["stack"])

        if cfg.family == "ssm":
            new = []
            for i in range(cfg.n_layers):
                p_i = tree_map(lambda t: t[i], stack)
                if remat:
                    x, nc = checkpoint(mamba, p_i, x, state(i),
                                       use_reentrant=False)
                else:
                    x, nc = mamba(p_i, x, state(i))
                new.append(nc)
            if caches is None:
                return x, None
            return x, {"stack": tree_map(_stacked, *new)}

        x0 = x
        shared = params["layers"]["shared"]

        def chunk(c, x, kv):
            m_new = []
            for i in range(cfg.attn_period):
                x, nc = mamba(tree_map(lambda t: t[c, i], stack), x,
                              state(c, i))
                m_new.append(nc)
            y, kv = blk.zamba_shared_block(shared, x, x0, cfg, positions,
                                           cache=kv, pos=pos)
            return y, m_new, kv

        new_m, new_kv = [], []
        for c in range(cfg.n_layers // cfg.attn_period):
            kv = (tree_map(lambda t: t[c], caches["shared"])
                  if caches is not None else None)
            if remat:
                x, m_new, kv = checkpoint(chunk, c, x, kv,
                                          use_reentrant=False)
            else:
                x, m_new, kv = chunk(c, x, kv)
            new_m.append(tree_map(_stacked, *m_new)
                         if caches is not None else None)
            new_kv.append(kv)
        if caches is None:
            return x, None
        return x, {"stack": tree_map(_stacked, *new_m),
                   "shared": tree_map(_stacked, *new_kv)}

    def _vlm_layers(self, params, x, positions, caches, pos, memory=None):
        """The vlm family's chunks in order: each chunk's gated cross block
        over the patches' K/V (computed from ``memory`` in a full pass,
        read from ``caches["cross"]`` in decode), then its
        ``cross_attn_period`` dense self layers. ``caches`` None (no
        cache) or ``{"stack": [n_cross, period, ...] self caches, "cross":
        [n_cross, ...] K/V or None}`` (None in a prefill). Returns (x, new
        caches or None); the new ``cross`` holds each chunk's K/V."""
        cfg = self.cfg
        stack, cross = params["layers"]["stack"], params["layers"]["cross"]
        remat = _remat_active(cfg)

        def chunk(c, x, c_self, kv):
            p_cross = tree_map(lambda t: t[c], cross)
            if kv is None:
                kv = attn.cross_kv(p_cross["xattn"], memory)
            x = blk.cross_block(p_cross, x, kv, cfg, gated=True)
            new = []
            for i in range(cfg.cross_attn_period):
                c_i = (tree_map(lambda t: t[i], c_self)
                       if c_self is not None else None)
                x, nc, _ = blk.decoder_block(
                    tree_map(lambda t: t[c, i], stack), x, cfg, positions,
                    kind="dense", cache=c_i, pos=pos)
                new.append(nc)
            return x, new, kv

        new_self, new_kv = [], []
        for c in range(cfg.n_layers // cfg.cross_attn_period):
            c_self = kv = None
            if caches is not None:
                c_self = tree_map(lambda t: t[c], caches["stack"])
                if caches["cross"] is not None:
                    kv = tree_map(lambda t: t[c], caches["cross"])
            if remat:
                x, new, kv = checkpoint(chunk, c, x, c_self, kv,
                                        use_reentrant=False)
            else:
                x, new, kv = chunk(c, x, c_self, kv)
            if caches is not None:
                new_self.append(tree_map(_stacked, *new))
                new_kv.append(kv)
        if caches is None:
            return x, None
        return x, {"stack": tree_map(_stacked, *new_self),
                   "cross": (tree_map(_stacked, *new_kv)
                             if caches["cross"] is None else caches["cross"])}

    # ---------------------------------------------------- full-sequence pass
    def apply(self, params: Params, batch: dict, *, make_cache: bool = False,
              cache_len: Optional[int] = None):
        """batch: {'tokens': [B,S] int; vlm: 'patches' [B,P,d]}. Returns
        (logits [B,S,V], caches_or_None, aux_loss); with ``make_cache`` the
        K/V of the S tokens are written at 0 into caches of ``cache_len``
        (default S), the mamba layers hand over their final states and the
        vlm's cross blocks their K/V over the patches."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        pos = 0 if make_cache else None
        if self.cfg.family in MAMBA_FAMILIES:
            caches = None
            if make_cache:
                caches = {"stack": None}
                if self.cfg.family == "hybrid":
                    caches["shared"] = _zeros(self.cache_struct(
                        B, cache_len or S)["shared"], x.device)
            x, caches = self._mamba_layers(params, x, positions, caches, pos,
                                           decode=False)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            return self._head(params, x), caches, aux
        if self.cfg.family == "vlm":
            memory = batch["patches"].to(self.cdtype)
            caches = None
            if make_cache:
                caches = {"stack": _zeros(self.cache_struct(
                    B, cache_len or S)["stack"], x.device), "cross": None}
            x, caches = self._vlm_layers(params, x, positions, caches, pos,
                                         memory)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            return self._head(params, x), caches, aux
        caches = (self._attn_cache_zeros(B, cache_len or S, x.device)
                  if make_cache else None)
        x, caches, aux = self._layers(params, x, positions, caches, pos)
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
        """The cache tree as ``meta`` tensors (shapes and dtypes). dense /
        moe: ``{"first": [one] * first_dense_layers, "stack": [L, ...]
        one}``, ``one`` the MLA cache (``c``, ``k_pe``) when
        ``kv_lora_rank``, else the GQA cache (``k``, ``v``). ssm:
        ``{"stack": [L, ...]}`` of the mamba state (``conv`` in the compute
        dtype, ``h`` fp32). hybrid: ``{"stack": [n_chunks, attn_period,
        ...]}`` of it and ``"shared"``, the GQA cache ``[n_chunks, ...]``,
        one per application of the shared block. vlm: ``{"stack":
        [n_cross, cross_attn_period, ...]}`` of the GQA cache and
        ``"cross"``, each chunk's K/V over the ``n_patches`` patches
        ``[n_cross, B, n_patches, K, hd]``."""
        cfg = self.cfg

        def stacked(one, lead):
            return {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype,
                                   device="meta") for k, v in one.items()}

        if cfg.family == "ssm":
            return {"stack": stacked(ssm_mod.mamba2_cache_shape(
                cfg, batch, self.cdtype), (cfg.n_layers,))}
        if cfg.family == "hybrid":
            n_chunks = cfg.n_layers // cfg.attn_period
            return {"stack": stacked(
                        ssm_mod.mamba2_cache_shape(cfg, batch, self.cdtype),
                        (n_chunks, cfg.attn_period)),
                    "shared": stacked(attn.gqa_cache_shape(
                        cfg, batch, cache_len, self.cdtype), (n_chunks,))}
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_period
            kv = attn.gqa_cache_shape(cfg, batch, cfg.n_patches, self.cdtype)
            return {"stack": stacked(attn.gqa_cache_shape(
                        cfg, batch, cache_len, self.cdtype),
                        (n_cross, cfg.cross_attn_period)),
                    "cross": stacked(kv, (n_cross,))}
        shape = (attn.mla_cache_shape if cfg.kv_lora_rank
                 else attn.gqa_cache_shape)
        one = shape(cfg, batch, cache_len, self.cdtype)
        n = cfg.n_layers - cfg.first_dense_layers
        return {"first": [dict(one) for _ in range(cfg.first_dense_layers)],
                "stack": stacked(one, (n,))}

    def cache_axes(self) -> dict:
        """The logical axes of ``cache_struct``'s leaves, the reference's
        second return of ``cache_struct``: each layer's cache axes with a
        ``"layers"`` axis for every stacked axis in front."""
        cfg = self.cfg
        lead = lambda ax, n: {k: ("layers",) * n + v for k, v in ax.items()}
        if cfg.family == "ssm":
            return {"stack": lead(ssm_mod.mamba2_cache_axes(), 1)}
        if cfg.family == "hybrid":
            return {"stack": lead(ssm_mod.mamba2_cache_axes(), 2),
                    "shared": lead(attn.gqa_cache_axes(), 1)}
        if cfg.family == "vlm":
            kv = ("batch", "patches", "kv_heads", None)
            return {"stack": lead(attn.gqa_cache_axes(), 2),
                    "cross": lead({"k": kv, "v": kv}, 1)}
        one = (attn.mla_cache_axes() if cfg.kv_lora_rank
               else attn.gqa_cache_axes())
        return {"first": [dict(one) for _ in range(cfg.first_dense_layers)],
                "stack": lead(one, 1)}

    def _attn_cache_zeros(self, B: int, T: int, device) -> dict:
        return _zeros(self.cache_struct(B, T), device)

    # ----------------------------------------------------------- decode step
    def decode_step(self, params: Params, caches: Params,
                    tokens: torch.Tensor, pos):
        """tokens [B, 1]; pos the write index (an int or a 0-d tensor).
        Returns (logits [B,1,V], new caches); the caller's caches are not
        written (the vlm's cross K/V are handed on as they are)."""
        x = self._embed(params, tokens)
        pos = int(pos)
        positions = pos + torch.arange(1, device=x.device)
        if self.cfg.family in MAMBA_FAMILIES:
            x, new_caches = self._mamba_layers(params, x, positions, caches,
                                               pos, decode=True)
        elif self.cfg.family == "vlm":
            x, new_caches = self._vlm_layers(params, x, positions, caches,
                                             pos)
        else:
            x, new_caches, _ = self._layers(params, x, positions, caches, pos)
        return self._head(params, x), new_caches
