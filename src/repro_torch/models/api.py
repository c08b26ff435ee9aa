"""Model factory, the LM client adapter and the input specs (twin of
``repro.models.api``)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def build_model(cfg: ModelConfig):
    """``encdec`` configs get an ``EncDecLM``, ``paper-*`` configs the
    paper's model, every other family (``dense``, ``moe``, ``ssm``,
    ``hybrid``, ``vlm``) a ``DecoderLM``."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    if cfg.family.startswith("paper"):
        from repro_torch.models.paper_models import build_paper_model
        return build_paper_model(cfg.name)
    from repro_torch.models.lm import DecoderLM
    return DecoderLM(cfg)


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``cfg``'s params, from its smoke config's
    ``meta`` init, as the reference's ``launch.steps._param_axes`` takes
    them (the tree and each leaf's axes do not depend on the widths)."""
    from repro_torch.configs.base import get_config
    return build_model(get_config(cfg.name, smoke=True)).param_axes()


def _cdtype(cfg: ModelConfig):
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.compute_dtype]


class LMClientAdapter:
    """Adapts a DecoderLM to the FL client interface (loss/accuracy over
    {'x': tokens [B,S], 'y': targets [B,S]}, targets < 0 masked), so the
    Apodotiko controller can federate an LM
    (``examples/torch_train_fl_lm.py``). ``init`` returns the params alone,
    as the port's other client models do. As the reference's, it passes
    only the tokens: the ``vlm`` and ``encdec`` families need patches or
    frames, and their ``loss`` raises ``KeyError`` as the reference's
    does."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.lm = build_model(cfg)

    def init(self, generator=None, device=None):
        return self.lm.init(generator, device)

    def loss(self, params, batch):
        return self.lm.loss(params, {"tokens": batch["x"],
                                     "targets": batch["y"]})

    def accuracy(self, params, batch):
        """Token accuracy over the unmasked targets, fp32: the count of
        hits over the count of targets, as the reference divides them."""
        logits, _, _ = self.lm.apply(params, {"tokens": batch["x"]})
        pred = torch.argmax(logits, dim=-1)
        mask = batch["y"] >= 0
        hits = torch.sum((pred == batch["y"]) & mask)
        total = torch.clamp(torch.sum(mask), min=1)
        return hits.to(torch.float32) / total.to(torch.float32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    """(batch specs, logical axes) for the full-sequence entry points
    (train / prefill): each spec a ``(shape, dtype)`` tuple, each axes entry
    a tuple of names. Decode inputs come from the model's
    ``cache_struct``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    batch: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    if cfg.family == "encdec":
        batch["frames"] = ((B, S, cfg.d_model), _cdtype(cfg))
        axes["frames"] = ("batch", "seq", "d_model")
        batch["tokens"] = ((B, S), i32)
        axes["tokens"] = ("batch", "seq")
    else:
        batch["tokens"] = ((B, S), i32)
        axes["tokens"] = ("batch", "seq")
        if cfg.family == "vlm":
            batch["patches"] = ((B, cfg.n_patches, cfg.d_model), _cdtype(cfg))
            axes["patches"] = ("batch", "patches", "d_model")
    if shape.kind == "train":
        batch["targets"] = (batch["tokens"][0], i32)
        axes["targets"] = ("batch", "seq")
    return batch, axes
