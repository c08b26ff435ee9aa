"""Model factory, the LM client adapter and the input specs (twin of
``repro.models.api``)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import FAMILIES, FAMILY_SLICE


def build_model(cfg: ModelConfig):
    """``paper-*`` configs get the paper's model, ``dense`` and ``moe`` a
    ``DecoderLM``; the other families come with later slices and raise."""
    if cfg.family.startswith("paper"):
        from repro_torch.models.paper_models import build_paper_model
        return build_paper_model(cfg.name)
    if cfg.family in FAMILIES:
        from repro_torch.models.lm import DecoderLM
        return DecoderLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) comes with a later slice "
        f"of the port ({FAMILY_SLICE.get(cfg.family, 'not planned')})")


def _cdtype(cfg: ModelConfig):
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.compute_dtype]


class LMClientAdapter:
    """Adapts a DecoderLM to the FL client interface (loss/accuracy over
    {'x': tokens [B,S], 'y': targets [B,S]}, targets < 0 masked), so the
    Apodotiko controller can federate an LM
    (``examples/torch_train_fl_lm.py``). ``init`` returns the params alone,
    as the port's other client models do."""

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
