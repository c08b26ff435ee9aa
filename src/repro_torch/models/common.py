"""Shared model primitives (twin of ``repro.models.common``): the
parameter factory and its initializers, and the classifier loss.

Parameters are plain dicts of tensors. The reference's factory also records
logical sharding axes per leaf; the port has no sharding yet, so it keeps
only the values. Values are drawn from a ``torch.Generator`` and differ from
the reference's ``jax.random`` draws: tests that compare the two packages
start the port from the reference's params (``models.convert``).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.kernels.ops import tree_leaves

Params = Any


class ParamFactory:
    """Accumulates a dict of initialized parameters, drawn in creation order
    from one generator."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32):
        self.generator = generator
        self.dtype = dtype
        self.params: dict = {}

    def param(self, name: str, shape: tuple[int, ...], init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        if name in self.params:
            raise ValueError(f"duplicate param {name}")
        value = _initialize(self.generator, shape, self.dtype, init, scale)
        self.params[name] = value
        return value


def _initialize(gen: torch.Generator, shape, dtype, init: str,
                scale: Optional[float]) -> torch.Tensor:
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if init == "normal":
        # fan-in scaled truncated normal, as the reference: fan_in = prod
        # of all but the last dim (conv HWIO)
        fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (
            shape[-1] if shape else 1)
        std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (x * std).to(dtype)
    raise ValueError(f"unknown init {init}")


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy, fp32. logits [..., V], integer labels [...]."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
