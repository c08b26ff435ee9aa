"""The yardstick's arithmetic: one H100's published peaks, the model FLOPs a
sample, and the bytes of the optimizer and aggregation layers.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
configuration's plain reference on the ``meta`` device, one sample at a
time: products only (convolutions and matrix products), as a model's FLOPs
are conventionally counted. A trained sample is its forward and backward
passes with the parameters' gradients and no gradient of the input image.

Bytes are counted from each layer's meaning, not from the kernel that
implements it, so a share reads the same work whatever runs it:

  * optimizer (Adam): every active lane-step reads p, g, m and v and writes
    p, m and v: 7 x 4 B over the row width;
  * aggregation: the weighted rows read once and the result written once,
    4 B each over the row width.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

#: NVIDIA H100 SXM data sheet, dense, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def _meta_params(leaves: dict, grad: bool) -> dict:
    return {k: torch.empty(shape, device="meta", requires_grad=grad)
            for k, (shape, _) in leaves.items()}


def flops_per_sample(model_ref, input_shape) -> tuple[int, int]:
    """``(forward, trained)`` FLOPs of one sample through ``model_ref``
    (a configuration's plain reference: ``LEAVES`` and ``forward``)."""
    x = torch.empty((1,) + tuple(input_shape), device="meta")
    with FlopCounterMode(display=False) as fwd:
        model_ref.forward(_meta_params(model_ref.LEAVES, False), x)
    params = _meta_params(model_ref.LEAVES, True)
    with FlopCounterMode(display=False) as train:
        logits = model_ref.forward(params, x)
        torch.autograd.grad(logits.sum(), list(params.values()))
    return fwd.get_total_flops(), train.get_total_flops()


def adam_bytes(lane_steps: int, width: int) -> int:
    """Bytes of ``lane_steps`` active lane-steps of Adam over rows of
    ``width`` fp32 values."""
    return 7 * 4 * int(lane_steps) * int(width)


def aggregation_bytes(rows: int, width: int) -> int:
    """Bytes of one weighted sum of ``rows`` rows of ``width`` fp32 values."""
    return 4 * (int(rows) + 1) * int(width)


def bound_s(nbytes: float = 0.0, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM bandwidth and the FLOPs over the fp32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
