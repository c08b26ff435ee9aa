"""Plain torch versions of the ported kernels, the twins of
``repro.kernels.ref`` (fp32 math, same formulas) and, for top-k, of
``lax.top_k``. A wrapper given a CPU tensor computes through these; the
tests and ``chip_smoke.py`` hold the CUDA kernels against them."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def staleness_agg(updates: torch.Tensor, weights: torch.Tensor,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """updates [C, N], weights [K], rows [K] or None (then K == C) ->
    ``sum_k weights[k] * updates[rows[k]]`` as fp32 [N]."""
    u = updates if rows is None else updates.index_select(0, rows)
    w = weights.to(torch.float32)
    return (u.to(torch.float32) * w[:, None]).sum(0)


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys whose integer order is ``lax.top_k``'s total order on fp32:
    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN. Equal keys are equal
    bit patterns. ``csrc/topk.cu`` ranks by the same key."""
    b = scores.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def block_topk(scores: torch.Tensor, k: int, block: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block top-k of ``scores [M]``, M padded with -inf to a multiple of
    ``block``: ``(vals [G, k] fp32, idx [G, k] int64 global)``. In a block,
    larger keys first and equal keys in ascending index order (a stable
    descending sort), so no index repeats and an exhausted block yields its
    lowest untaken indices."""
    s = scores.to(torch.float32)
    pad = (-s.shape[0]) % block
    if pad:
        s = torch.cat([s, s.new_full((pad,), float("-inf"))])
    rows = s.reshape(-1, block)
    order = torch.sort(order_key(rows), dim=1, descending=True,
                       stable=True).indices[:, :k]
    base = torch.arange(0, s.shape[0], block, device=s.device)[:, None]
    return torch.gather(rows, 1, order), order + base


def masked_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores [M]`` with ``lax.top_k`` semantics:
    ``(vals [k] fp32, idx [k] int64)``, descending, ties to the lowest
    index (a stable descending sort of the whole vector)."""
    s = scores.to(torch.float32)
    idx = torch.sort(order_key(s), descending=True, stable=True).indices[:k]
    return s[idx], idx


def bias_corrections(t: int, b1: float, b2: float) -> tuple[float, float]:
    """``(1/(1-b1^t), 1/(1-b2^t))`` computed in fp32, as the reference's
    kernel wrapper does (``repro/kernels/fused_adam.py``)."""
    one, tf = np.float32(1.0), np.float32(t)
    bc1 = one / (one - np.float32(b1) ** tf)
    bc2 = one / (one - np.float32(b2) ** tf)
    return float(bc1), float(bc2)


def fused_adam(p, m, v, g, steps, s: int, *, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> None:
    """Adam step ``t = s + 1``, in place on the stacked [Kp, W] fp32
    ``p, m, v``; lanes with ``s >= steps[lane]`` are left untouched."""
    bc1, bc2 = bias_corrections(s + 1, b1, b2)
    active = (steps > s)[:, None]
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    p_new = p - lr * ((m_new * bc1) / (torch.sqrt(v_new * bc2) + eps))
    p.copy_(torch.where(active, p_new, p))
    m.copy_(torch.where(active, m_new, m))
    v.copy_(torch.where(active, v_new, v))
