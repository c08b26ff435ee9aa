"""Plain torch versions of the ported kernels, the twins of
``repro.kernels.ref`` (fp32 math, same formulas). A wrapper given a CPU
tensor computes through these; the tests and ``chip_smoke.py`` hold the
CUDA kernels against them."""
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
