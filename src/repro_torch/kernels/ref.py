"""Plain torch versions of the ported kernels, the twins of
``repro.kernels.ref`` (fp32 math, same formulas), for top-k of
``lax.top_k`` and for the int8 scale of the reference's entry point
``repro.kernels.ops.quantize_q8``. A wrapper given a CPU tensor computes
through these; the tests and ``chip_smoke.py`` hold the CUDA kernels
against them."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


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


def chosen_mask(idx: torch.Tensor, valid: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Scatter a top-k result back to an ``[n]`` bool membership mask
    (invalid slots, the -inf scores that filled the k, stay False)."""
    mask = torch.zeros(n, dtype=torch.bool, device=idx.device)
    mask[idx] = valid
    return mask


def fp32(x) -> float:
    """``x`` rounded to fp32, as a Python float (exact in fp32)."""
    return float(np.float32(x))


def scored_topk(num, den, booster, eligible, ever, beta, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Algorithm-3 top-k selection step, composed as the reference's
    ``ops.scored_topk``: score ``booster * (num / clamp_min(den, 1e-12))``
    (NaN kept), +inf where never invoked, then -inf where ineligible;
    ``masked_topk``; ``valid = vals > -inf``; new booster 1 where chosen,
    ``booster * beta`` where eligible, else ``booster``. All fp32. Returns
    ``(idx [k], valid [k], new_booster [M])``."""
    score = booster * (num / torch.clamp_min(den, 1e-12))
    score = torch.where(ever, score, float("inf"))
    score = torch.where(eligible, score, float("-inf"))
    vals, idx = masked_topk(score, k)
    valid = vals > float("-inf")
    chosen = chosen_mask(idx, valid, score.shape[0])
    boost = torch.where(chosen, 1.0,
                        torch.where(eligible, booster * fp32(beta), booster))
    return idx, valid, boost


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


QBLOCK = 256                          # elements per int8 scale
INV_127 = float(np.float32(1.0) / np.float32(127.0))
NEG_INF = -2.0 ** 30                  # the attention mask value


def quantize_q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N] -> (int8 codes [N], fp32 scales [ceil(N/256)]), per block of
    256: ``scale = max(maxabs * float32(1/127), 1e-12)`` and ``q =
    clip(round_half_even(x / scale), -127, 127)``; the tail block is
    zero-padded. The scale is the reference entry point's
    (``ops.quantize_q8``), where XLA folds ``/ 127`` into a multiply by the
    fp32 reciprocal; ``repro.kernels.ref.quantize_q8`` divides, and the
    two disagree by one ulp in 2-3 % of blocks. ``x / scale`` is a true
    division, as in both. A block holding a NaN or an inf gets a NaN or inf
    scale and all-zero codes, as the reference's do."""
    N = x.shape[0]
    xb = F.pad(x.to(torch.float32), (0, (-N) % QBLOCK)).reshape(-1, QBLOCK)
    scale = (xb.abs().amax(dim=1) * INV_127).clamp_min(1e-12)
    q = torch.round(xb / scale[:, None]).clamp(-127, 127)
    q = torch.where(torch.isfinite(scale)[:, None], q, 0.0)
    return q.to(torch.int8).reshape(-1)[:N], scale


def dequantize_q8(q: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 codes [N] and fp32 scales [<= ceil(N/256)] -> ``q * scale``
    in fp32, cast to ``dtype``; a block past the last scale takes 1.0, as
    the reference's padding does."""
    N = q.shape[0]
    nb = -(-N // QBLOCK)
    s = F.pad(scales.to(torch.float32), (0, nb - scales.shape[0]), value=1.0)
    qb = F.pad(q, (0, nb * QBLOCK - N)).reshape(nb, QBLOCK)
    return (qb.to(torch.float32) * s[:, None]).reshape(-1)[:N].to(dtype)


def compress_q8(flat: torch.Tensor, ef: Optional[torch.Tensor], n_pad: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 compression step with error feedback, composed stepwise as
    the reference's ``ops.compress_update`` composes it: ``v = flat + ef``,
    zero-pad to ``n_pad``, ``quantize_q8``, ``dequantize_q8``, trim to N,
    ``err = v - dequantized`` (a product and a difference, each rounded to
    fp32). Returns ``(q [n_pad], scales [n_pad / 256], err [N])``."""
    N = flat.shape[0]
    v = flat.to(torch.float32) if ef is None else flat + ef
    q, s = quantize_q8(F.pad(v, (0, n_pad - N)))
    return q, s, v - dequantize_q8(q, s)[:N]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale=None) -> torch.Tensor:
    """q [B,H,S,D], k/v [B,H,T,D] -> [B,H,S,D] in q's dtype: the whole
    score matrix in fp32, masked with -2^30 where ``s < t`` (causal), a
    softmax and the weighted sum of v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                     k.to(torch.float32)) * sm_scale
    if causal:
        S, T = s.shape[-2:]
        keep = (torch.arange(S, device=s.device)[:, None]
                >= torch.arange(T, device=s.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        v.to(torch.float32)).to(q.dtype)
