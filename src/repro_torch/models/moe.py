"""Mixture-of-Experts layer with sort-based (dropping) token dispatch (twin
of ``repro.models.moe``).

Tokens are routed top-k, assignments are sorted by expert id, each takes
the next position in its expert from the exclusive cumsum of the expert
counts, and assignments past ``capacity`` are dropped. The expert GEMMs
run as batched products ``[E, C, D] x [E, D, F]``, as the reference's.

The reference computes all of it outside any Pallas kernel, so this is
plain torch. Where values could part from the reference's:

  * routing: ``lax.top_k`` breaks ties by the lowest index and
    ``torch.topk`` promises no order, so the top K come from a stable
    descending sort of the probabilities;
  * dispatch: ``jnp.argsort`` is stable, and so is the sort here; only the
    drop bin ``E*C`` takes colliding writes, and it is sliced off;
  * every scatter is out of place, so the layer runs under
    ``torch.func.vmap(grad_and_value)`` (the cohort trainer);
  * the combine: the reference's scatter-add of each token's K
    contributions runs in sorted-assignment order (ascending expert id). A
    scatter-add on the card is atomic, so its order and its bf16 bits
    would change from run to run; here each token gathers its K
    contributions in that order and sums them one after another, which is
    deterministic and rounds as the reference's scatter-add does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamFactory


def init_moe(pf: ParamFactory, cfg: ModelConfig) -> None:
    d, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    pf.param("router", (d, E), scale=0.02)
    pf.param("w_gate", (E, d, Fe))
    pf.param("w_up", (E, d, Fe))
    pf.param("w_down", (E, Fe, d))
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        pf.param("ws_gate", (d, Fs))
        pf.param("ws_up", (d, Fs))
        pf.param("ws_down", (Fs, d))


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (cap + 7) // 8 * 8)


def route(p: dict, xf: torch.Tensor, cfg: ModelConfig):
    """Router over ``xf`` [T, D] in fp32. Returns (probs [T, E], top_w
    [T, K] normalized, top_e [T, K] int64), the top K in descending order,
    ties to the lowest expert id (``lax.top_k``'s order)."""
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_e


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def dispatch(top_e: torch.Tensor, C: int, E: int) -> dict:
    """The sort-based dispatch of ``top_e`` [T, K] into ``E`` experts of
    ``C`` slots: ``order`` (the stable argsort of the flat assignments),
    ``src_token``, ``keep``, ``slot`` (``E*C`` for a dropped one) and
    ``slot_token`` / ``slot_valid`` [E*C], the reference's values."""
    T, K = top_e.shape
    flat_e = top_e.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    src_token = order // K
    counts = _one_hot(flat_e, E, torch.int64).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=top_e.device) - starts[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    # the drop bin E*C takes every dropped write and is sliced off
    slot_token = torch.zeros(E * C + 1, dtype=torch.int64,
                             device=top_e.device).scatter(0, slot, src_token)
    slot_valid = torch.zeros(E * C + 1, dtype=torch.bool,
                             device=top_e.device).scatter(0, slot, keep)
    return {"order": order, "src_token": src_token, "keep": keep,
            "slot": slot, "slot_token": slot_token[:-1],
            "slot_valid": slot_valid[:-1]}


def combine(out_flat: torch.Tensor, top_w: torch.Tensor, d: dict
            ) -> torch.Tensor:
    """The experts' outputs ``out_flat`` [E*C, D] back to the tokens: each
    token's K contributions, weighted by ``top_w`` [T, K] (a dropped one
    by 0), gathered in sorted-assignment order (ascending expert id) and
    summed one after another in ``out_flat``'s dtype, the order and the
    roundings of the reference's scatter-add. Returns [T, D]."""
    T, K = top_w.shape
    EC = out_flat.shape[0]
    w = (top_w.reshape(T * K)[d["order"]] * d["keep"]).to(out_flat.dtype)
    contrib = out_flat[torch.clamp(d["slot"], 0, EC - 1)] * w[:, None]
    rank = torch.argsort(d["order"])          # sorted position of each
    parts = contrib[torch.sort(rank.reshape(T, K), dim=1).values]
    y = parts[:, 0]
    for k in range(1, K):
        y = y + parts[:, k]
    return y


def _shared(p: dict, xf: torch.Tensor) -> torch.Tensor:
    dt = xf.dtype
    hs = F.silu(xf @ p["ws_gate"].to(dt)) * (xf @ p["ws_up"].to(dt))
    return hs @ p["ws_down"].to(dt)


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, S, D]. Returns (y, aux_loss)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(T, cfg)
    xf = x.reshape(T, D)

    # -- routing (fp32) and the load-balancing auxiliary loss (Switch-style)
    probs, top_w, top_e = route(p, xf, cfg)
    frac_tokens = _one_hot(top_e, E, torch.float32).sum(1).mean(0)
    frac_probs = probs.mean(0)
    aux = cfg.router_aux_coef * E * torch.sum(frac_tokens * frac_probs)

    # -- sort-based dispatch
    d = dispatch(top_e, C, E)
    gathered = xf[d["slot_token"]] * d["slot_valid"][:, None].to(x.dtype)
    ge = gathered.reshape(E, C, D)

    # -- expert GEMMs
    h = F.silu(torch.einsum("ecd,edf->ecf", ge, p["w_gate"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", ge, p["w_up"].to(x.dtype))
    oe = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(x.dtype))

    # -- combine
    y = combine(oe.reshape(E * C, D), top_w, d)

    # -- shared experts (always-on dense path)
    if cfg.n_shared_experts:
        y = y + _shared(p, xf)
    return y.reshape(B, S, D), aux


def moe_reference(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """O(E x T) masked-dense reference: every expert sees every token; the
    top-k weights select. No capacity drops: compare with high capacity."""
    B, S, D = x.shape
    E = cfg.n_experts
    xf = x.reshape(B * S, D)
    _, top_w, top_e = route(p, xf, cfg)
    w_te = torch.zeros((xf.shape[0], E), dtype=torch.float32,
                       device=x.device).scatter_add(1, top_e, top_w)
    h = F.silu(torch.einsum("td,edf->tef", xf, p["w_gate"].to(x.dtype)))
    h = h * torch.einsum("td,edf->tef", xf, p["w_up"].to(x.dtype))
    oe = torch.einsum("tef,efd->ted", h, p["w_down"].to(x.dtype))
    y = torch.einsum("ted,te->td", oe.to(torch.float32), w_te).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + _shared(p, xf)
    return y.reshape(B, S, D)
