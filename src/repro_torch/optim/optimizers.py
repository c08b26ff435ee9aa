"""Optimizers over dicts of tensors (twin of ``repro.optim.optimizers``):
SGD, plain Adam and the fused-kernel Adam.

Each optimizer has two forms:

  * the reference's pytree form, ``init(params)`` and
    ``update(grads, state, params) -> (updates, state)`` with the
    ``upd = p' - p`` contract, applied by ``apply_updates``;
  * a cohort form for the trainer, ``cohort_init(flat)`` and
    ``cohort_step(flat, state, g, steps, s)``, which steps the stacked
    ``[Kp, W]`` flat params of a whole cohort in place; lanes with
    ``s >= steps[lane]`` are left as they are (the reference's per-lane
    ``active`` select). The reference runs one Pallas Adam call per client
    inside its vmap; a custom CUDA op has no vmap rule, so here the cohort's
    grads are raveled into one ``[Kp, W]`` buffer and ONE kernel launch
    steps every lane.

``build_optimizer("adam")`` is the fused form: its kernel wrapper takes the
plain version for CPU tensors and launches the kernel for CUDA tensors.
Plain ``adam`` stays as the reference the tests compare against.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.kernels.fused_adam import VEC, fused_adam
from repro_torch.kernels.ops import RavelSpec, tree_leaves, tree_map

Params = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], Params]
    update: Callable[[Params, Params, Params], tuple[Params, Params]]
    name: str
    cohort_init: Callable[[torch.Tensor], dict]
    cohort_step: Callable[..., None]


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _active(steps: torch.Tensor, s: int) -> torch.Tensor:
    return (steps > s)[:, None]


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params):
        return tree_map(lambda g: -lr * g, grads), state

    def cohort_step(flat, state, g, steps, s):
        flat.copy_(torch.where(_active(steps, s), flat + (-lr * g), flat))

    return Optimizer(init, update, "sgd", lambda flat: {}, cohort_step)


def _moments(flat: torch.Tensor) -> dict:
    return {"m": torch.zeros_like(flat), "v": torch.zeros_like(flat)}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Plain Adam, the reference's formula: ``-lr * (m/bc1) / (sqrt(v/bc2)
    + eps)`` with ``bc = 1 - b^t``."""

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params), "t": 0}

    def _bc(t):
        tf = torch.tensor(float(t), dtype=torch.float32)
        return 1.0 - b1 ** tf, 1.0 - b2 ** tf

    def _step(m, v, g, bc1, bc2):
        m = b1 * m + (1 - b1) * g.to(torch.float32)
        v = b2 * v + (1 - b2) * torch.square(g.to(torch.float32))
        return m, v, -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)

    def update(grads, state, params):
        t = state["t"] + 1
        bc1, bc2 = _bc(t)
        out = tree_map(lambda m, v, g: _step(m, v, g, bc1, bc2),
                       state["m"], state["v"], grads)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(2), {"m": pick(0), "v": pick(1), "t": t}

    def cohort_step(flat, state, g, steps, s):
        bc1, bc2 = (b.to(flat.device) for b in _bc(s + 1))
        m, v, upd = _step(state["m"], state["v"], g, bc1, bc2)
        act = _active(steps, s)
        flat.copy_(torch.where(act, flat + upd, flat))
        state["m"].copy_(torch.where(act, m, state["m"]))
        state["v"].copy_(torch.where(act, v, state["v"]))

    return Optimizer(init, update, "adam", _moments, cohort_step)


def adam_fused(lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> Optimizer:
    """Adam through ``kernels.fused_adam``. The pytree form ravels params
    and grads (``RavelSpec`` order, bf16 cast to fp32 exactly) into one
    flat ``[1, n]`` fp32 row padded to the kernel's vector width (pad lanes
    carry zero grads, exact no-ops), steps a copy of the moments, and hands
    back the update ``p' - p`` in fp32, as the reference's ``adam_fused``;
    ``apply_updates`` casts it to each param's dtype.

    The rows are written leaf by leaf and the params row becomes the
    update in place, so a step holds the fp32 params, grads and two pairs
    of moments (the caller's and the new) and nothing else of full size:
    at Qwen3-1.7B's 1.72 B params, 6.9 GB each."""

    def _flat(spec, tree):
        n = spec.n_params
        leaves = tree_leaves(tree)
        out = torch.empty((1, n + (-n) % VEC), dtype=torch.float32,
                          device=leaves[0].device)
        out[0, n:] = 0.0
        for leaf, off, size in zip(leaves, spec.offsets, spec.sizes):
            out[0, off:off + size] = leaf.reshape(-1)
        return out

    def init(params):
        spec = RavelSpec(params)
        n = spec.n_params + (-spec.n_params) % VEC
        z = torch.zeros((1, n), dtype=torch.float32,
                        device=tree_leaves(params)[0].device)
        return {"m": z, "v": z.clone(), "t": 0}

    @torch.no_grad()
    def update(grads, state, params):
        spec = RavelSpec(grads)
        t = state["t"] + 1
        mo, vo = state["m"].clone(), state["v"].clone()
        g_flat = _flat(spec, grads)
        po = _flat(spec, params)
        steps = torch.full((1,), t, dtype=torch.int32, device=po.device)
        fused_adam(po, mo, vo, g_flat, steps, t - 1, lr=lr, b1=b1, b2=b2,
                   eps=eps)
        del g_flat
        # p' - p, each leaf's fp32 cast as the reference's p_flat
        for leaf, off, size in zip(tree_leaves(params), spec.offsets,
                                   spec.sizes):
            po[0, off:off + size] -= leaf.reshape(-1)
        upd = spec.unravel(po[0], restore_dtype=False)
        return upd, {"m": mo, "v": vo, "t": t}

    def cohort_step(flat, state, g, steps, s):
        fused_adam(flat, state["m"], state["v"], g, steps, s, lr=lr, b1=b1,
                   b2=b2, eps=eps)

    return Optimizer(init, update, "adam-fused", _moments, cohort_step)


def build_optimizer(name: str, lr: float) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "adam":
        return adam_fused(lr)
    if name in ("momentum", "adafactor"):
        raise NotImplementedError(
            f"optimizer {name!r} comes with a later slice of the port")
    raise ValueError(f"unknown optimizer {name}")
