"""Optimizers over dicts of tensors (twin of ``repro.optim.optimizers``):
SGD, momentum, plain Adam, the fused-kernel Adam and Adafactor.

Each optimizer has two forms:

  * the reference's pytree form, ``init(params)`` and
    ``update(grads, state, params) -> (updates, state)`` with the
    ``upd = p' - p`` contract, applied by ``apply_updates``;
  * a cohort form for the trainer, ``cohort_init(flat, spec)`` and
    ``cohort_step(flat, state, g, steps, s)``, which steps the stacked
    ``[Kp, W]`` flat params of a whole cohort in place; lanes with
    ``s >= steps[lane]`` are left as they are (the reference's per-lane
    ``active`` select). The reference runs one Pallas Adam call per client
    inside its vmap; a custom CUDA op has no vmap rule, so here the cohort's
    grads are raveled into one ``[Kp, W]`` buffer and ONE kernel launch
    steps every lane.

Adafactor works leaf by leaf, so its cohort form reads each leaf's lanes
through views of the rows at ``spec``'s (the params' ``RavelSpec``)
offsets and shapes; the elementwise optimizers ignore ``spec``.

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
    cohort_init: Callable[..., Any]
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

    return Optimizer(init, update, "sgd", lambda flat, spec=None: {},
                     cohort_step)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    """Heavy-ball momentum, the reference's formula: an fp32 first moment
    ``m = beta * m + g`` and the update ``-lr * m``. Plain torch: the
    reference computes it outside any Pallas kernel."""

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)}

    def update(grads, state, params):
        m = tree_map(lambda m_, g: beta * m_ + g.to(torch.float32),
                     state["m"], grads)
        return tree_map(lambda m_: -lr * m_, m), {"m": m}

    def cohort_init(flat, spec=None):
        return {"m": torch.zeros_like(flat)}

    def cohort_step(flat, state, g, steps, s):
        act = _active(steps, s)
        m = beta * state["m"] + g
        flat.copy_(torch.where(act, flat + (-lr * m), flat))
        state["m"].copy_(torch.where(act, m, state["m"]))

    return Optimizer(init, update, "momentum", cohort_init, cohort_step)


def _moments(flat: torch.Tensor, spec=None) -> dict:
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


def _leaf_mean(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Mean over every axis of ``x`` past its first ``lead`` (the lanes),
    kept as size-1 axes; a leaf of no axes is its own mean."""
    dims = tuple(range(lead, x.ndim))
    return torch.mean(x, dim=dims, keepdim=True) if dims else x


def adafactor(lr: float = 1e-2, eps: float = 1e-30,
              clip: float = 1.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern), the reference's formula:
    a leaf of rank >= 2 keeps row and column means of ``g^2 + eps`` over
    its last two axes (O(n + m) state, no first moment), a smaller leaf
    the full second moment; ``beta = 1 - (t + 1)^-0.8``; the update
    ``g * rsqrt(max(vhat, eps))`` is clipped to RMS <= ``clip`` per leaf.
    The pytree form hands back the update ``-lr * upd`` in fp32, as the
    reference does; the cohort form steps each lane's leaf views."""

    def _beta(t) -> torch.Tensor:
        return 1.0 - (torch.tensor(float(t), dtype=torch.float32) + 1.0) \
            ** -0.8

    def _one(g, s, beta, lead):
        """One leaf's step; ``lead`` leading lane axes (0 or 1). Returns
        (update, new state)."""
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps
        if g.ndim - lead >= 2:
            row = beta * s["row"] + (1 - beta) * torch.mean(g2, dim=-1)
            col = beta * s["col"] + (1 - beta) * torch.mean(g2, dim=-2)
            row_mean = torch.mean(row, dim=-1, keepdim=True)
            r = (row / torch.clamp(row_mean, min=eps))[..., None]
            vhat = r * col[..., None, :]
            upd = g * torch.rsqrt(torch.clamp(vhat, min=eps))
            new_s = {"row": row, "col": col}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            upd = g * torch.rsqrt(torch.clamp(v, min=eps))
            new_s = {"v": v}
        # update clipping (RMS <= clip)
        rms = torch.sqrt(_leaf_mean(torch.square(upd), lead) + 1e-12)
        upd = upd / torch.clamp(rms / clip, min=1.0)
        return -lr * upd, new_s

    def _zeros(shape, device, lead=()):
        f32 = torch.float32
        if len(shape) >= 2:
            return {"row": torch.zeros(lead + shape[:-1], dtype=f32,
                                       device=device),
                    "col": torch.zeros(lead + shape[:-2] + shape[-1:],
                                       dtype=f32, device=device)}
        return {"v": torch.zeros(lead + shape, dtype=f32, device=device)}

    def init(params):
        return {"s": tree_map(lambda p: _zeros(tuple(p.shape), p.device),
                              params), "t": 0}

    @torch.no_grad()
    def update(grads, state, params):
        t = state["t"] + 1
        beta = _beta(t).to(tree_leaves(grads)[0].device)
        out = tree_map(lambda g, s: _one(g, s, beta, 0), grads, state["s"])
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), {"s": pick(1), "t": t}

    def cohort_init(flat, spec):
        Kp = flat.shape[0]
        return {"spec": spec,
                "s": [_zeros(shape, flat.device, (Kp,))
                      for shape in spec.shapes]}

    def cohort_step(flat, state, g, steps, s):
        spec = state["spec"]
        beta = _beta(s + 1).to(flat.device)
        act = _active(steps, s)
        for i, (shape, off, n) in enumerate(zip(spec.shapes, spec.offsets,
                                                spec.sizes)):
            lane_shape = (flat.shape[0],) + shape
            p = flat[:, off:off + n]
            upd, new_s = _one(g[:, off:off + n].reshape(lane_shape),
                              state["s"][i], beta, 1)
            p.copy_(torch.where(act, p + upd.reshape(p.shape), p))
            for k, v in new_s.items():
                keep = act.reshape((-1,) + (1,) * (v.ndim - 1))
                state["s"][i][k] = torch.where(keep, v, state["s"][i][k])

    return Optimizer(init, update, "adafactor", cohort_init, cohort_step)


def build_optimizer(name: str, lr: float) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "adam":
        return adam_fused(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(f"unknown optimizer {name}")
