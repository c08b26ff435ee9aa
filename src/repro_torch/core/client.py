"""Client_Update (paper Algorithm 1, lines 14-23): real local training,
cohort-vectorized (twin of ``repro.core.client``).

Every client invoked at the same simulated instant trains in one batched
computation: the cohort's models are the rows of one stacked ``[Kp, W]``
fp32 tensor (``RavelSpec`` order), with per-leaf views for the forward
pass. Each local step

  1. gathers every lane's minibatch out of the resident ``DatasetStore``,
  2. takes per-lane loss and grads with ``torch.func.vmap(grad_and_value)``
     over the model's plain ``loss(params, batch)``,
  3. ravels the grads into a ``[Kp, W]`` buffer, and
  4. steps every lane with ONE optimizer call on the stacked buffers (for
     Adam, one launch of the fused kernel), in place, so the views already
     hold the new models.

Lanes whose step budget is spent are left untouched (the reference's
``active`` select); the loop ends when no lane is active, where the
reference runs on to its power-of-two step bucket with every lane masked —
the values are the same. The cohort pads to a power-of-two bucket (floor 2)
as in the reference, so the update store's row ids and free-list order
match the reference's.

Minibatch indices come from the trainer's ``torch.Generator``, or from the
``batch_indices(Kp, max_steps, n_i) -> int64 [Kp, max_steps, B]`` hook,
which the parity tests use to replay the reference's ``jax.random`` draws.

FedProx's proximal term is supported; SCAFFOLD comes with a later slice.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.update_store import _round_up, scatter_rows
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import BLOCK_N, RavelSpec, tree_leaves
from repro_torch.optim import build_optimizer

Params = Any
BatchIndices = Callable[[int, int, torch.Tensor], torch.Tensor]

DEFAULT_COHORT_FLOOR = 2


def _l2_sq(a: Params, b: Params) -> torch.Tensor:
    return sum(torch.sum(torch.square(x - y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _bucket(x: int, floor: int) -> int:
    """Round up to the next power-of-two multiple of ``floor``."""
    b = max(int(floor), 1)
    while b < x:
        b *= 2
    return b


class CohortTrainer:
    """Vectorized local training over a cohort sharing one model/optimizer."""

    def __init__(self, model, *, optimizer: str, lr: float, batch_size: int,
                 prox_mu: float = 0.0, scaffold: bool = False, seed: int = 0,
                 cohort_floor: Optional[int] = None, device=None,
                 batch_indices: Optional[BatchIndices] = None):
        if scaffold:
            raise NotImplementedError(
                "SCAFFOLD comes with a later slice of the port")
        self.model = model
        self.opt = build_optimizer(optimizer, lr)
        self.lr = lr
        self.batch_size = batch_size
        self.prox_mu = prox_mu
        self.device = resolve_device(device)
        self.cohort_floor = (DEFAULT_COHORT_FLOOR if cohort_floor is None
                             else int(cohort_floor))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.batch_indices = batch_indices or self._draw_indices
        self._grad_fn = self._make_grad_fn()

    def _make_grad_fn(self):
        model, mu = self.model, self.prox_mu

        def lane_loss(params, x, y, params0):
            loss, _ = model.loss(params, {"x": x, "y": y})
            if mu > 0:
                loss = loss + 0.5 * mu * _l2_sq(params, params0)
            return loss

        return torch.func.vmap(torch.func.grad_and_value(lane_loss),
                               in_dims=(0, 0, 0, None))

    def _draw_indices(self, Kp: int, max_steps: int,
                      n_i: torch.Tensor) -> torch.Tensor:
        """Uniform minibatch indices in [0, max(n_i, 1)) per lane."""
        n = torch.clamp(n_i, min=1)[:, None, None]
        u = torch.rand((Kp, max_steps, self.batch_size),
                       generator=self.generator, device=self.device)
        return torch.minimum((u * n).long(), n - 1)

    def train_cohort_indexed(self, global_params: Params, store, selection,
                             n_i: np.ndarray, steps: np.ndarray,
                             c_global=None, c_clients=None, *,
                             update_sink=None):
        """Train the cohort ``selection`` (client indices into ``store``, a
        ``DatasetStore``) from ``global_params``. Pad lanes repeat the last
        client and run 0 steps.

        With ``update_sink`` (an ``UpdateStore``) the trained models are
        written into freshly allocated rows and the first return value is
        the ``[K]`` row ids; without it, the ``[K, ...]``-stacked params.
        Returns ``(that, None, mean losses [K] numpy)``."""
        if c_global is not None or c_clients is not None:
            raise NotImplementedError(
                "SCAFFOLD control variates come with a later slice of the port")
        sel = np.asarray(selection, np.int64)
        n_i = np.asarray(n_i, np.int64)
        steps = np.asarray(steps, np.int64)
        K = len(sel)
        Kp = _bucket(K, self.cohort_floor)
        if Kp != K:
            sel = np.concatenate([sel, np.repeat(sel[-1:], Kp - K)])
            n_i = np.concatenate([n_i, np.repeat(n_i[-1:], Kp - K)])
            steps = np.concatenate([steps, np.zeros(Kp - K, steps.dtype)])
        dev = self.device
        spec = RavelSpec(global_params)
        W = (update_sink.row_width if update_sink is not None
             else _round_up(spec.n_params, BLOCK_N))
        flat = torch.zeros((Kp, W), dtype=torch.float32, device=dev)
        flat[:, :spec.n_params] = spec.ravel(global_params)
        grads = torch.zeros_like(flat)
        params, grad_views = spec.unravel_stacked(flat), spec.unravel_stacked(grads)
        opt_state = self.opt.cohort_init(flat)
        sel_t = torch.as_tensor(sel, device=dev)[:, None]
        steps_t = torch.as_tensor(steps.astype(np.int32), device=dev)
        n_t = torch.as_tensor(n_i, device=dev)
        max_steps = int(steps.max())
        bidx = self.batch_indices(Kp, max_steps, n_t)
        losses = torch.zeros(Kp, dtype=torch.float32, device=dev)
        for s in range(max_steps):
            idx = bidx[:, s]
            g, loss = self._grad_fn(params, store.X[sel_t, idx],
                                    store.y[sel_t, idx], global_params)
            for view, leaf in zip(tree_leaves(grad_views), tree_leaves(g)):
                view.copy_(leaf)
            self.opt.cohort_step(flat, opt_state, grads, steps_t, s)
            losses += torch.where(steps_t > s, loss, 0.0)
        mean_loss = (losses / torch.clamp(steps_t, min=1)).cpu().numpy()[:K]
        if update_sink is None:
            return spec.unravel_stacked(flat[:K]), None, mean_loss
        # pad lanes ran 0 steps: their rows hold the global model and are
        # recycled right away, as the reference's flat-update path does
        ids = update_sink.alloc(Kp)
        scatter_rows(update_sink.buffer, ids, flat)
        if Kp != K:
            update_sink.free(ids[K:])
        return ids[:K], None, mean_loss
