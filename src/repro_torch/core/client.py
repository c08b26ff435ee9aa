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
The draw is one ``[Kp, max_steps, B]`` block a cohort, ``max_steps`` the
cohort's largest step budget, so the values and the generator's position
depend on it: both entries below draw with the same ``max_steps``.

Three entries share the step loop (``_train_lanes``), which runs with
TF32 off (``device.fp32_exact``) as the reference computes in fp32:

  * ``train_cohort_indexed``: the stepwise engine's on the device data
    plane, the cohort as host client ids into the resident
    ``DatasetStore``; trained models land in freshly allocated update-store
    rows (or come back stacked);
  * ``train_cohort``: the host data plane's (the reference's equivalence
    oracle): the cohort's ``X[selection]`` / ``y[selection]``, padded, is
    uploaded every dispatch (``data_h2d_bytes``) and trained by the same
    loop as lanes ``0..Kp-1`` of that transient buffer, so the draws and
    every product are ``train_cohort_indexed``'s and the two planes are
    bit-equal;
  * ``train_cohort_rows``: the fused-round megastep's (``core.megastep``,
    the counterpart of the reference's ``cohort_fn_indexed`` program), the
    cohort as device tensors and the rows already allocated.

With a mesh (``mesh=``, ``sharding.flmesh``) the cohort floor becomes
``lcm(floor, data)``, so every ``Kp`` splits evenly over the ``data``
axis, and data rank ``i`` trains lanes ``[i*Kp/data, (i+1)*Kp/data)``.
Every rank draws the whole ``[Kp, max_steps, B]`` index table and slices
its lanes' rows, so each generator advances as the 1x1 run's does and a
lane sees the indices it sees at 1x1 (the twin of the reference's
replicated lane-key table); the step loop runs to the cohort's largest
budget on every rank. The trained rows land in the store's owned tiles
(``update_store.land_lanes``), and the losses and SCAFFOLD's ``c_i'`` are
all-gathered over ``data``, so the host sees ``[K]`` on every rank.

Client-side modifications of the baselines: FedProx's proximal term, and
SCAFFOLD's control variates. Given variates (the runtime passes them when
its strategy needs them), every lane's raveled grads are corrected to
``(g - c_i) + c`` before the optimizer step, and the new variate is
``c_i' = c_i - c + (w0 - w) / (max(steps, 1) * lr)``; the variates are
flat ``[W]`` rows in ``RavelSpec`` order, pad lanes zero.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.update_store import _round_up, land_lanes
from repro_torch.device import fp32_exact, resolve_device
from repro_torch.kernels.ops import BLOCK_N, RavelSpec, tree_leaves
from repro_torch.optim import build_optimizer
from repro_torch.sharding import flmesh

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
                 prox_mu: float = 0.0, seed: int = 0,
                 cohort_floor: Optional[int] = None, device=None,
                 batch_indices: Optional[BatchIndices] = None, mesh=None):
        self.model = model
        self.opt = build_optimizer(optimizer, lr)
        self.lr = lr
        self.batch_size = batch_size
        self.prox_mu = prox_mu
        self.mesh = mesh
        self.device = mesh.device if mesh is not None and device is None \
            else resolve_device(device)
        floor = (DEFAULT_COHORT_FLOOR if cohort_floor is None
                 else int(cohort_floor))
        # every bucket must split evenly over the data axis: power-of-two
        # bucketing keeps multiples of the floor
        self.cohort_floor = math.lcm(floor, flmesh.mesh_axes(mesh)[0])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.batch_indices = batch_indices or self._draw_indices
        self._grad_fn = self._make_grad_fn()
        self.data_h2d_bytes = 0   # training-input bytes uploaded (host plane)

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

    def cohort_bucket(self, K: int) -> int:
        """The padded cohort size: the next power-of-two multiple of the
        cohort floor (2, or ``lcm(2, data)`` under a mesh)."""
        return _bucket(K, self.cohort_floor)

    def _train_lanes(self, global_params: Params, store, sel_t: torch.Tensor,
                     n_t: torch.Tensor, steps_t: torch.Tensor, max_steps: int,
                     W: int, c_global: Optional[torch.Tensor] = None,
                     c_lanes: Optional[torch.Tensor] = None):
        """The local-training loop of every entry: every lane (client
        ``sel_t`` [Kp] int64, ``n_t`` [Kp] int64 samples, ``steps_t`` [Kp]
        int32 budget, all on the device) trains from ``global_params`` for
        its budget, ``max_steps`` being the largest. With SCAFFOLD,
        ``c_global`` [W] and ``c_lanes`` [Kp, W] are the variates. Under a
        mesh only this data rank's lanes train. Returns ``(flat [L, W]
        trained rows, mean losses [L], c_i' [L, W] or None)`` for those L
        lanes (all Kp un-meshed), on the device."""
        dev = self.device
        bidx = self.batch_indices(sel_t.shape[0], max_steps, n_t)
        if self.mesh is not None:
            # the whole table is drawn, so the generator moves as at 1x1
            lanes = self._lanes(sel_t.shape[0])
            sel_t, n_t, steps_t, bidx = (sel_t[lanes], n_t[lanes],
                                         steps_t[lanes], bidx[lanes])
            if c_lanes is not None:
                c_lanes = c_lanes[lanes]
        Kp = sel_t.shape[0]
        spec = RavelSpec(global_params)
        row0 = torch.zeros(W, dtype=torch.float32, device=dev)
        row0[:spec.n_params] = spec.ravel(global_params)
        flat = row0.repeat(Kp, 1)
        grads = torch.zeros_like(flat)
        params, grad_views = spec.unravel_stacked(flat), spec.unravel_stacked(grads)
        opt_state = self.opt.cohort_init(flat, spec)
        sel_c = sel_t[:, None]
        losses = torch.zeros(Kp, dtype=torch.float32, device=dev)
        with fp32_exact():
            for s in range(max_steps):
                idx = bidx[:, s]
                g, loss = self._grad_fn(params, store.X[sel_c, idx],
                                        store.y[sel_c, idx], global_params)
                for view, leaf in zip(tree_leaves(grad_views),
                                      tree_leaves(g)):
                    view.copy_(leaf)
                if c_global is not None:
                    # (g - c_i) + c, the reference's order of roundings
                    grads.sub_(c_lanes).add_(c_global)
                self.opt.cohort_step(flat, opt_state, grads, steps_t, s)
                losses += torch.where(steps_t > s, loss, 0.0)
        mean_loss = losses / torch.clamp(steps_t, min=1)
        ci_new = None
        if c_global is not None:
            denom = torch.clamp(steps_t, min=1).to(torch.float32) * self.lr
            ci_new = (c_lanes - c_global) + (row0 - flat) / denom[:, None]
        return flat, mean_loss, ci_new

    def train_cohort_indexed(self, global_params: Params, store, selection,
                             n_i: np.ndarray, steps: np.ndarray,
                             c_global=None, c_clients=None, *,
                             update_sink=None):
        """Train the cohort ``selection`` (client indices into ``store``, a
        ``DatasetStore``) from ``global_params``. Pad lanes repeat the last
        client and run 0 steps (with SCAFFOLD, zero variates).

        With ``update_sink`` (an ``UpdateStore``) the trained models are
        written into freshly allocated rows and the first return value is
        the ``[K]`` row ids; without it, the ``[K, ...]``-stacked params.
        Returns ``(that, c_i' [K, W] or None, mean losses [K] numpy)``;
        ``c_global`` [W] and ``c_clients`` [K, W] are SCAFFOLD's variates."""
        sel = np.asarray(selection, np.int64)
        K = len(sel)
        Kp = self.cohort_bucket(K)
        if Kp != K:
            sel = np.concatenate([sel, np.repeat(sel[-1:], Kp - K)])
        return self._train_padded(global_params, store, sel, n_i, steps,
                                  c_global, c_clients, update_sink)

    def train_cohort(self, global_params: Params, X: np.ndarray,
                     y: np.ndarray, n_i: np.ndarray, steps: np.ndarray,
                     c_global=None, c_clients=None, *, update_sink=None):
        """Host data plane: the cohort's ``X [K, N_max, ...]`` / ``y [K,
        N_max]``, padded to ``Kp`` lanes by repeating the last client, is
        uploaded for this dispatch (counted in ``data_h2d_bytes``) and
        trained as lanes ``0..Kp-1`` of that transient buffer. Arguments
        and returns are ``train_cohort_indexed``'s, whose values these are
        to the bit."""
        X, y = np.asarray(X), np.asarray(y)
        K = X.shape[0]
        Kp = self.cohort_bucket(K)
        if Kp != K:
            X = np.concatenate([X, np.repeat(X[-1:], Kp - K, axis=0)])
            y = np.concatenate([y, np.repeat(y[-1:], Kp - K, axis=0)])
        self.data_h2d_bytes += X.nbytes + y.nbytes
        cohort = SimpleNamespace(X=torch.as_tensor(X).to(self.device),
                                 y=torch.as_tensor(y).to(self.device).long())
        return self._train_padded(global_params, cohort,
                                  np.arange(Kp, dtype=np.int64), n_i, steps,
                                  c_global, c_clients, update_sink)

    def _train_padded(self, global_params: Params, store, sel: np.ndarray,
                      n_i, steps, c_global, c_clients, update_sink):
        """Both host-side entries past their gather: ``sel`` [Kp] indexes
        ``store``'s ``X`` / ``y``; ``n_i`` and ``steps`` are the [K] real
        lanes', padded here (the last client's count, 0 steps)."""
        n_i = np.asarray(n_i, np.int64)
        steps = np.asarray(steps, np.int64)
        K, Kp = len(n_i), len(sel)
        if Kp != K:
            n_i = np.concatenate([n_i, np.repeat(n_i[-1:], Kp - K)])
            steps = np.concatenate([steps, np.zeros(Kp - K, steps.dtype)])
        dev = self.device
        W = (update_sink.row_width if update_sink is not None
             else _round_up(RavelSpec(global_params).n_params,
                            flmesh.row_align(self.mesh, BLOCK_N)))
        c_lanes = None
        if c_global is not None:
            c_lanes = torch.zeros((Kp, W), dtype=torch.float32, device=dev)
            c_lanes[:K] = c_clients
        flat, mean_loss, ci_new = self._train_lanes(
            global_params, store, torch.as_tensor(sel, device=dev),
            torch.as_tensor(n_i, device=dev),
            torch.as_tensor(steps.astype(np.int32), device=dev),
            int(steps.max()), W, c_global, c_lanes)
        if self.mesh is not None:
            # every rank's lanes, in lane order, on every rank
            mean_loss = flmesh.all_gather_data(mean_loss, self.mesh)
            if ci_new is not None:
                ci_new = flmesh.all_gather_data(ci_new, self.mesh)
        mean_loss = mean_loss.cpu().numpy()[:K]
        if ci_new is not None:
            ci_new = ci_new[:K]
        if update_sink is None:
            spec = RavelSpec(global_params)
            if self.mesh is not None:
                flat = flmesh.all_gather_data(flat, self.mesh)
            return spec.unravel_stacked(flat[:K]), ci_new, mean_loss
        # pad lanes ran 0 steps: their rows hold the global model and are
        # recycled right away, as the reference's flat-update path does
        ids = update_sink.alloc(Kp)
        land_lanes(update_sink.buffer, ids, flat, self.mesh)
        if Kp != K:
            update_sink.free(ids[K:])
        return ids[:K], ci_new, mean_loss

    def _lanes(self, Kp: int) -> slice:
        """This data rank's lanes of a ``Kp``-lane cohort."""
        share = Kp // self.mesh.data
        return slice(self.mesh.data_index * share,
                     (self.mesh.data_index + 1) * share)

    def train_cohort_rows(self, global_params: Params, store,
                          cidx: torch.Tensor, n_p: torch.Tensor,
                          steps_p: torch.Tensor, buffer: torch.Tensor,
                          row_ids: torch.Tensor) -> torch.Tensor:
        """The fused body's cohort step: the padded cohort as device
        tensors (``cidx`` [Kp] int64 clients, ``n_p`` [Kp] int64 samples,
        ``steps_p`` [Kp] int32 budgets, pad lanes at 0 steps) trains as
        ``train_cohort_indexed`` trains it, with the same ``batch_indices``
        draw (one host read of the step maximum), and its rows land in
        ``buffer`` at ``row_ids`` [Kp], allocated by the caller (under a
        mesh, ``buffer`` is this rank's tile, and the rows land as
        ``train_cohort_indexed`` lands them). Returns the mean losses [Kp]
        on the device."""
        W = buffer.shape[1] * flmesh.mesh_axes(self.mesh)[1]
        flat, mean_loss, _ = self._train_lanes(
            global_params, store, cidx, n_p, steps_p, int(steps_p.max()), W)
        land_lanes(buffer, row_ids, flat, self.mesh)
        if self.mesh is not None:
            mean_loss = flmesh.all_gather_data(mean_loss, self.mesh)
        return mean_loss
