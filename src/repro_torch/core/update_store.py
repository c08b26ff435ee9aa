"""Device-resident update plane (twin of ``repro.core.update_store``).

Every un-aggregated client update is a row of one ``[capacity, W]`` fp32
buffer on the card. The cohort trainer writes trained models into freshly
allocated rows, ``core.aggregation.weighted_aggregate_rows`` reduces them
by row id, and aggregated, pruned or failed rows go back to a LIFO
free-list. Freeing does no device work: stale rows enter a full-buffer
sweep at weight 0, and the aggregation layer's finiteness guard covers the
one case where that is not exact (NaN/Inf left by a diverged client).

Geometry as in the reference: ``W`` is ``n_params`` rounded up to 1024 and
``capacity`` a multiple of 8; the buffer doubles when the free-list runs
dry, and the free-list order (and so every row id) matches the reference's
for the same sequence of calls. ``free_stack`` hands that order to the
fused-round megastep (``core.megastep``), which replays the LIFO pops and
pushes on the card. Checkpoints and durable snapshots save only the live
rows and write them back at their original ids (``write_at``), so record
handles stay valid bit-exactly after a resume.

The stacked helpers ``gather_stacked`` / ``scatter_stacked_tree`` /
``grow_stacked`` are the reference's persistent-buffer contract (SCAFFOLD's
control variates, ``core.services``). The reference keeps such a buffer as
a pytree of ``[M, ...]`` leaves; the port keeps it as ONE flat
``[M, W]`` fp32 tensor in ``RavelSpec`` order, the layout of the update
rows (``RavelSpec.unravel_stacked`` gives per-leaf views), so the helpers
act on rows.

With a mesh (``UpdateStore(mesh=)``, ``sharding.flmesh``) each rank holds
only its ``[capacity/data, W/model]`` tile of the buffer: row ``r`` lives
on data rank ``r % data`` at local row ``r // data`` (cyclic, so a
capacity doubling appends local rows and moves none), and its columns are
cut into ``model`` stripes. Row ids, the free-list and the live set are
global and equal on every rank, so ``alloc`` and ``put`` return the
reference's ids; writes land only in the rows and stripe this rank owns;
``gather`` assembles whole rows on every rank through the mesh's
collectives. W aligns to ``row_align(mesh, BLOCK_N)`` and capacity to
``capacity_align(mesh, SUBLANE)``, the 1x1 values un-meshed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import BLOCK_N, SUBLANE
from repro_torch.sharding import flmesh


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gather_stacked(buffer: torch.Tensor, idx) -> torch.Tensor:
    """``[M, W] -> [K, W]``: the rows ``idx`` of a stacked buffer (a copy)."""
    return buffer[torch.as_tensor(idx, dtype=torch.int64,
                                  device=buffer.device)]


def scatter_stacked_tree(buffer: torch.Tensor, idx,
                         values: torch.Tensor) -> torch.Tensor:
    """Write ``[K, W]`` rows into a ``[M, W]`` stacked buffer at ``idx``, in
    place (the write half of ``gather_stacked``); returns the buffer."""
    buffer[torch.as_tensor(idx, dtype=torch.int64,
                           device=buffer.device)] = values.to(buffer.dtype)
    return buffer


def grow_stacked(buffer: torch.Tensor, old_rows: int,
                 new_rows: int) -> torch.Tensor:
    """Extend a ``[old_rows, W]`` stacked buffer with zero rows to
    ``[new_rows, W]`` (persistent-buffer growth on client join)."""
    if new_rows <= old_rows:
        return buffer
    return torch.cat([buffer, buffer.new_zeros(
        (new_rows - old_rows,) + tuple(buffer.shape[1:]))])


def scatter_rows(buffer: torch.Tensor, ids, rows: torch.Tensor) -> None:
    """Write ``[K, n<=W]`` rows into ``buffer`` at ``ids`` (host ids or an
    int64 tensor) in place, the tail pad lanes zeroed."""
    idx = torch.as_tensor(ids, dtype=torch.int64, device=buffer.device)
    n = rows.shape[1]
    buffer[idx, :n] = rows.to(buffer.dtype)
    if n < buffer.shape[1]:
        buffer[idx, n:] = 0.0


def _owned(mesh, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mask, local)``: which of the row ids ``ids`` this rank's data
    coordinate owns, and every id's local row (``id // data``)."""
    return ids % mesh.data == mesh.data_index, ids // mesh.data


def _stripe(tile: torch.Tensor, mesh) -> slice:
    """The columns of a whole row that this rank's tile holds."""
    lo = mesh.model_index * tile.shape[1]
    return slice(lo, lo + tile.shape[1])


def _scatter_owned(tile: torch.Tensor, mesh, ids, stripe: torch.Tensor
                   ) -> None:
    """``stripe`` [K, <=W/model], this rank's columns of rows ``ids``, into
    the rows of ``tile`` that this rank owns."""
    idx = torch.as_tensor(ids, dtype=torch.int64, device=tile.device)
    mine, local = _owned(mesh, idx)
    scatter_rows(tile, local[mine], stripe.to(tile.device)[mine])


def land_lanes(buffer: torch.Tensor, ids, lanes: torch.Tensor,
               mesh=None) -> None:
    """Write the cohort's trained rows into ``buffer`` at row ids ``ids``
    ([Kp]: host ids or an int64 tensor). Un-meshed, ``lanes`` is the whole
    ``[Kp, n<=W]`` cohort and ``buffer`` the whole buffer. Under a mesh,
    ``lanes`` is this data rank's ``[Kp/data, W]`` share of the cohort
    (``CohortTrainer``'s lane split) and ``buffer`` this rank's tile: each
    rank's column stripe of its lanes is all-gathered over ``data`` into
    the cohort's ``[Kp, W/model]`` stripe, and the rows this rank owns are
    written."""
    if mesh is None:
        scatter_rows(buffer, ids, lanes)
        return
    _scatter_owned(buffer, mesh, ids, flmesh.all_gather_data(
        lanes[:, _stripe(buffer, mesh)].contiguous(), mesh))


class UpdateStore:
    """Free-listed [capacity, W] fp32 device buffer of flat client updates
    (this rank's ``[capacity/data, W/model]`` tile of it under a mesh)."""

    def __init__(self, n_params: int, capacity: int = 16,
                 dtype=torch.float32, device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None and device is None \
            else resolve_device(device)
        self.n_params = int(n_params)
        self.row_width = _round_up(self.n_params,
                                   flmesh.row_align(mesh, BLOCK_N))
        self._cap_align = flmesh.capacity_align(mesh, SUBLANE)
        self._d, self._m = flmesh.mesh_axes(mesh)
        self.dtype = dtype
        self.capacity = 0
        self.buffer: Optional[torch.Tensor] = None
        self._free: list[int] = []
        self._live: set[int] = set()
        self._ensure(max(int(capacity), 1))

    def _ensure(self, capacity: int) -> None:
        if capacity <= self.capacity:
            return
        # double (at least) so growth is amortized O(1) per row
        cap = _round_up(max(capacity, 2 * self.capacity), self._cap_align)
        grown = torch.zeros(((cap - self.capacity) // self._d,
                             self.row_width // self._m),
                            dtype=self.dtype, device=self.device)
        self.buffer = (grown if self.buffer is None
                       else torch.cat([self.buffer, grown], dim=0))
        self._free.extend(range(self.capacity, cap))
        self.capacity = cap

    def alloc(self, k: int) -> np.ndarray:
        """Reserve k row ids (grows the buffer if the free-list runs dry)."""
        if len(self._free) < k:
            self._ensure(self.capacity + (k - len(self._free)))
        ids = np.array([self._free.pop() for _ in range(k)], np.int64)
        self._live.update(int(i) for i in ids)
        return ids

    def _write(self, ids: np.ndarray, rows: torch.Tensor) -> None:
        """Whole ``[K, n<=W]`` rows, the same on every rank, into this
        rank's rows and column stripe of them."""
        if self.mesh is None:
            scatter_rows(self.buffer, ids, rows)
        else:
            _scatter_owned(self.buffer, self.mesh, ids,
                           rows[:, _stripe(self.buffer, self.mesh)])

    def put(self, rows: torch.Tensor) -> np.ndarray:
        """Write [K, n_params<=W] rows into freshly allocated slots."""
        ids = self.alloc(rows.shape[0])
        self._write(ids, rows)
        return ids

    def write_at(self, ids: Sequence[int], rows) -> None:
        """Write rows at specific ids (checkpoint rehydration and snapshot
        install), reserving them. Accepts [L, n_params] or full [L, W] rows
        (host arrays or tensors); rows of a store with a wider W are
        trimmed to this store's W (the excess is tail pad zeros)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        self._ensure(int(ids.max()) + 1)
        for i in ids:
            i = int(i)
            if i in self._free:
                self._free.remove(i)
            self._live.add(i)
        rows = torch.as_tensor(rows)
        if rows.shape[1] > self.row_width:
            rows = rows[:, : self.row_width]
        self._write(ids, rows.to(self.device))

    def gather(self, ids: Sequence[int]) -> torch.Tensor:
        """[len(ids), W] device gather; under a mesh whole rows on every
        rank, each row its owner's, each stripe its model rank's."""
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        if self.mesh is None:
            return self.buffer[idx]
        mine, local = _owned(self.mesh, idx)
        part = self.buffer.new_zeros((len(idx), self.buffer.shape[1]))
        part[mine] = self.buffer[local[mine]]
        parts = flmesh.all_gather_data(part, self.mesh).view(
            self._d, len(idx), self.buffer.shape[1])
        stripe = parts[idx % self._d, torch.arange(len(idx),
                                                   device=self.device)]
        return flmesh.all_gather_model(stripe, self.mesh)

    def free(self, ids: Sequence[int]) -> None:
        """Recycle rows: a pure free-list operation, no device work."""
        for i in ids:
            i = int(i)
            if i in self._live:
                self._live.discard(i)
                self._free.append(i)

    def free_stack(self) -> np.ndarray:
        """The LIFO free-list as an ``[n_free] int64`` array, bottom -> top
        (``alloc`` pops from the END). The fused-round megastep carries it
        through its rounds so that its row allocation gives exactly the ids
        ``alloc`` gives when the host replays the rounds afterwards."""
        return np.asarray(self._free, np.int64)

    def live_rows(self) -> np.ndarray:
        return np.array(sorted(self._live), np.int64)
