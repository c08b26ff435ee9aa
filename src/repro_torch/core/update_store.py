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
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import BLOCK_N, SUBLANE


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


class UpdateStore:
    """Free-listed [capacity, W] fp32 device buffer of flat client updates."""

    def __init__(self, n_params: int, capacity: int = 16,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.n_params = int(n_params)
        self.row_width = _round_up(self.n_params, BLOCK_N)
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
        cap = _round_up(max(capacity, 2 * self.capacity), SUBLANE)
        grown = torch.zeros((cap - self.capacity, self.row_width),
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

    def put(self, rows: torch.Tensor) -> np.ndarray:
        """Write [K, n_params<=W] rows into freshly allocated slots."""
        ids = self.alloc(rows.shape[0])
        scatter_rows(self.buffer, ids, rows)
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
        scatter_rows(self.buffer, ids, rows.to(self.device))

    def gather(self, ids: Sequence[int]) -> torch.Tensor:
        """[len(ids), W] device gather."""
        return self.buffer[torch.as_tensor(np.asarray(ids, np.int64),
                                           device=self.device)]

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
