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
for the same sequence of calls.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import BLOCK_N, SUBLANE


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def scatter_rows(buffer: torch.Tensor, ids, rows: torch.Tensor) -> None:
    """Write ``[K, n<=W]`` rows into ``buffer`` at ``ids`` in place, the
    tail pad lanes zeroed."""
    idx = torch.as_tensor(np.asarray(ids, np.int64), device=buffer.device)
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

    def live_rows(self) -> np.ndarray:
        return np.array(sorted(self._live), np.int64)
