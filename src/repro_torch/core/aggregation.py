"""Staleness-weighted asynchronous aggregation (paper §III-B), the twin of
``repro.core.aggregation`` over the device-resident update plane.

    w_{T+1} = sum_i s(t_i, T) * (n_i / n) * w^i  /  sum_i s(t_i, T) * (n_i / n)

with ``s`` Eq. 2 (Apodotiko) or Eq. 1 (FedLesScan), normalized as in the
FedLess reference implementation.

``weighted_aggregate_rows`` reduces K rows of an ``UpdateStore`` buffer by
row id. It keeps the reference's two routes and their rule:

  * **sweep** (``kernels.ops.aggregate_rows``): the K weights scatter over
    the whole ``[capacity]`` buffer, freed rows at weight 0, one pass;
  * **gather** (``kernels.ops.aggregate_rows_gather``): only the K
    referenced rows are read. Taken when the reference set is a small
    fraction of a grown buffer (capacity only doubles, never shrinks), and
    as the exact recompute when the sweep's result is not finite
    (0 * inf = nan from garbage in a freed row).

Both routes run the ``staleness_agg`` kernel on the card. ``last_path()``
names the route of the latest aggregate, ``guard_recomputes()`` counts the
finiteness guard's recomputes.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.staleness import STALENESS_FNS
from repro_torch.kernels import ops as kernel_ops

Params = Any

_LAST_PATH = "none"
_GUARD_RECOMPUTES = 0


def last_path() -> str:
    """'sweep' | 'gather': the route of the most recent aggregate."""
    return _LAST_PATH


def guard_recomputes() -> int:
    """How many sweeps the finiteness guard recomputed through the gather
    route in this process."""
    return _GUARD_RECOMPUTES


def staleness_weights(rounds: Sequence[int], cardinalities: Sequence[int],
                      current_round: int, fn: str = "eq2") -> np.ndarray:
    s = STALENESS_FNS[fn]
    n = float(sum(cardinalities)) or 1.0
    w = np.array([s(t_i, current_round) * (n_i / n)
                  for t_i, n_i in zip(rounds, cardinalities)], np.float64)
    total = w.sum()
    if total <= 0:
        w = np.full(len(w), 1.0 / max(len(w), 1))
        total = 1.0
    return (w / total).astype(np.float32)


def weighted_aggregate_rows(buffer: torch.Tensor, row_idx, weights,
                            spec: "kernel_ops.RavelSpec", out_dtype=None,
                            mesh=None) -> Params:
    """Reduce rows ``row_idx`` of the ``[capacity, W]`` buffer with
    ``weights`` and unravel the flat result once into a params dict."""
    global _LAST_PATH, _GUARD_RECOMPUTES
    if mesh is not None:
        raise NotImplementedError(
            "sharded aggregation over a mesh comes with a later slice of "
            "the port (only the 1x1 mesh is supported)")
    if len(row_idx) != len(weights) or len(row_idx) == 0:
        raise ValueError(f"{len(row_idx)} rows for {len(weights)} weights")
    sparse = buffer.shape[0] >= 4 * max(len(row_idx), kernel_ops.SUBLANE)
    if sparse:
        flat = kernel_ops.aggregate_rows_gather(buffer, row_idx, weights)
        _LAST_PATH = "gather"
    else:
        flat = kernel_ops.aggregate_rows(buffer, row_idx, weights)
        _LAST_PATH = "sweep"
        # the guard reads the [W] result, not the buffer
        if not bool(torch.isfinite(flat).all()):
            flat = kernel_ops.aggregate_rows_gather(buffer, row_idx, weights)
            _GUARD_RECOMPUTES += 1
    out = spec.unravel(flat[:spec.n_params], restore_dtype=False)
    if out_dtype is not None:
        out = kernel_ops.tree_map(lambda x: x.to(out_dtype), out)
    return out
