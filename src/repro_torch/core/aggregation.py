"""Staleness-weighted asynchronous aggregation (paper §III-B), the twin of
``repro.core.aggregation``.

    w_{T+1} = sum_i s(t_i, T) * (n_i / n) * w^i  /  sum_i s(t_i, T) * (n_i / n)

with ``s`` Eq. 2 (Apodotiko) or Eq. 1 (FedLesScan), normalized as in the
FedLess reference implementation.

``weighted_aggregate_rows`` reduces K rows of an ``UpdateStore`` buffer by
row id. It keeps the reference's routes and their rule:

  * **sweep** (``kernels.ops.aggregate_rows``): the K weights scatter over
    the whole ``[capacity]`` buffer, freed rows at weight 0, one pass;
  * **gather** (``kernels.ops.aggregate_rows_gather``): only the K
    referenced rows are read. Taken when the reference set is a small
    fraction of a grown buffer (capacity only doubles, never shrinks), and
    as the exact recompute when the sweep's result is not finite
    (0 * inf = nan from garbage in a freed row);
  * **psum** (``kernels.ops.aggregate_rows_psum``), with a mesh: the sweep
    over each rank's tile of a mesh-sharded store, the partials
    all-reduced over ``data``, as the reference's mesh route, taken
    whatever the row counts; its guard recomputes through the exact-rows
    form on each rank's owned rows (``aggregate_rows_psum_gather``).

``weighted_aggregate`` reduces a list of K parameter trees (the blob
update plane's transport, the reference's equivalence oracle) through
``kernels.ops.aggregate_pytree``: ravel, stack to ``[K, N]``, one
``staleness_agg`` launch on the card. Unlike the reference it has no
``path`` argument, no self-check and no fallback: the tensors' device
picks the kernel or its plain version.

Every route runs the ``staleness_agg`` kernel on the card. ``rows_dispatch``
is the route's one predicate, shared with the fused-round megastep, whose
aggregation (``kernels.ops.aggregate_rows_traced``) takes the same route
on row ids and weights that are already on the card. ``last_path()`` names
the route of the latest aggregate, ``guard_recomputes()`` counts the
finiteness guard's recomputes. ``incremental_aggregate`` is the
reference's streaming form, a running fp32 sum of weighted trees.
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
    """'sweep' | 'gather' | 'psum': the route of the most recent
    aggregate."""
    return _LAST_PATH


def guard_recomputes() -> int:
    """How many sweeps of ``weighted_aggregate_rows`` the finiteness guard
    recomputed through the gather route in this process."""
    return _GUARD_RECOMPUTES


def rows_dispatch(buffer_rows: int, k: int) -> bool:
    """The route of an aggregate of ``k`` rows of a ``[buffer_rows, W]``
    buffer: True for the gather (the K rows are a small fraction of a grown
    buffer), False for the sweep. The one place this predicate lives, so
    that the stepwise route and the megastep's cannot fork."""
    return buffer_rows >= 4 * max(k, kernel_ops.SUBLANE)


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


def weighted_aggregate(updates: Sequence[Params], weights,
                       out_dtype=None) -> Params:
    """``updates``, a list of K parameter trees -> their ``weights``-weighted
    sum, fp32 leaves unless ``out_dtype`` is given: one ``staleness_agg``
    over the ``[K, N]`` stack (K padded to ``SUBLANE`` with zero-weight
    rows, N to the kernel's vector width)."""
    if len(updates) != len(weights) or len(updates) == 0:
        raise ValueError(f"{len(updates)} updates for {len(weights)} weights")
    out = kernel_ops.aggregate_pytree(updates, weights, restore_dtype=False)
    if out_dtype is not None:
        out = kernel_ops.tree_map(lambda x: x.to(out_dtype), out)
    return out


def weighted_aggregate_rows(buffer: torch.Tensor, row_idx, weights,
                            spec: "kernel_ops.RavelSpec", out_dtype=None,
                            mesh=None) -> Params:
    """Reduce rows ``row_idx`` of the ``[capacity, W]`` buffer with
    ``weights`` and unravel the flat result once into a params dict. With
    ``mesh``, ``buffer`` is this rank's tile of a mesh-sharded store and
    every rank gets the whole result; the finiteness guard reads the whole
    [W], so every rank takes the recompute alike and the ranks' collectives
    stay in step."""
    global _LAST_PATH, _GUARD_RECOMPUTES
    if len(row_idx) != len(weights) or len(row_idx) == 0:
        raise ValueError(f"{len(row_idx)} rows for {len(weights)} weights")
    if mesh is not None:
        flat = kernel_ops.aggregate_rows_psum(buffer, row_idx, weights, mesh)
        _LAST_PATH = "psum"
        if not bool(torch.isfinite(flat).all()):
            flat = kernel_ops.aggregate_rows_psum_gather(buffer, row_idx,
                                                         weights, mesh)
            _GUARD_RECOMPUTES += 1
    elif rows_dispatch(buffer.shape[0], len(row_idx)):
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


def incremental_aggregate(acc, update: Params, weight: float) -> Params:
    """Streaming form: ``acc += w * update`` in fp32 (callers normalize at
    the end); ``acc`` None starts the sum. For a K too large to stack."""
    if acc is None:
        return kernel_ops.tree_map(lambda x: x.to(torch.float32) * weight,
                                   update)
    return kernel_ops.tree_map(lambda a, x: a + x.to(torch.float32) * weight,
                               acc, update)
