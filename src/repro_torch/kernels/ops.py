"""Public entry points around the kernels (twin of ``repro.kernels.ops``).

  - ``RavelSpec``: the flattening contract (leaf order, shapes, dtypes,
    offsets) shared by every params <-> flat-buffer boundary: the update
    store's rows, the cohort trainer's stacked flat params, aggregation;
  - ``aggregate_rows``: the full-buffer sweep over a persistent ``[C, W]``
    row buffer (weights scattered over all C rows, free rows at 0);
  - ``aggregate_rows_gather``: the same sum over only the referenced rows.

Both reductions go through ``kernels.staleness_agg``: a CUDA buffer
launches the kernel, a CPU buffer takes its plain version.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.staleness_agg import VEC, staleness_agg

Params = Any   # a dict (possibly nested) of tensors
BLOCK_N = 1024   # update-store row width alignment (the reference's block)
SUBLANE = 8      # row-count alignment; K pads to a multiple


def tree_leaves(tree: Params) -> list:
    """Leaves in ``jax.tree.leaves`` order: sorted dict keys, depth first."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    """``fn`` over matching leaves of dict trees (structure of ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _structure(tree: Params):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    return None


def _unflatten(struct, leaves):
    if isinstance(struct, dict):
        return {k: _unflatten(v, leaves) for k, v in struct.items()}
    return next(leaves)


class RavelSpec:
    """Stable params <-> flat fp32 buffer contract.

    Built once from a template dict of tensors (or numpy arrays); any
    structurally identical tree ravels into ``[N]`` (or ``[K, N]`` rows
    for ``[K, ...]``-stacked leaves) in sorted-key leaf order, the order
    of the reference's ``RavelSpec``, so rows compare element-wise."""

    def __init__(self, template: Params):
        leaves = tree_leaves(template)
        self.struct = _structure(template)
        self.shapes = tuple(tuple(l.shape) for l in leaves)
        self.dtypes = tuple(l.dtype if isinstance(l, torch.Tensor)
                            else torch.as_tensor(np.asarray(l)).dtype
                            for l in leaves)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        self.offsets = tuple(int(o) for o in np.cumsum((0,) + self.sizes[:-1]))
        self.n_params = int(sum(self.sizes))

    def ravel(self, tree: Params) -> torch.Tensor:
        """tree (template structure) -> flat [N] fp32."""
        return torch.cat([l.reshape(-1).to(torch.float32)
                          for l in tree_leaves(tree)])

    def ravel_stacked(self, tree: Params) -> torch.Tensor:
        """tree with [K, ...]-stacked leaves -> [K, N] fp32 rows."""
        leaves = tree_leaves(tree)
        K = leaves[0].shape[0]
        return torch.cat([l.reshape(K, -1).to(torch.float32) for l in leaves],
                         dim=1)

    def unravel(self, flat: torch.Tensor, restore_dtype: bool = True) -> Params:
        """flat [>=N] -> tree of views (copies where a dtype is restored)."""
        out = []
        for shape, dtype, off, n in zip(self.shapes, self.dtypes,
                                        self.offsets, self.sizes):
            x = flat[off:off + n].reshape(shape)
            out.append(x.to(dtype) if restore_dtype else x)
        return _unflatten(self.struct, iter(out))

    def unravel_stacked(self, rows: torch.Tensor) -> Params:
        """[K, >=N] rows -> tree of [K, ...] views into ``rows``: writing a
        view writes the row, and an in-place update of the rows is seen
        through every view."""
        out = [rows[:, off:off + n].unflatten(1, shape) if shape
               else rows[:, off]
               for shape, off, n in zip(self.shapes, self.offsets, self.sizes)]
        return _unflatten(self.struct, iter(out))


def _pad_rows(row_idx, weights) -> tuple[np.ndarray, np.ndarray]:
    """Pad (idx, weights) to the sublane multiple with zero-weight repeats
    of row 0 (exact no-ops), as the reference does."""
    idx = np.asarray(row_idx, np.int64)
    w = np.asarray(weights, np.float32)
    pad_k = (-len(idx)) % SUBLANE
    if pad_k:
        idx = np.concatenate([idx, np.repeat(idx[:1], pad_k)])
        w = np.concatenate([w, np.zeros(pad_k, np.float32)])
    return idx, w


def _vec_pad(buffer: torch.Tensor) -> torch.Tensor:
    """A buffer whose width is not a multiple of the kernel's vector width
    gets zero columns (a copy); ``UpdateStore`` rows never need it."""
    pad_n = (-buffer.shape[1]) % VEC
    return F.pad(buffer, (0, pad_n)) if pad_n else buffer


def aggregate_rows(buffer: torch.Tensor, row_idx, weights) -> torch.Tensor:
    """``sum_k weights[k] * buffer[row_idx[k], :]`` -> flat [W] fp32 by a
    sweep of the WHOLE buffer: the K weights scatter-add into a
    ``[capacity]`` weight vector and every row enters the sum, free rows at
    weight 0. Exact for finite values only (0 * inf = nan): callers guard
    the result and recompute through ``aggregate_rows_gather``, as
    ``core.aggregation.weighted_aggregate_rows`` does."""
    idx, w = _pad_rows(row_idx, weights)
    dev = buffer.device
    full_w = torch.zeros(buffer.shape[0], dtype=torch.float32, device=dev)
    full_w.index_add_(0, torch.as_tensor(idx, device=dev),
                      torch.as_tensor(w, device=dev))
    return staleness_agg(_vec_pad(buffer), full_w)[:buffer.shape[1]]


def aggregate_rows_gather(buffer: torch.Tensor, row_idx, weights
                          ) -> torch.Tensor:
    """Exact-rows form: reads ONLY the referenced rows, so it is immune to
    non-finite garbage in freed rows."""
    idx, w = _pad_rows(row_idx, weights)
    dev = buffer.device
    return staleness_agg(_vec_pad(buffer), torch.as_tensor(w, device=dev),
                         rows=torch.as_tensor(idx, device=dev)
                         )[:buffer.shape[1]]
