"""Public entry points around the kernels (twin of ``repro.kernels.ops``).

  - ``RavelSpec``: the flattening contract (leaf order, shapes, dtypes,
    offsets) shared by every params <-> flat-buffer boundary: the update
    store's rows, the cohort trainer's stacked flat params, aggregation;
  - ``aggregate_rows``: the full-buffer sweep over a persistent ``[C, W]``
    row buffer (weights scattered over all C rows, free rows at 0);
  - ``aggregate_rows_gather``: the same sum over only the referenced rows;
  - ``aggregate_rows_psum``: the sweep over a mesh-sharded buffer, each
    rank's tile reduced by the kernel, the partials all-reduced over the
    mesh's ``data`` axis and the column stripes all-gathered over
    ``model`` (``aggregate_rows_psum_gather``: its exact-rows recompute);
  - ``aggregate_rows_traced``: any of these routes on row ids and weights
    already on the card, with the sweep's finiteness guard (the
    fused-round megastep's aggregation);
  - ``aggregate_pytree``: the same weighted sum over a list of parameter
    trees (ravel, stack, reduce, unravel);
  - ``masked_topk`` / ``scored_topk``: the fleet-scale top-k selection step
    of ``apodotiko-topk`` (``FleetStore.select_topk``);
  - ``compress_update`` / ``decompress_update``: int8 client-update
    compression with error feedback (``kernels.quant8``: one fused
    ``compress_q8`` launch a compression, one ``dequantize_q8`` a
    decompression);
  - ``flash_attention`` (``kernels.flash_attention``).

The reductions go through ``kernels.staleness_agg``, the top-k through
``kernels.topk`` (one launch per call for k <= 1024; a larger k is a sort
on the tensors' device, as the reference's ``lax.top_k`` route): a CUDA
tensor launches the kernel, a CPU tensor takes its plain version.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.quant8 import (  # noqa: F401
    QBLOCK, ROWS, compress_q8, dequantize_q8, quantize_q8)
from repro_torch.kernels.staleness_agg import VEC, staleness_agg
from repro_torch.kernels.topk import masked_topk, scored_topk  # noqa: F401
from repro_torch.sharding import flmesh

Params = Any   # nested dicts (and lists) of tensors
BLOCK_N = 1024   # update-store row width alignment (the reference's block)
SUBLANE = 8      # row-count alignment; K pads to a multiple


def tree_leaves(tree: Params) -> list:
    """Leaves in ``jax.tree.leaves`` order: sorted dict keys, list items in
    index order, depth first; an empty dict or list has no leaves."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [l for x in tree for l in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    """``fn`` over matching leaves of dict and list trees (structure of
    ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, x, *(r[i] for r in rest))
                for i, x in enumerate(tree)]
    return fn(tree, *rest)


def _structure(tree: Params):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_structure(x) for x in tree]
    return None


def _unflatten(struct, leaves):
    if isinstance(struct, dict):
        return {k: _unflatten(v, leaves) for k, v in struct.items()}
    if isinstance(struct, list):
        return [_unflatten(v, leaves) for v in struct]
    return next(leaves)


class RavelSpec:
    """Stable params <-> flat fp32 buffer contract.

    Built once from a template tree of tensors (or numpy arrays): nested
    dicts and lists, as ``DecoderLM``'s ``params["layers"]["first"]``; any
    structurally identical tree ravels into ``[N]`` (or ``[K, N]`` rows
    for ``[K, ...]``-stacked leaves) in ``tree_leaves`` order, the order
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


def _sweep(buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
           ) -> torch.Tensor:
    full_w = torch.zeros(buffer.shape[0], dtype=torch.float32,
                         device=buffer.device)
    full_w.index_add_(0, idx, w)
    return staleness_agg(_vec_pad(buffer), full_w)[:buffer.shape[1]]


def _gather(buffer: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
    return staleness_agg(_vec_pad(buffer), w, rows=idx)[:buffer.shape[1]]


def _on(buffer: torch.Tensor, row_idx, weights):
    idx, w = _pad_rows(row_idx, weights)
    return (torch.as_tensor(idx, device=buffer.device),
            torch.as_tensor(w, device=buffer.device))


def aggregate_rows(buffer: torch.Tensor, row_idx, weights) -> torch.Tensor:
    """``sum_k weights[k] * buffer[row_idx[k], :]`` -> flat [W] fp32 by a
    sweep of the WHOLE buffer: the K weights scatter-add into a
    ``[capacity]`` weight vector and every row enters the sum, free rows at
    weight 0. Exact for finite values only (0 * inf = nan): callers guard
    the result and recompute through ``aggregate_rows_gather``, as
    ``core.aggregation.weighted_aggregate_rows`` does."""
    return _sweep(buffer, *_on(buffer, row_idx, weights))


def aggregate_rows_gather(buffer: torch.Tensor, row_idx, weights
                          ) -> torch.Tensor:
    """Exact-rows form: reads ONLY the referenced rows, so it is immune to
    non-finite garbage in freed rows."""
    return _gather(buffer, *_on(buffer, row_idx, weights))


def _psum_sweep(tile: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                mesh) -> torch.Tensor:
    """The reference's ``_psum_agg`` on this rank's ``[C/d, W/m]`` tile: the
    ``[C]`` weight vector built alike on every rank, this rank's rows of it
    (``data_index::data``, the store's cyclic rows), one sweep launch, the
    partial all-reduced over ``data``, the stripes all-gathered over
    ``model`` -> the whole [W] on every rank."""
    d = mesh.data
    full_w = torch.zeros(tile.shape[0] * d, dtype=torch.float32,
                         device=tile.device)
    full_w.index_add_(0, idx, w)
    part = staleness_agg(_vec_pad(tile), full_w[mesh.data_index::d]
                         .contiguous())[:tile.shape[1]]
    return flmesh.all_gather_model(flmesh.all_reduce_data(part, mesh), mesh)


def _psum_gather(tile: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 mesh) -> torch.Tensor:
    """The exact-rows form over a mesh: each rank reduces only the
    referenced rows it owns (one gather-form launch, padded as
    ``_pad_rows`` pads, with zero-weight repeats of its first owned row;
    no launch and a zero partial where it owns none), then the same
    collectives as ``_psum_sweep``."""
    mine = idx % mesh.data == mesh.data_index
    if bool(mine.any()):
        li, lw = idx[mine] // mesh.data, w[mine]
        pad_k = (-li.shape[0]) % SUBLANE
        if pad_k:
            li = torch.cat([li, li[:1].repeat(pad_k)])
            lw = torch.cat([lw, lw.new_zeros(pad_k)])
        part = _gather(tile, li, lw)
    else:
        part = tile.new_zeros(tile.shape[1], dtype=torch.float32)
    return flmesh.all_gather_model(flmesh.all_reduce_data(part, mesh), mesh)


def aggregate_rows_psum(buffer: torch.Tensor, row_idx, weights, mesh
                        ) -> torch.Tensor:
    """``aggregate_rows`` over a mesh-sharded store (``buffer`` is this
    rank's ``UpdateStore`` tile) -> the whole flat [W] on every rank. The
    same weight-0 stale-row contract: callers guard the result (decided on
    the whole [W], so every rank decides alike) and recompute through
    ``aggregate_rows_psum_gather``."""
    return _psum_sweep(buffer, *_on(buffer, row_idx, weights), mesh)


def aggregate_rows_psum_gather(buffer: torch.Tensor, row_idx, weights, mesh
                               ) -> torch.Tensor:
    """The exact-rows form of ``aggregate_rows_psum``: immune to non-finite
    garbage in freed rows."""
    return _psum_gather(buffer, *_on(buffer, row_idx, weights), mesh)


def all_finite(flat: torch.Tensor) -> bool:
    """Aggregation's finiteness guard on a weighted sum: the host waits on
    the card for one flag, in an ``aggregation.wait`` span."""
    with tracing.span("aggregation.wait"):
        return bool(torch.isfinite(flat).all())


def aggregate_rows_traced(buffer: torch.Tensor, row_idx: torch.Tensor,
                          weights: torch.Tensor, *, sparse: bool, mesh=None
                          ) -> torch.Tensor:
    """The fused-round megastep's aggregation (twin of the reference's
    traceable ``aggregate_rows_traced``): ``row_idx`` [K] int64 and
    ``weights`` [K] fp32 already on ``buffer``'s device, padded on the
    device as ``_pad_rows`` pads them (zero-weight repeats of row 0), then
    the route ``sparse`` names (``core.aggregation.rows_dispatch``): the
    gather, or the sweep with its finiteness guard, an exact-rows recompute
    when the [W] result is not finite (one read on the host). With a mesh
    the route is the psum sweep and its guard, as
    ``weighted_aggregate_rows(mesh=)`` takes it. The same launches on the
    same values as the stepwise route, so the result is equal to the
    bit."""
    idx, w = row_idx.to(torch.int64), weights.to(torch.float32)
    pad_k = (-idx.shape[0]) % SUBLANE
    if pad_k:
        idx = torch.cat([idx, idx[:1].repeat(pad_k)])
        w = torch.cat([w, w.new_zeros(pad_k)])
    if mesh is not None:
        flat = _psum_sweep(buffer, idx, w, mesh)
        if not all_finite(flat):
            flat = _psum_gather(buffer, idx, w, mesh)
        return flat
    if sparse:
        return _gather(buffer, idx, w)
    flat = _sweep(buffer, idx, w)
    if not all_finite(flat):
        flat = _gather(buffer, idx, w)
    return flat


def aggregate_pytree(updates: Sequence[Params], weights, *,
                     restore_dtype: bool = True) -> Params:
    """``sum_k weights[k] * updates[k]`` over K parameter trees: ravel ->
    ``[K, N]`` -> ``staleness_agg`` -> unravel (twin of the reference's
    ``ops.aggregate_pytree``). K pads to the sublane multiple with
    zero-weight rows and N to the kernel's vector width with zero columns;
    ``restore_dtype=False`` keeps fp32 leaves."""
    spec = RavelSpec(updates[0])
    stacked = torch.stack([spec.ravel(u) for u in updates], 0)
    w = torch.as_tensor(weights, dtype=torch.float32, device=stacked.device)
    K, N = stacked.shape
    pad_k, pad_n = (-K) % SUBLANE, (-N) % VEC
    if pad_k or pad_n:
        stacked = F.pad(stacked, (0, pad_n, 0, pad_k))
        w = F.pad(w, (0, pad_k))
    agg = staleness_agg(stacked, w)
    return spec.unravel(agg[:N], restore_dtype=restore_dtype)


def compress_update(update: Params, error_feedback: Optional[torch.Tensor]
                    = None):
    """int8-compress a client update with residual error feedback (twin of
    the reference's ``ops.compress_update``): ravel, then one
    ``compress_q8`` (add the flat error feedback, zero-pad to a multiple of
    ``ROWS * QBLOCK`` so the codes keep the padded length, quantize,
    dequantize, trim, subtract), one launch on the card. Returns
    ``((q, scales, spec), err)`` with ``err = flat - dequantized`` [N]."""
    spec = RavelSpec(update)
    N = spec.n_params
    q, s, err = compress_q8(spec.ravel(update), error_feedback,
                            N + (-N) % (ROWS * QBLOCK))
    return (q, s, spec), err


def decompress_update(q: torch.Tensor, s: torch.Tensor, meta: RavelSpec
                      ) -> Params:
    """The update tree back from ``compress_update``'s codes and scales, in
    the leaves' own dtypes: only the first N codes are dequantized (the
    padding's would be cut away)."""
    return meta.unravel(dequantize_q8(q[:meta.n_params], s))
