"""Staleness-weighted row reduction: wrapper around ``csrc/staleness_agg.cu``.

``staleness_agg(updates, weights, rows=None)`` returns
``sum_k weights[k] * updates[rows[k]]`` (``rows[k] = k`` when ``rows`` is
None) as a flat fp32 ``[N]``. A CPU tensor takes the plain torch version
(``ref.staleness_agg``); a CUDA tensor launches the kernel or raises.
``staleness_agg.launches`` counts kernel launches.

The main path's rows-form call is a few tens of microseconds of device
time, so the wrapper does little else on the host: the raw stream handle,
the C function configured once, checks on plain tensor attributes.
``plan`` mirrors how the kernel splits the columns between its CTAs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

VEC = 4   # the kernel loads float4: N and the row stride are multiples of 4
UNIT4 = 8           # float4s in one 128-byte unit of the column split
PIECE_COLS = 8192   # columns in the kernel's largest copy of one row (32 KB)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
             + [ctypes.c_void_p])


def plan(n: int, sms: int) -> list:
    """The kernel's split of ``n`` columns (``n % 4 == 0``) on a card of
    ``sms`` SMs: for each of its CTAs, the ``(start, stop)`` columns of
    the pieces it copies from every row, in order, as
    ``csrc/staleness_agg.cu`` computes them. The row's ``U = n / 32`` whole
    128-byte units go to ``G = min(sms, U)`` CTAs (at least one), CTA b
    taking units ``[b U / G, (b + 1) U / G)`` and the last one also the
    columns past them; each CTA cuts its columns into the fewest
    near-equal runs of whole units (the last maybe partial) of at most
    ``PIECE_COLS`` columns."""
    n4 = n // VEC
    units = n4 // UNIT4
    grid = max(1, min(sms, units))
    out = []
    for b in range(grid):
        c0 = UNIT4 * (b * units // grid)
        c1 = n4 if b == grid - 1 else UNIT4 * ((b + 1) * units // grid)
        cta_units = -(-(c1 - c0) // UNIT4)
        tiles = -(-(c1 - c0) // (PIECE_COLS // VEC))
        edges = [c0 + UNIT4 * (j * cta_units // tiles) for j in range(tiles)]
        out.append([(VEC * a, VEC * e) for a, e in zip(edges, edges[1:]
                                                       + [c1])])
    return out


def _check(updates, weights, rows) -> int:
    if updates.dim() != 2 or weights.dim() != 1:
        raise ValueError(f"updates must be [C, N] and weights [K], got "
                         f"{tuple(updates.shape)} and {tuple(weights.shape)}")
    K = weights.shape[0]
    if rows is None:
        if K != updates.shape[0]:
            raise ValueError(f"{K} weights for {updates.shape[0]} rows")
    elif rows.shape != (K,) or rows.dtype != torch.int64:
        raise ValueError(f"rows must be int64 [{K}], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    return K


def staleness_agg(updates: torch.Tensor, weights: torch.Tensor,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """updates [C, N], weights [K], rows [K] int64 or None (then K == C)
    -> [N] fp32. On CUDA: fp32, contiguous, 16-byte aligned, N % 4 == 0,
    every tensor on the same card; row ids must lie in [0, C)."""
    K = _check(updates, weights, rows)
    if updates.is_cpu:
        return ref.staleness_agg(updates, weights, rows)
    tensors = (updates, weights) if rows is None else (updates, weights, rows)
    dev = updates.get_device()
    if not all(t.is_cuda and t.get_device() == dev for t in tensors):
        raise ValueError("updates, weights and rows must be on one device")
    if updates.dtype is not torch.float32 or \
            weights.dtype is not torch.float32:
        raise TypeError("staleness_agg takes fp32 updates and weights")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("staleness_agg takes contiguous tensors")
    N = updates.shape[1]
    if N % VEC or updates.data_ptr() % 16:
        raise ValueError(f"row width {N} must be a multiple of {VEC} and the "
                         "buffer 16-byte aligned")
    out = updates.new_empty(N)
    fn = _build.function("staleness_agg", "staleness_agg_f32", ctypes.c_int,
                         _ARGTYPES)
    rc = fn(updates.data_ptr(), weights.data_ptr(),
            None if rows is None else rows.data_ptr(), out.data_ptr(), K, N,
            N, _build.stream(updates))
    if rc:
        raise RuntimeError(f"staleness_agg launch failed: CUDA error {rc}")
    staleness_agg.launches += 1
    return out


staleness_agg.launches = 0
