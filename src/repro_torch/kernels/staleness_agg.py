"""Staleness-weighted row reduction: wrapper around ``csrc/staleness_agg.cu``.

``staleness_agg(updates, weights, rows=None)`` returns
``sum_k weights[k] * updates[rows[k]]`` (``rows[k] = k`` when ``rows`` is
None) as a flat fp32 ``[N]``. A CPU tensor takes the plain torch version
(``ref.staleness_agg``); a CUDA tensor launches the kernel or raises.
``staleness_agg.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

VEC = 4   # the kernel loads float4: N and the row stride are multiples of 4


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
    if updates.device.type == "cpu":
        return ref.staleness_agg(updates, weights, rows)
    tensors = (updates, weights) + ((rows,) if rows is not None else ())
    if any(t.device != updates.device for t in tensors):
        raise ValueError("updates, weights and rows must be on one device")
    if updates.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("staleness_agg takes fp32 updates and weights")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("staleness_agg takes contiguous tensors")
    C, N = updates.shape
    if N % VEC or updates.data_ptr() % 16:
        raise ValueError(f"row width {N} must be a multiple of {VEC} and the "
                         "buffer 16-byte aligned")
    out = torch.empty(N, dtype=torch.float32, device=updates.device)
    fn = _build.function("staleness_agg", "staleness_agg_f32", ctypes.c_int,
                         [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
                         + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(updates.device).cuda_stream
    rc = fn(updates.data_ptr(), weights.data_ptr(),
            rows.data_ptr() if rows is not None else None, out.data_ptr(),
            K, N, N, stream)
    if rc != 0:
        raise RuntimeError(f"staleness_agg launch failed: CUDA error {rc}")
    staleness_agg.launches += 1
    return out


staleness_agg.launches = 0
