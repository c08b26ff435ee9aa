"""Blockwise top-k: wrapper around ``csrc/topk.cu``.

``block_topk(scores, k, block)`` returns each block's k largest scores and
their indices into ``scores`` as ``(vals [G, k] fp32, idx [G, k] int64)``,
G = ceil(M / block), with positions past M acting as -inf scores. The
order is ``lax.top_k``'s: larger first, equal scores by ascending index, no
index twice (``ref.block_topk``). A CPU tensor takes the plain torch version;
a CUDA tensor launches the kernel or raises. ``block_topk.launches`` counts
kernel launches. ``kernels.ops.masked_topk`` reduces the candidates by
launching the kernel again on them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

BLOCK_TOPK = 1024   # scores per block (one CTA each); also the largest block


def block_topk(scores: torch.Tensor, k: int, block: int = BLOCK_TOPK
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """scores [M] -> (vals [G, k] fp32, idx [G, k] int64);
    1 <= k <= block <= 1024. On CUDA: fp32 and contiguous."""
    if scores.dim() != 1 or scores.shape[0] < 1:
        raise ValueError(f"scores must be a non-empty [M], got "
                         f"{tuple(scores.shape)}")
    if not 1 <= k <= block <= BLOCK_TOPK:
        raise ValueError(f"need 1 <= k <= block <= {BLOCK_TOPK}, got "
                         f"k={k}, block={block}")
    if scores.device.type == "cpu":
        return ref.block_topk(scores, k, block)
    if scores.dtype != torch.float32:
        raise TypeError("block_topk takes fp32 scores")
    if not scores.is_contiguous():
        raise ValueError("block_topk takes contiguous scores")
    M = scores.shape[0]
    G = -(-M // block)
    vals = torch.empty((G, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((G, k), dtype=torch.int64, device=scores.device)
    fn = _build.function("topk", "block_topk_f32", ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = fn(scores.data_ptr(), M, block, k, vals.data_ptr(), idx.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"block_topk launch failed: CUDA error {rc}")
    block_topk.launches += 1
    return vals, idx


block_topk.launches = 0


def chosen_mask(idx: torch.Tensor, valid: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Scatter a top-k result back to an ``[n]`` bool membership mask
    (invalid slots, the -inf scores that filled the k, stay False)."""
    mask = torch.zeros(n, dtype=torch.bool, device=idx.device)
    mask[idx] = valid
    return mask
