"""Attention forward: wrapper around ``csrc/flash_attention.cu``.

``flash_attention(q, k, v, causal=True, sm_scale=None, block_q=128,
block_k=128)`` takes q ``[B, H, S, D]`` and k/v ``[B, H, T, D]`` (k/v with
q's head count: grouped-query expansion is the caller's) and returns
``[B, H, S, D]`` in q's dtype, with the reference's contract: S a multiple of
``block_q`` and T of ``block_k`` (``ValueError`` otherwise), ``sm_scale``
defaulting to ``D ** -0.5``. A CPU tensor takes the plain torch version
(``ref.flash_attention``); a CUDA tensor launches the kernel or raises:
bf16 and fp16 the Hopper kernel (wgmma fed by TMA, 128 x 128 tiles), fp32
the kernel of three TF32 tensor-core products (mma.sync, 128 x 64 tiles).
The kernels are built for D of 64 and 128; any other D up to 128 is padded
with zero columns to the next of the two (``pad_head_dim``: the scores are
unchanged, the extra output columns are zeros and are cut off), a copy
that is part of the call. The kernels tile by their own sizes, so the block
sizes only set the contract. A ``meta`` tensor runs nothing: the output's
shape, and q, k, v read and the output written reported to
``_build.meta_launch``. ``flash_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = ref.NEG_INF
HEAD_DIMS = (64, 128)      # head dims the kernel is built for
# the kernel's type codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# flash_attention_fwd(q, k, v, o, BH, S, T, D, dtype, causal, sm_scale, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_float, ctypes.c_void_p]


def kernel_head_dim(d: int) -> int:
    """The head dim the kernel runs a head of ``d`` at: the least of
    ``HEAD_DIMS`` that holds it. ``NotImplementedError`` past the largest."""
    for kd in HEAD_DIMS:
        if d <= kd:
            return kd
    raise NotImplementedError(
        f"the flash_attention kernel takes head dims up to {HEAD_DIMS[-1]}, "
        f"not D={d} (a wider tile is ROADMAP §2 item 4)")


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` [..., D] with zero columns appended up to ``d`` (a copy)."""
    return F.pad(t, (0, d - t.shape[-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale=None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q [B,H,S,D], k/v [B,H,T,D] -> [B,H,S,D]. On CUDA: fp32, bf16 or
    fp16, one dtype and one card for all three, contiguous, D <= 128."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"need q [B,H,S,D] and k, v [B,H,T,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    T = k.shape[2]
    if S % block_q or T % block_k:
        raise ValueError(f"S={S} must be a multiple of block_q={block_q} and "
                         f"T={T} of block_k={block_k}")
    if sm_scale is None:
        sm_scale = D ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        _build.meta_launch("flash_attention", _build.nbytes(q, k, v),
                           _build.nbytes(out))
        return out
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes fp32, bf16 or fp16 (one "
                        f"dtype), got {q.dtype}, {k.dtype}, {v.dtype}")
    kd = kernel_head_dim(D)
    if kd != D:
        q, k, v = (pad_head_dim(t, kd) for t in (q, k, v))
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte aligned "
                         "tensors")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :D]
    fn = _build.function("flash_attention", "flash_attention_fwd",
                         ctypes.c_int, ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, S, T, kd, DTYPES[q.dtype], int(bool(causal)),
            float(np.float32(sm_scale)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out if kd == D else out[..., :D].contiguous()


flash_attention.launches = 0
