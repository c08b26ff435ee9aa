"""Block-scaled int8 (de)quantization: wrappers around ``csrc/quant8.cu``.

``quantize_q8(x)`` turns an fp32 ``[N]`` into int8 codes ``[N]`` and one
fp32 scale per block of ``QBLOCK`` values, ``[ceil(N / QBLOCK)]``;
``dequantize_q8(q, s, dtype=...)`` is its inverse. Any N: the tail block is
read as zero-padded, as the reference pads and trims. A CPU tensor takes the
plain torch version (``ref.quantize_q8`` / ``ref.dequantize_q8``); a CUDA
tensor launches the kernel or raises. ``quantize_q8.launches`` and
``dequantize_q8.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

QBLOCK = ref.QBLOCK   # elements per scale
ROWS = 8              # scale blocks per CTA; compress_update pads to ROWS*QBLOCK


def _on_card(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"quant8 kernels run on a CUDA tensor, got {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("quant8 kernels take contiguous tensors")


def _n_blocks(n: int) -> int:
    return -(-n // QBLOCK)


def quantize_q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N] -> (int8 codes [N], fp32 scales [ceil(N/256)]). On CUDA: fp32
    and contiguous."""
    if x.dim() != 1:
        raise ValueError(f"x must be [N], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.quantize_q8(x)
    _on_card(x)
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_q8 takes fp32, got {x.dtype}")
    N = x.shape[0]
    q = torch.empty(N, dtype=torch.int8, device=x.device)
    s = torch.empty(_n_blocks(N), dtype=torch.float32, device=x.device)
    if N == 0:
        return q, s
    fn = _build.function("quant8", "quantize_q8_f32", ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p])
    rc = fn(x.data_ptr(), N, q.data_ptr(), s.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_q8 launch failed: CUDA error {rc}")
    quantize_q8.launches += 1
    return q, s


def dequantize_q8(q: torch.Tensor, scales: torch.Tensor, *,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 codes [N], fp32 scales [ns] -> ``q * scale`` as ``dtype`` [N].
    ns may fall short of ceil(N/256) (a block past the last scale takes
    1.0) but not exceed the reference's padded block count. On CUDA: int8
    and fp32, contiguous; ``dtype`` fp32 or bf16."""
    if q.dim() != 1 or scales.dim() != 1:
        raise ValueError(f"q and scales must be 1-D, got {tuple(q.shape)} "
                         f"and {tuple(scales.shape)}")
    N, ns = q.shape[0], scales.shape[0]
    if ns > -(-N // (ROWS * QBLOCK)) * ROWS:
        raise ValueError(f"{ns} scales for {N} codes")
    if q.device.type == "cpu":
        return ref.dequantize_q8(q, scales, dtype)
    _on_card(q, scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_q8 takes int8 codes and fp32 scales, "
                        f"got {q.dtype} and {scales.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequantize_q8 writes fp32 or bf16, not {dtype}")
    out = torch.empty(N, dtype=dtype, device=q.device)
    if N == 0:
        return out
    fn = _build.function("quant8", "dequantize_q8", ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    rc = fn(q.data_ptr(), scales.data_ptr(), N, min(ns, _n_blocks(N)),
            out.data_ptr(), int(dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequantize_q8 launch failed: CUDA error {rc}")
    dequantize_q8.launches += 1
    return out


quantize_q8.launches = 0
dequantize_q8.launches = 0
