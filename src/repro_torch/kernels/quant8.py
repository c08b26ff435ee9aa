"""Block-scaled int8 (de)quantization: wrappers around ``csrc/quant8.cu``.

``quantize_q8(x)`` turns an fp32 ``[N]`` into int8 codes ``[N]`` and one
fp32 scale per block of ``QBLOCK`` values, ``[ceil(N / QBLOCK)]``;
``dequantize_q8(q, s, dtype=...)`` is its inverse. Any N: the tail block is
read as zero-padded, as the reference pads and trims. ``compress_q8(flat,
ef, n_pad)`` is the two fused with the error feedback of a compressed
update, what ``ops.compress_update`` runs: one launch. A CPU tensor takes
the plain torch version (``ref.quantize_q8`` / ``ref.dequantize_q8`` /
``ref.compress_q8``); a CUDA tensor launches the kernel or raises; a
``meta`` tensor runs nothing and reports the kernel's traffic to
``_build.meta_launch``. Each
wrapper's ``launches`` counts its kernel's launches.

The wrappers are what a call of a few microseconds of device time costs on
the host, so they do little else: the raw stream handle, each C function
configured once, checks on plain tensor attributes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

QBLOCK = ref.QBLOCK   # elements per scale
ROWS = 8              # scale blocks per CTA; compress_update pads to ROWS*QBLOCK

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "quantize_q8_f32": [_P, _I64, _P, _P, _P],
    "dequantize_q8": [_P, _P, _I64, _I64, _P, _INT, _P],
    "compress_q8_f32": [_P, _P, _I64, _I64, _P, _P, _P, _P],
}


def _fn(symbol: str):
    """The C function ``symbol`` of ``quant8.cu``, configured once."""
    return _build.function("quant8", symbol, _INT, _SIGNATURES[symbol])


def _failed(symbol: str, rc: int):
    return RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def _on_card(t: torch.Tensor, dtype: torch.dtype, name: str,
             device: int) -> None:
    """``t`` must be a contiguous ``dtype`` tensor on CUDA device
    ``device``: plain attribute reads, as a wrapper's checks are host time
    on every call."""
    if not t.is_cuda or t.get_device() != device:
        raise ValueError(f"{name} must be a CUDA tensor on the first "
                         f"input's device, got {t.device}")
    if t.dtype is not dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"quant8 kernels take a contiguous {name}")


def _n_blocks(n: int) -> int:
    return -(-n // QBLOCK)


def quantize_q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N] -> (int8 codes [N], fp32 scales [ceil(N/256)]). On CUDA: fp32
    and contiguous."""
    if x.dim() != 1:
        raise ValueError(f"x must be [N], got {tuple(x.shape)}")
    if x.is_cpu:
        return ref.quantize_q8(x)
    if x.is_meta:
        q = x.new_empty(x.shape[0], dtype=torch.int8)
        s = x.new_empty(_n_blocks(x.shape[0]), dtype=torch.float32)
        _build.meta_launch("quantize_q8", _build.nbytes(x),
                           _build.nbytes(q, s))
        return q, s
    dev = x.get_device()
    _on_card(x, torch.float32, "x", dev)
    N = x.shape[0]
    q = x.new_empty(N, dtype=torch.int8)
    s = x.new_empty(_n_blocks(N))
    if N:
        rc = _fn("quantize_q8_f32")(x.data_ptr(), N, q.data_ptr(),
                                    s.data_ptr(), _build.stream(x))
        if rc:
            raise _failed("quantize_q8", rc)
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
    if q.is_cpu:
        return ref.dequantize_q8(q, scales, dtype)
    if q.is_meta:
        out = q.new_empty(N, dtype=dtype)
        _build.meta_launch("dequantize_q8", _build.nbytes(q, scales),
                           _build.nbytes(out))
        return out
    dev = q.get_device()
    _on_card(q, torch.int8, "q", dev)
    _on_card(scales, torch.float32, "scales", dev)
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        raise TypeError(f"dequantize_q8 writes fp32 or bf16, not {dtype}")
    out = q.new_empty(N, dtype=dtype)
    if N:
        rc = _fn("dequantize_q8")(q.data_ptr(), scales.data_ptr(), N,
                                  min(ns, _n_blocks(N)), out.data_ptr(),
                                  dtype is torch.bfloat16, _build.stream(q))
        if rc:
            raise _failed("dequantize_q8", rc)
        dequantize_q8.launches += 1
    return out


def compress_q8(flat: torch.Tensor, ef, n_pad: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 compression step with error feedback: ``v = flat + ef``
    (``flat`` alone where ``ef`` is None), zero-padded to ``n_pad`` (a
    multiple of 256, >= N), quantized per block of 256, and the error
    ``v - dequantized`` over the first N. Returns ``(q [n_pad] int8,
    scales [n_pad / 256] fp32, err [N] fp32)``, to the bit the stepwise
    composition ``ref.compress_q8``. On CUDA: fp32 ``flat`` and ``ef``,
    contiguous (``ef`` may start anywhere), one launch."""
    if flat.dim() != 1:
        raise ValueError(f"flat must be [N], got {tuple(flat.shape)}")
    N = flat.shape[0]
    if n_pad < N or n_pad % QBLOCK:
        raise ValueError(f"n_pad must be a multiple of {QBLOCK} >= {N}, "
                         f"got {n_pad}")
    if ef is not None and ef.shape != flat.shape:
        raise ValueError(f"ef must be [{N}], got {tuple(ef.shape)}")
    if flat.is_cpu:
        return ref.compress_q8(flat, ef, n_pad)
    if flat.is_meta:
        q = flat.new_empty(n_pad, dtype=torch.int8)
        s = flat.new_empty(n_pad // QBLOCK, dtype=torch.float32)
        err = flat.new_empty(N, dtype=torch.float32)
        _build.meta_launch("compress_q8", _build.nbytes(flat) * (
            1 if ef is None else 2), _build.nbytes(q, s, err))
        return q, s, err
    dev = flat.get_device()
    _on_card(flat, torch.float32, "flat", dev)
    if ef is not None:
        _on_card(ef, torch.float32, "ef", dev)
    q = flat.new_empty(n_pad, dtype=torch.int8)
    s = flat.new_empty(n_pad // QBLOCK)
    err = flat.new_empty(N)
    if n_pad:
        rc = _fn("compress_q8_f32")(flat.data_ptr(),
                                    None if ef is None else ef.data_ptr(), N,
                                    n_pad, q.data_ptr(), s.data_ptr(),
                                    err.data_ptr(), _build.stream(flat))
        if rc:
            raise _failed("compress_q8", rc)
        compress_q8.launches += 1
    return q, s, err


quantize_q8.launches = 0
dequantize_q8.launches = 0
compress_q8.launches = 0
