"""Fused cohort Adam step: wrapper around ``csrc/fused_adam.cu``.

``fused_adam(p, m, v, g, steps, s, ...)`` updates the stacked ``[Kp, W]``
fp32 params and moments in place; lanes with ``s >= steps[lane]`` are left
untouched (their local training has ended). A CPU tensor takes the plain
torch version (``ref.fused_adam``); a CUDA tensor launches the kernel or
raises; a ``meta`` tensor runs nothing and reports the kernel's traffic
(p, m, v, g and steps read, p, m and v written: 28 B a param) to
``_build.meta_launch``. ``fused_adam.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

VEC = 4          # the kernel moves float4: W is a multiple of 4
MAX_LANES = 65535  # grid.y bound


def fused_adam(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, steps: torch.Tensor, s: int, *, lr: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """In-place Adam step ``t = s + 1`` on every lane with ``steps > s``.
    p, m, v, g: [Kp, W] fp32 contiguous; steps: [Kp] int32."""
    if p.dim() != 2 or any(t.shape != p.shape for t in (m, v, g)):
        raise ValueError("p, m, v and g must share one [Kp, W] shape")
    Kp, W = p.shape
    if steps.shape != (Kp,) or steps.dtype != torch.int32:
        raise ValueError(f"steps must be int32 [{Kp}], got {steps.dtype} "
                         f"{tuple(steps.shape)}")
    if p.device.type == "cpu":
        return ref.fused_adam(p, m, v, g, steps, s, lr=lr, b1=b1, b2=b2,
                              eps=eps)
    if p.device.type == "meta":
        return _build.meta_launch("fused_adam", _build.nbytes(p, m, v, g,
                                                              steps),
                                  _build.nbytes(p, m, v))
    tensors = (p, m, v, g, steps)
    if any(t.device != p.device for t in tensors):
        raise ValueError("fused_adam takes tensors on one device")
    if any(t.dtype != torch.float32 for t in (p, m, v, g)):
        raise TypeError("fused_adam takes fp32 p, m, v and g")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_adam takes contiguous tensors")
    if W % VEC or any(t.data_ptr() % 16 for t in (p, m, v, g)):
        raise ValueError(f"W={W} must be a multiple of {VEC} and every "
                         "buffer 16-byte aligned")
    if Kp > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} lanes, got {Kp}")
    bc1, bc2 = ref.bias_corrections(s + 1, b1, b2)
    fn = _build.function(
        "fused_adam", "fused_adam_f32", ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_int32, ctypes.c_int64,
                                 ctypes.c_int64]
        + [ctypes.c_float] * 8 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            steps.data_ptr(), int(s), Kp, W, lr, b1, 1.0 - b1, b2, 1.0 - b2,
            eps, bc1, bc2, stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam launch failed: CUDA error {rc}")
    fused_adam.launches += 1


fused_adam.launches = 0
