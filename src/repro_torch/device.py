"""Device resolution and precision for the port's entry points.

The default is the CUDA card. Without one the resolver raises instead of
falling back: a run that silently lands on the CPU would report CPU times
under the card's name. Tests and CPU-only callers pass ``device="cpu"``.

``fp32_exact`` holds fp32 on the card where the reference computes in
fp32: torch lets cuDNN run convolutions in TF32 by default, which would
round every product's inputs to 10 mantissa bits.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; any CUDA device must exist; ``cpu`` is taken
    only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r} (expected cuda or cpu)")
    return dev


_TF32_LOCK = threading.Lock()
_TF32_DEPTH = 0
_TF32_SAVED: tuple = ()


@contextlib.contextmanager
def fp32_exact() -> Iterator[None]:
    """Turn TF32 off for convolutions and matmuls for the scope
    (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``; no other flag is touched).
    The flags are process-global and sweep cells train on several threads,
    so the scope is reference-counted under a lock: the first entry saves
    the caller's values and sets both False, the last exit restores them,
    and no thread turns TF32 back on while another is inside."""
    global _TF32_DEPTH, _TF32_SAVED
    with _TF32_LOCK:
        if _TF32_DEPTH == 0:
            _TF32_SAVED = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _TF32_DEPTH += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_DEPTH -= 1
            if _TF32_DEPTH == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _TF32_SAVED
