"""Device resolution for the port's entry points.

The default is the CUDA card. Without one the resolver raises instead of
falling back: a run that silently lands on the CPU would report CPU times
under the card's name. Tests and CPU-only callers pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

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
