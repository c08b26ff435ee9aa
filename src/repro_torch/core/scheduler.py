"""The event-driven engine of the reference (``repro.core.scheduler``):
not ported yet. Both entry points raise, naming the slice that brings them.
"""
from __future__ import annotations

_NEXT = ("comes with the next slice of the port (Scheduler + build_engine + "
         "apodotiko-topk with the block_topk kernel); use "
         "repro_torch.core.controller.Controller")


class Scheduler:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"the Scheduler engine {_NEXT}")


def build_engine(*args, **kwargs):
    raise NotImplementedError(f"build_engine {_NEXT}")
