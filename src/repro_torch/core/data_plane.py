"""Device-resident data plane (twin of ``repro.core.data_plane``).

``DatasetStore`` uploads a ``FederatedDataset``'s padded per-client
training arrays ``X [M, N_max, ...]`` / ``y [M, N_max]`` to the card once;
the cohort trainer then gathers every minibatch out of these buffers by
client index, so no training input crosses the host link per round.

``FLConfig.data_plane`` picks the plane (``resolve_data_plane``): "device"
(the default, also for "auto") is this store; "host" is the reference's
equivalence oracle, the cohort's arrays fancy-indexed on the host and
uploaded every dispatch (``CohortTrainer.train_cohort``). Both planes give
bit-identical runs: the device gather yields exactly the values the host
upload carries, into the same step loop.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def resolve_data_plane(mode: str) -> str:
    """'device' (= 'auto': resident buffers, gathered on the card) |
    'host' (per-dispatch upload, the equivalence oracle). Unlike the
    reference, no environment variable is read."""
    if mode in (None, "", "auto"):
        mode = "device"
    if mode not in ("device", "host"):
        raise ValueError(f"unknown data plane {mode!r} "
                         "(expected 'device', 'host', or 'auto')")
    return mode


class DatasetStore:
    """Resident ``X``/``y`` of one dataset on ``device``."""

    def __init__(self, data: Any, device=None):
        self.device = resolve_device(device)
        self.X = torch.as_tensor(np.asarray(data.X)).to(self.device)
        self.y = torch.as_tensor(np.asarray(data.y)).to(self.device).long()
        self.n_clients = int(self.X.shape[0])
        # one-time upload cost of residence (not per-round traffic)
        self.resident_bytes = int(self.X.numel() * self.X.element_size()
                                  + self.y.numel() * self.y.element_size())
