"""Device-resident data plane (twin of ``repro.core.data_plane``).

``DatasetStore`` uploads a ``FederatedDataset``'s padded per-client
training arrays ``X [M, N_max, ...]`` / ``y [M, N_max]`` to the card once;
the cohort trainer then gathers every minibatch out of these buffers by
client index, so no training input crosses the host link per round. The
reference's host plane (per-dispatch upload) comes with a later slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


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
