"""Bench-scale proxy client model (twin of ``repro.models.proxy_models``).

``ProxyCNN`` keeps the paper models' API on 8x8x1 inputs at ~100x less
compute; the port's CPU tests run on it. ``ProxyLSTM`` comes with a later
slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamFactory
from repro_torch.models.paper_models import (_ClassifierBase, _apply_conv,
                                             _conv, _flatten_nhwc, _maxpool,
                                             build_paper_model)


class ProxyCNN(_ClassifierBase):
    """Small 2-conv CNN on 8x8x1 inputs."""

    def __init__(self, n_classes: int, c1: int = 8, c2: int = 16, fc: int = 32):
        self.n_classes = n_classes
        self.input_shape = (8, 8, 1)
        self.c1, self.c2, self.fc = c1, c2, fc

    def init(self, generator: torch.Generator) -> dict:
        pf = ParamFactory(generator)
        _conv(pf, "c1", 3, 1, self.c1)
        _conv(pf, "c2", 3, self.c1, self.c2)
        pf.param("fc1_w", (2 * 2 * self.c2, self.fc))
        pf.param("fc1_b", (self.fc,), init="zeros")
        pf.param("fc2_w", (self.fc, self.n_classes))
        pf.param("fc2_b", (self.n_classes,), init="zeros")
        return pf.params

    def predict(self, p, x):
        x = x.permute(0, 3, 1, 2)
        x = _maxpool(F.relu(_apply_conv(p, "c1", x, "SAME")))   # 8->4
        x = _maxpool(F.relu(_apply_conv(p, "c2", x, "SAME")))   # 4->2
        x = _flatten_nhwc(x)
        x = F.relu(x @ p["fc1_w"] + p["fc1_b"])
        return x @ p["fc2_w"] + p["fc2_b"]


def build_bench_model(dataset: str, fidelity: str = "proxy"):
    """Model for a (paper) dataset at the requested fidelity."""
    if fidelity == "paper":
        return build_paper_model(f"paper-{dataset}")
    if dataset == "shakespeare":
        raise NotImplementedError(
            "ProxyLSTM comes with a later slice of the port")
    n_classes = {"mnist": 10, "femnist": 62, "speech": 35}
    return ProxyCNN(n_classes[dataset])
