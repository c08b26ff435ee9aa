"""Bench-scale proxy client models (twin of ``repro.models.proxy_models``).

The paper's exact models (``repro_torch.models.paper_models``) are what a
paper-width run trains; these proxies keep the same API and loss surface
and the non-IID learning dynamics at ~100x less compute, for the sweep's
proxy fidelity and the CPU tests: ``ProxyCNN`` on 8x8x1 inputs,
``ProxyLSTM`` on 20-character sequences.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamFactory
from repro_torch.models.paper_models import (_ClassifierBase, _apply_conv,
                                             _conv, _embed, _flatten_nhwc,
                                             _lstm, _maxpool,
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


class ProxyLSTM(_ClassifierBase):
    """Next-char model on short sequences: embed -> LSTM(h) -> dense(vocab)."""

    def __init__(self, vocab: int = 82, seq_len: int = 20, emb: int = 8,
                 hidden: int = 64):
        self.vocab = vocab
        self.n_classes = vocab
        self.seq_len = seq_len
        self.emb = emb
        self.hidden = hidden

    def init(self, generator: torch.Generator) -> dict:
        pf = ParamFactory(generator)
        pf.param("embed", (self.vocab, self.emb), init="embed")
        pf.param("wx", (self.emb, 4 * self.hidden))
        pf.param("wh", (self.hidden, 4 * self.hidden))
        pf.param("b", (4 * self.hidden,), init="zeros")
        pf.param("out_w", (self.hidden, self.vocab))
        pf.param("out_b", (self.vocab,), init="zeros")
        return pf.params

    def predict(self, p, x):
        h = _lstm(p["wx"], p["wh"], p["b"], _embed(p["embed"], x))[-1]
        return h @ p["out_w"] + p["out_b"]


def build_bench_model(dataset: str, fidelity: str = "proxy"):
    """Model for a (paper) dataset at the requested fidelity."""
    if fidelity == "paper":
        return build_paper_model(f"paper-{dataset}")
    n_classes = {"mnist": 10, "femnist": 62, "speech": 35}
    if dataset == "shakespeare":
        return ProxyLSTM(vocab=82, seq_len=20)
    return ProxyCNN(n_classes[dataset])
