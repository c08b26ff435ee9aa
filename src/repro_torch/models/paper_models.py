"""The paper's MNIST client model (twin of ``repro.models.paper_models``).

Params keep the reference's names and layouts (conv weights HWIO), and
inputs stay NHWC at the public interface, so update rows and checkpoints
compare element-wise with the reference. ``predict`` permutes to torch's
NCHW/OIHW inside, and back to NHWC before flattening into ``fc1``: the
reference flattens NHWC, and flattening NCHW instead would scramble the
``fc1`` rows while every shape still matched.

The other three paper models (FEMNIST, Speech, Shakespeare LSTM) come with
a later slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamFactory, softmax_cross_entropy


def _conv(pf: ParamFactory, name: str, k: int, cin: int, cout: int):
    pf.param(f"{name}_w", (k, k, cin, cout))
    pf.param(f"{name}_b", (cout,), init="zeros")


def _apply_conv(p, name, x, padding: str):
    """x NCHW; weight HWIO -> OIHW. SAME pads k//2 (odd kernels, stride 1,
    as XLA's SAME); VALID pads nothing."""
    w = p[f"{name}_w"]
    pad = w.shape[0] // 2 if padding == "SAME" else 0
    return F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype),
                    p[f"{name}_b"].to(x.dtype), padding=pad)


def _maxpool(x, k=2):
    return F.max_pool2d(x, k)


def _flatten_nhwc(x):
    """NCHW activations -> [B, H*W*C] in the reference's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _ClassifierBase:
    n_classes: int = 10

    def loss(self, params, batch):
        logits = self.predict(params, batch["x"])
        ce = softmax_cross_entropy(logits, batch["y"])
        acc = torch.mean((torch.argmax(logits, -1) == batch["y"]).to(torch.float32))
        return ce, {"ce": ce, "acc": acc}

    def accuracy(self, params, batch):
        logits = self.predict(params, batch["x"])
        return torch.mean((torch.argmax(logits, -1) == batch["y"]).to(torch.float32))


class MnistCNN(_ClassifierBase):
    """28x28x1, conv5x5(32) VALID + pool, conv5x5(64) VALID + pool, fc512, 10
    (582,026 params)."""

    n_classes = 10
    input_shape = (28, 28, 1)

    def init(self, generator: torch.Generator) -> dict:
        pf = ParamFactory(generator)
        _conv(pf, "c1", 5, 1, 32)
        _conv(pf, "c2", 5, 32, 64)
        pf.param("fc1_w", (4 * 4 * 64, 512))
        pf.param("fc1_b", (512,), init="zeros")
        pf.param("fc2_w", (512, 10))
        pf.param("fc2_b", (10,), init="zeros")
        return pf.params

    def predict(self, p, x):
        x = x.permute(0, 3, 1, 2)                                    # NHWC->NCHW
        x = _maxpool(F.relu(_apply_conv(p, "c1", x, "VALID")))       # 24->12
        x = _maxpool(F.relu(_apply_conv(p, "c2", x, "VALID")))       # 8->4
        x = _flatten_nhwc(x)
        x = F.relu(x @ p["fc1_w"] + p["fc1_b"])
        return x @ p["fc2_w"] + p["fc2_b"]


PAPER_MODELS = {"paper-mnist": MnistCNN}
LATER_PAPER_MODELS = ("paper-femnist", "paper-shakespeare", "paper-speech")


def build_paper_model(name: str):
    if name in LATER_PAPER_MODELS:
        raise NotImplementedError(
            f"{name} comes with a later slice of the port (only paper-mnist "
            "is ported)")
    return PAPER_MODELS[name]()
