"""The paper's four client models (IV-A2; twin of
``repro.models.paper_models``):

  - MNIST 2-layer CNN (valid padding, fc 512, 10 classes)  -> 582,026 params
  - FEMNIST 2-layer CNN (same padding, fc 2048, 62 classes) -> 6,603,710
  - Shakespeare: embed(82->8) + 2x LSTM(256) + dense(82)    -> 818,402
  - Google Speech: 2 conv blocks (32/64 ch) + avgpool + 35  -> 67,267

Params keep the reference's names and layouts (conv weights HWIO; LSTM
weights ``wx [din, 4H]``, ``wh [H, 4H]`` and one bias, gates in the order
i, f, g, o), and image inputs stay NHWC at the public interface, so update
rows and checkpoints compare element-wise with the reference. ``predict``
permutes to torch's NCHW/OIHW inside, and back to NHWC before flattening
into ``fc1``: the reference flattens NHWC, and flattening NCHW instead
would scramble the ``fc1`` rows while every shape still matched.

The LSTM recurrence is written out step by step (``_lstm``), not as
``nn.LSTM``, whose fused weight layout and two biases are not the
reference's; its input products for all steps are one product.
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


class FemnistCNN(_ClassifierBase):
    """28x28x1, conv5x5(32) SAME + pool, conv5x5(64) SAME + pool, fc2048, 62
    (6,603,710 params)."""

    n_classes = 62
    input_shape = (28, 28, 1)

    def init(self, generator: torch.Generator) -> dict:
        pf = ParamFactory(generator)
        _conv(pf, "c1", 5, 1, 32)
        _conv(pf, "c2", 5, 32, 64)
        pf.param("fc1_w", (7 * 7 * 64, 2048))
        pf.param("fc1_b", (2048,), init="zeros")
        pf.param("fc2_w", (2048, 62))
        pf.param("fc2_b", (62,), init="zeros")
        return pf.params

    def predict(self, p, x):
        x = x.permute(0, 3, 1, 2)                                    # NHWC->NCHW
        x = _maxpool(F.relu(_apply_conv(p, "c1", x, "SAME")))        # 28->14
        x = _maxpool(F.relu(_apply_conv(p, "c2", x, "SAME")))        # 14->7
        x = _flatten_nhwc(x)
        x = F.relu(x @ p["fc1_w"] + p["fc1_b"])
        return x @ p["fc2_w"] + p["fc2_b"]


class SpeechCNN(_ClassifierBase):
    """32x32x1 spectrogram, 2 blocks of (conv3x3, conv3x3, pool), global
    average pool, 35 classes (67,267 params). The reference's docstring
    names dropout, but its ``predict`` has none, and neither has this."""

    n_classes = 35
    input_shape = (32, 32, 1)

    def init(self, generator: torch.Generator) -> dict:
        pf = ParamFactory(generator)
        _conv(pf, "c1", 3, 1, 32)
        _conv(pf, "c2", 3, 32, 32)
        _conv(pf, "c3", 3, 32, 64)
        _conv(pf, "c4", 3, 64, 64)
        pf.param("fc_w", (64, 35))
        pf.param("fc_b", (35,), init="zeros")
        return pf.params

    def predict(self, p, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_apply_conv(p, "c1", x, "SAME"))
        x = _maxpool(F.relu(_apply_conv(p, "c2", x, "SAME")))        # 32->16
        x = F.relu(_apply_conv(p, "c3", x, "SAME"))
        x = _maxpool(F.relu(_apply_conv(p, "c4", x, "SAME")))        # 16->8
        x = torch.mean(x, dim=(2, 3))                                # GAP -> 64
        return x @ p["fc_w"] + p["fc_b"]


def _embed(table, x):
    """Token ids [B, S] (any integer type) -> [S, B, emb]. ``F.embedding``
    batches under ``torch.func.vmap`` with per-lane tables."""
    return F.embedding(x.long(), table).transpose(0, 1)


def _lstm(wx, wh, b, xs):
    """One LSTM layer over xs [S, B, din] from zero state -> hs [S, B, H].
    Each step's gates are ``x @ wx + h @ wh + b`` as the reference sums
    them, with every step's ``x @ wx`` taken in one product up front."""
    S, B = xs.shape[0], xs.shape[1]
    hidden = wh.shape[0]
    xw = xs @ wx
    h = xs.new_zeros((B, hidden))
    c = xs.new_zeros((B, hidden))
    hs = []
    for t in range(S):
        gates = xw[t] + h @ wh + b
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


class ShakespeareLSTM(_ClassifierBase):
    """Next-char model: embed(82->8), 2x LSTM(256), dense(82) (818,402
    params). Input [B, 80] integer token ids."""

    n_classes = 82
    vocab = 82
    seq_len = 80

    def init(self, generator: torch.Generator) -> dict:
        pf = ParamFactory(generator)
        pf.param("embed", (self.vocab, 8), init="embed")
        for name, din in (("lstm1", 8), ("lstm2", 256)):
            pf.param(f"{name}_wx", (din, 4 * 256))
            pf.param(f"{name}_wh", (256, 4 * 256))
            pf.param(f"{name}_b", (4 * 256,), init="zeros")
        pf.param("out_w", (256, self.vocab))
        pf.param("out_b", (self.vocab,), init="zeros")
        return pf.params

    def predict(self, p, x):
        """x: [B, 80] token ids -> logits [B, 82] (next char)."""
        h = _embed(p["embed"], x)                                    # [S, B, 8]
        for name in ("lstm1", "lstm2"):
            h = _lstm(p[f"{name}_wx"], p[f"{name}_wh"], p[f"{name}_b"], h)
        return h[-1] @ p["out_w"] + p["out_b"]


PAPER_MODELS = {
    "paper-mnist": MnistCNN,
    "paper-femnist": FemnistCNN,
    "paper-shakespeare": ShakespeareLSTM,
    "paper-speech": SpeechCNN,
}


def build_paper_model(name: str):
    return PAPER_MODELS[name]()
