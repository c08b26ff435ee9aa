"""Carry params between the reference and the port through numpy.

``params_from_numpy`` takes a tree of arrays (nested dicts and lists, as
the decoder LM's ``params["layers"]["first"]``), e.g. the reference's
params after ``jax.tree.map(np.asarray, ...)``, and returns the same tree
of torch tensors on ``device``; ``params_to_numpy`` is the inverse. numpy
has no bfloat16 of its own: a bfloat16 array (``ml_dtypes``, as jax hands
it out) crosses as its 16-bit pattern, and a bfloat16 tensor comes back as
float32, which holds it exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import tree_map


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def params_from_numpy(tree, device):
    return tree_map(lambda a: _tensor(a).to(device), tree)


def params_to_numpy(params):
    return tree_map(lambda t: (t.detach().float() if t.dtype == torch.bfloat16
                               else t.detach()).cpu().numpy(), params)
