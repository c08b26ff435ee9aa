"""Carry params between the reference and the port through numpy.

``params_from_numpy`` takes a (nested) dict of arrays, e.g. the reference's
params after ``jax.tree.map(np.asarray, ...)``, and returns the same dict of
torch tensors on ``device``; ``params_to_numpy`` is the inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import tree_map


def params_from_numpy(tree, device):
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(params):
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
