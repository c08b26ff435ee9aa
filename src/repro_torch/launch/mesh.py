"""Production mesh construction (twin of ``repro.launch.mesh``).

A function, never a module-level constant. The production target is the
reference's: 256 devices as a (data=16, model=16) mesh; the multi-pod
variant adds a leading ``pod`` axis (2 pods = 512 devices), which the FL
mapping treats as the cohort axis. The port's meshes are abstract (axis
names and sizes, no devices: ``sharding.rules.AbstractMesh``): the rules
derive specs from them, and the one card runs a cell on the ``1x1`` mesh.
"""
from __future__ import annotations

from repro_torch.sharding.rules import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_card_mesh() -> AbstractMesh:
    """The one card's mesh, ``1x1``: where a cell is executed."""
    return AbstractMesh((1, 1), ("data", "model"))


def _debug_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Largest valid (data, model) factorization of ``n_devices``.

    Prefers the widest model axis that divides n (4, then 3, then 2) and
    falls back to ``(n, 1)`` for primes and n < 2, so every positive
    device count yields a mesh covering exactly n devices. The old
    ``(n // 4, 4)`` arithmetic built a wrong-size mesh for n not
    divisible by 4 and an invalid zero-extent one for n < 4.
    """
    n = max(int(n_devices), 1)
    for model in (4, 3, 2):
        if n >= model and n % model == 0:
            return (n // model, model)
    return (n, 1)


def make_debug_mesh(n_devices: int = 8) -> AbstractMesh:
    """Small mesh for unit tests."""
    return AbstractMesh(_debug_mesh_shape(n_devices), ("data", "model"))


# Roofline denominators, kept under the reference's names so that
# ``roofline.py`` reads the same; the figures are the NVIDIA H100 SXM's
# data sheet: dense bf16 tensor rate, HBM3 rate, and NVLink 4 (900 GB/s
# aggregate, 450 GB/s each way).
PEAK_FLOPS_BF16 = 989e12      # per card
HBM_BW = 3.35e12              # bytes/s per card
ICI_BW = 450e9                # bytes/s per card, each way
