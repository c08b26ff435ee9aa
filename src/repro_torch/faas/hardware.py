"""Client hardware resource profiles (paper IV-A3).

The paper's heterogeneous fleet: 130 clients at 1vCPU/2048MiB, 50 clients at
2vCPU/4096MiB, 20 clients on Nvidia P100s at 0.4 vGPU each. Training speed is
modeled as optimizer steps/second relative to the 1vCPU baseline, with
lognormal per-invocation noise (FaaS performance variability).

Speed ratios are calibrated from the paper's Fig. 3 (Shakespeare non-IID
client durations): GPU clients train roughly an order of magnitude faster
than 1vCPU clients; 2vCPU roughly 1.9x (sub-linear scaling).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    speed: float          # steps/sec multiplier vs 1vCPU baseline
    vcpus: float
    mem_gib: float
    is_gpu: bool = False
    gpu_fraction: float = 0.0
    variability: float = 0.10  # lognormal sigma of per-invocation speed noise


HARDWARE_PROFILES: dict[str, HardwareProfile] = {
    "cpu1": HardwareProfile("cpu1", speed=1.0, vcpus=1.0, mem_gib=2.0),
    "cpu2": HardwareProfile("cpu2", speed=1.9, vcpus=2.0, mem_gib=4.0),
    "gpu": HardwareProfile("gpu", speed=12.0, vcpus=2.0, mem_gib=4.0,
                           is_gpu=True, gpu_fraction=0.4, variability=0.05),
}


def paper_fleet(n_clients: int = 200, rng: np.random.Generator | None = None,
                mix: tuple[tuple[str, float], ...] = (("cpu1", 0.65),
                                                      ("cpu2", 0.25),
                                                      ("gpu", 0.10))):
    """The paper's 130/50/20 split (fractions of n_clients), shuffled."""
    rng = rng or np.random.default_rng(0)
    profiles: list[HardwareProfile] = []
    for name, frac in mix:
        profiles += [HARDWARE_PROFILES[name]] * round(n_clients * frac)
    while len(profiles) < n_clients:
        profiles.append(HARDWARE_PROFILES[mix[0][0]])
    profiles = profiles[:n_clients]
    rng.shuffle(profiles)
    return profiles


def homogeneous_fleet(n_clients: int, profile: str = "cpu2"):
    return [HARDWARE_PROFILES[profile]] * n_clients
