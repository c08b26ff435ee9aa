"""Staleness weighting functions (paper §III-B, Eq. 1 and Eq. 2).

``t_i`` is the round a client's local model was trained against; ``T`` is the
round being aggregated. Eq. 1 (FedLesScan) scales by t_i/T, which makes the
weight of one-round-late updates *grow* with T and is inconsistent along
equal-staleness diagonals (paper Fig. 2a). Eq. 2 (adopted from FedAsync)
depends only on the staleness T - t_i, so Apodotiko uses it.
"""
from __future__ import annotations

import numpy as np


def eq1_fedlesscan(t_i: float, T: float) -> float:
    if T <= 0:
        return 1.0
    return float(t_i) / float(T)


def eq2_apodotiko(t_i: float, T: float) -> float:
    staleness = max(float(T) - float(t_i), 0.0)
    return float(1.0 / np.sqrt(staleness + 1.0))


STALENESS_FNS = {"eq1": eq1_fedlesscan, "eq2": eq2_apodotiko}
