"""Production SLO metrics (DESIGN.md §13).

The paper's headline numbers are speedup ratios on closed-loop runs;
under open-loop traffic the operative questions are the ones a service
owner asks: tail round latency, cold-start rate, dollars per round, and
time-to-accuracy *under load*. These are pure functions over the
round history / platform counters already collected by ``FLRuntime``,
surfaced uniformly in ``metrics()`` and the sweep result tables.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["round_latencies", "slo_summary"]


def round_latencies(history: Sequence) -> np.ndarray:
    """Per-round wall latency (simulated seconds) from RoundLog entries."""
    return np.asarray([log.t_end - log.t_start for log in history], float)


def slo_summary(history: Sequence, cold_start_ratio: float,
                total_cost_usd: float,
                time_to_accuracy: Optional[float] = None) -> dict:
    """The SLO block merged into ``FLRuntime.metrics()``: p50/p99 round
    latency, cold-start rate, cost-per-round, and (when a target accuracy
    is configured) time-to-accuracy under load."""
    lat = round_latencies(history)
    p50 = float(np.percentile(lat, 50)) if len(lat) else 0.0
    p99 = float(np.percentile(lat, 99)) if len(lat) else 0.0
    return {
        "p50_round_latency_s": p50,
        "p99_round_latency_s": p99,
        "cold_start_rate": float(cold_start_ratio),
        "cost_per_round_usd": float(total_cost_usd) / max(len(history), 1),
        "time_to_accuracy_s": time_to_accuracy,
    }
