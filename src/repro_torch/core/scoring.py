"""Client Efficiency Scoring (paper §III-C, Algorithm 2).

Five attributes are collected per training round: training duration, local
data cardinality N_c, batch size B, local epochs E, and the booster value
beta. The Client Efficiency Score (CEF) uses measured training throughput as
an implicit hardware benchmark:

    #updates            = N_c * E / B                    (optimizer steps)
    per-round score_i   = N_c * (#updates / T_i)         (data-weighted throughput)
    weighted_sum        = sum_i lambda^i * score_i       (i=0 most recent)
    score               = beta * weighted_sum / sum_i lambda^i

with decay rate lambda = 1 - rho and promotion rate 1 + rho (rho = 0.2 by
default, paper §III-C).

Three evaluation strategies of the same formula live here (DESIGN.md §10):

* ``calculate_score`` — the original per-client Python loop over a duration
  history. Kept verbatim as the *object-plane oracle*: the columnar control
  plane must reproduce its scores bit-for-bit.
* ``calculate_scores`` — the columnar twin: one vectorized pass over
  ``[M, W]`` duration windows that replays the oracle's exact operation
  order (same associativity, same scalar decay-weight sequence), so every
  element is bit-identical to the per-client loop. This is what
  ``FleetStore``-backed selection dispatches.
* ``ema_push`` / ``ema_score`` — O(1) *incremental* EMA state. The loop
  recomputes the weighted sum from the full history on every selection
  (O(history) per client per round); pushing each new duration into
  ``(num, den)`` instead keeps scoring O(1) per result. Mathematically
  identical to the full recompute over the complete history (Horner vs
  direct evaluation — property-tested in tests/test_properties.py), it is
  the score state behind the device-resident top-k selection path.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# Duration history window: how many most-recent training durations feed the
# windowed score (Algorithm 3 uses the last 10) and therefore how many the
# columnar plane's ring buffers retain per client. Every consumer of
# per-client duration history (selection window 10, FedLesScan clustering
# and hedge ranking over the last 5) fits inside it.
HISTORY_WINDOW = 10


def n_updates(data_cardinality: int, epochs: int, batch_size: int) -> float:
    """Algorithm 2 line 2: number of local optimizer updates."""
    return data_cardinality * epochs / max(batch_size, 1)


def calculate_score(
    booster: float,
    durations: Sequence[float],
    data_cardinality: int,
    epochs: int,
    batch_size: int,
    decay: float,
) -> float:
    """Algorithm 2. ``durations`` is ordered most-recent-first (i=0 newest).

    Returns beta * (sum_i decay^i * N_c * #updates / T_i) / (sum_i decay^i).
    """
    if not durations:
        return 0.0
    upd = n_updates(data_cardinality, epochs, batch_size)
    weighted_sum = 0.0
    norm = 0.0
    w = 1.0
    for t in durations:
        weighted_sum += w * data_cardinality * (upd / max(t, 1e-9))
        norm += w
        w *= decay
    return booster * weighted_sum / norm


def window_accumulate(durations: Sequence[float], data_cardinality: int,
                      epochs: int, batch_size: int,
                      decay: float) -> Tuple[float, float]:
    """One client's windowed CEF terms ``(weighted_sum, norm)`` — the
    exact accumulation loop of ``calculate_score`` without the final
    booster scaling. ``durations`` is most-recent-first. This is the O(W)
    per-result refresh behind the columnar plane's cached window terms:
    selection then reads ``booster * weighted_sum / norm`` with three
    vector ops instead of re-walking every client's history."""
    upd = n_updates(data_cardinality, epochs, batch_size)
    weighted_sum = 0.0
    norm = 0.0
    w = 1.0
    for t in durations:
        weighted_sum += w * data_cardinality * (upd / max(t, 1e-9))
        norm += w
        w *= decay
    return weighted_sum, norm


def calculate_scores(booster, durations, lengths, cardinality, epochs,
                     batch_size, decay: float) -> np.ndarray:
    """Vectorized Algorithm 2 over ``M`` clients at once.

    ``durations`` is ``[M, W]`` float64 ordered most-recent-FIRST along the
    window axis, with ``lengths[m]`` valid entries per row; ``booster``,
    ``cardinality``, ``epochs``, ``batch_size`` are ``[M]`` columns.

    Bit-identical to ``calculate_score`` applied per client: the window
    loop below replays the scalar loop's exact operation order — the decay
    weight ``w`` is the same Python-float sequence, every elementwise f64
    op is the same IEEE-rounded op, and the associativity
    ``(w * N_c) * (upd / max(t, eps))`` / ``(beta * sum) / norm`` matches
    the scalar expression. Clients with empty histories score 0.0, like
    the scalar early-return.
    """
    lengths = np.asarray(lengths)
    weighted_sum, norm = window_terms(durations, lengths, cardinality,
                                      epochs, batch_size, decay)
    return scores_from_terms(booster, weighted_sum, norm, lengths)


def window_terms(durations, lengths, cardinality, epochs, batch_size,
                 decay: float) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``window_accumulate`` over ``[M, W]`` newest-first
    duration windows: ``(weighted_sum [M], norm [M])``, bit-identical per
    element to the scalar loop (see ``calculate_scores``)."""
    # [W, M] contiguous so each window step streams one cache-friendly row
    durs = np.ascontiguousarray(np.asarray(durations, np.float64).T)
    lengths = np.asarray(lengths)
    W, M = durs.shape
    card = np.asarray(cardinality, np.int64)
    upd = (card * np.asarray(epochs, np.int64)) \
        / np.maximum(np.asarray(batch_size, np.int64), 1)
    cardf = card.astype(np.float64)
    weighted_sum = np.zeros(M, np.float64)
    norm = np.zeros(M, np.float64)
    # preallocated scratch: the loop below runs allocation-free in-place
    # ufuncs replaying the scalar loop's op order exactly. Masking is a
    # multiply by the valid bool — exact for these terms (positive finite:
    # x*1.0 == x, x*0.0 == 0.0), unlike the general np.where contract.
    term = np.empty(M, np.float64)
    wc = np.empty(M, np.float64)
    valid = np.empty(M, np.float64)
    w = 1.0
    for i in range(W):
        np.multiply(lengths > i, 1.0, out=valid)
        np.maximum(durs[i], 1e-9, out=term)
        np.divide(upd, term, out=term)              # upd / max(t, 1e-9)
        np.multiply(cardf, w, out=wc)               # w * N_c
        np.multiply(wc, term, out=term)             # (w*N_c) * (upd/max)
        np.multiply(term, valid, out=term)
        weighted_sum += term
        np.multiply(valid, w, out=valid)
        norm += valid
        w = w * decay
    return weighted_sum, norm


def scores_from_terms(booster, weighted_sum, norm, lengths) -> np.ndarray:
    """``beta * weighted_sum / norm`` with the empty-history guard — the
    final step shared by the recompute path and the cached-terms path."""
    return np.where(
        np.asarray(lengths) > 0,
        (np.asarray(booster, np.float64) * np.asarray(weighted_sum))
        / np.where(np.asarray(norm) > 0, norm, 1.0),
        0.0)


def per_round_score(duration: float, data_cardinality: int, epochs: int,
                    batch_size: int) -> float:
    """One round's contribution to the CEF sum: N_c * #updates / T."""
    upd = n_updates(data_cardinality, epochs, batch_size)
    return data_cardinality * (upd / max(duration, 1e-9))


def ema_push(num: float, den: float, score: float,
             decay: float) -> Tuple[float, float]:
    """O(1) incremental EMA update on a new per-round ``score``.

    Maintains ``num = sum_i decay^i * s_i`` and ``den = sum_i decay^i``
    (i = 0 newest) without revisiting the history: the newest round enters
    with weight 1 and every older round's weight decays by one step."""
    return score + decay * num, 1.0 + decay * den


def ema_score(booster: float, num: float, den: float) -> float:
    """Score from incremental EMA state (0.0 before any result lands)."""
    if den <= 0:
        return 0.0
    return booster * num / den


def decay_rate(adjustment_rate: float) -> float:
    """lambda = 1 - rho."""
    return 1.0 - adjustment_rate


def promotion_rate(adjustment_rate: float) -> float:
    """beta multiplier = 1 + rho."""
    return 1.0 + adjustment_rate
