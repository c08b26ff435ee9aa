"""Probabilistic client selection (paper §III-D, Algorithm 3).

1. Split clients into uninvoked vs invoked; drop busy clients.
2. While uninvoked clients remain, sample the round uniformly from them
   (bootstraps the scoring data).
3. Otherwise compute every available client's weighted score (Algorithm 2),
   normalize to probabilities, and sample without replacement.
4. Booster bookkeeping: reset to 1 for selected clients; multiply by the
   promotion rate (1 + rho) for available-but-unselected clients.

Two implementations, dispatched by the database's control plane
(DESIGN.md §10): the original per-``ClientRecord`` Python loop (the
object-plane oracle, kept verbatim below) and a vectorized columnar twin
over ``FleetStore`` arrays. Both are **bit-identical**: the columnar path
builds the same candidate lists in the same (registration) order, computes
the same f64 scores (``scoring.calculate_scores`` replays the scalar
loop's operation order), and feeds the identical probability vector to the
identical ``rng.choice`` calls — so the two planes consume the same RNG
stream and return the same selections (tests/test_control_plane.py).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.database import ClientRecord, Database
from repro_torch.core.scoring import calculate_score, decay_rate, promotion_rate


def select_clients(
    db: Database,
    clients_per_round: int,
    rng: np.random.Generator,
    adjustment_rate: float = 0.2,
    history_window: int = 10,
) -> list[int]:
    if db.columnar:
        return _select_clients_columnar(db, clients_per_round, rng,
                                        adjustment_rate, history_window)
    clients = list(db.clients.values())
    # "available" = idle and not quarantined by the recovery layer's
    # circuit breaker (quarantined_until defaults to 0, so the mask is
    # the plain idle mask whenever recovery is off)
    avail = [c for c in clients
             if c.status == "idle" and c.quarantined_until <= db.round]
    uninvoked = [c for c in avail if not c.ever_invoked]
    invoked = [c for c in avail if c.ever_invoked]

    # Lines 4-6: prioritize uninvoked clients to gather scoring data.
    if len(uninvoked) >= clients_per_round:
        picks = rng.choice(len(uninvoked), size=clients_per_round, replace=False)
        selection = [uninvoked[i].client_id for i in picks]
        _update_boosters(db, selection, adjustment_rate)
        return selection

    selection = [c.client_id for c in uninvoked]
    need = clients_per_round - len(selection)
    need = min(need, len(invoked))
    if need > 0:
        lam = decay_rate(adjustment_rate)
        scores = np.array([
            calculate_score(
                c.booster,
                list(reversed(c.durations[-history_window:])),  # newest first
                c.data_cardinality, c.local_epochs, c.batch_size, lam)
            for c in invoked
        ], dtype=np.float64)
        # Line 12: normalize scores into probabilities.
        smax = scores.max() if len(scores) else 0.0
        if smax <= 0:
            probs = np.full(len(invoked), 1.0 / len(invoked))
        else:
            norm = scores / smax                    # scale to (0, 1]
            probs = norm / norm.sum()
        # zero-score clients (every invocation failed, so no duration
        # history) carry probability 0 — sampling without replacement
        # cannot draw more than the nonzero-probability count
        need = min(need, int(np.count_nonzero(probs)))
        if need > 0:
            picks = rng.choice(len(invoked), size=need, replace=False,
                               p=probs)
            selection += [invoked[i].client_id for i in picks]

    _update_boosters(db, selection, adjustment_rate)
    return selection


def _update_boosters(db: Database, selection: Sequence[int],
                     adjustment_rate: float) -> None:
    """Lines 14-15: reset selected boosters, promote available-unselected."""
    beta = promotion_rate(adjustment_rate)
    chosen = set(selection)
    for c in db.clients.values():
        if c.client_id in chosen:
            c.booster = 1.0
        elif c.status == "idle" and c.quarantined_until <= db.round:
            c.booster *= beta


# --------------------------------------------------------- columnar twin


def _select_clients_columnar(
    db: Database,
    clients_per_round: int,
    rng: np.random.Generator,
    adjustment_rate: float = 0.2,
    history_window: int = 10,
) -> list[int]:
    """Algorithm 3 over FleetStore columns — one vectorized scoring pass
    instead of an O(M) Python loop, bit-identical draws (module docstring)."""
    fleet = db.fleet
    order = fleet.ordered_slots()
    idle = ((fleet.status[order] == 0)
            & (fleet.quarantined_until[order] <= db.round))
    ever = fleet.n_invocations[order] > 0
    unv = order[idle & ~ever]
    inv = order[idle & ever]

    # Lines 4-6: prioritize uninvoked clients to gather scoring data.
    if len(unv) >= clients_per_round:
        picks = rng.choice(len(unv), size=clients_per_round, replace=False)
        selection = fleet.ids[unv[picks]].tolist()
        _update_boosters_columnar(db, selection, adjustment_rate)
        return selection

    selection = fleet.ids[unv].tolist()
    need = clients_per_round - len(selection)
    need = min(need, len(inv))
    if need > 0:
        lam = decay_rate(adjustment_rate)
        scores = fleet.window_scores(inv, history_window, lam)
        # Line 12: normalize scores into probabilities.
        smax = scores.max() if len(scores) else 0.0
        if smax <= 0:
            probs = np.full(len(inv), 1.0 / len(inv))
        else:
            norm = scores / smax                    # scale to (0, 1]
            probs = norm / norm.sum()
        # zero-score clients cap the draw, mirroring the object plane
        need = min(need, int(np.count_nonzero(probs)))
        if need > 0:
            picks = rng.choice(len(inv), size=need, replace=False, p=probs)
            selection += fleet.ids[inv[picks]].tolist()

    _update_boosters_columnar(db, selection, adjustment_rate)
    return selection


def _update_boosters_columnar(db: Database, selection: Sequence[int],
                              adjustment_rate: float) -> None:
    """Vectorized booster bookkeeping: same per-element f64 ops as the
    object-plane loop (set 1.0 / one multiply), so boosters stay bit-equal
    across planes round after round."""
    fleet = db.fleet
    beta = promotion_rate(adjustment_rate)
    chosen = np.array([fleet.slot_of(c) for c in selection], np.int64)
    idle = (fleet.active & (fleet.status == 0)
            & (fleet.quarantined_until <= db.round))
    if len(chosen):
        idle[chosen] = False
        fleet.booster[chosen] = 1.0
    fleet.booster[idle] *= beta
