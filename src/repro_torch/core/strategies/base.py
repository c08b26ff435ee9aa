"""FL training strategies: Apodotiko + the five baselines the paper
evaluates against (FedAvg, FedProx, SCAFFOLD, FedLesScan, FedBuff).

A strategy decides (a) which clients to invoke each round, (b) when the
controller may aggregate (sync with timeout / semi-async / async with a
concurrency-or-buffer ratio), (c) the aggregation weights for each available
result (cardinality x staleness damping), and (d) client-side training
modifications (proximal term, control variates).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.database import Database, ResultRecord
from repro_torch.core.selection import select_clients as apodotiko_select
from repro_torch.core.staleness import eq1_fedlesscan, eq2_apodotiko


@dataclass
class StrategyConfig:
    """Strategy-facing slice of ``FLConfig`` (paper symbols noted inline)."""

    clients_per_round: int = 100   # clients invoked per round (paper: 100)
    concurrency_ratio: float = 0.3  # CR (Alg. 1 line 9): async strategies
    #                                  aggregate once ceil(CR x clientsPerRound)
    #                                  results land; doubles as FedBuff's
    #                                  buffer-size ratio. Fig. 6 sweeps it.
    adjustment_rate: float = 0.2   # rho (Alg. 3): booster adjustment step for
    #                                  the CEF-score probabilistic selection
    max_staleness: int = 5         # staleness cap (§III-B): accept results
    #                                  from at most this many previous rounds
    round_timeout: float = 300.0   # sync-strategy round deadline (sim-seconds)
    prox_mu: float = 0.01          # mu: FedProx proximal term coefficient
    staleness_fn: str = "eq2"      # "eq2" = 1/sqrt(T - t_i + 1) (Eq. 2) |
    #                                  "eq1" = t_i/T (Eq. 1, FedLesScan)
    hedge_fraction: float = 0.5    # apodotiko-hedge: fraction of outstanding
    #                                  invocations re-invoked at the CR gate
    quorum_fraction: float = 1.0   # graceful degradation (DESIGN.md §12):
    #                                  sync rounds close once this fraction
    #                                  of the cohort completed (1.0 = the
    #                                  legacy full-cohort gate, bit-exact)
    seed: int = 0                  # selection RNG seed


class Strategy:
    name = "base"
    is_async = False          # async aggregation (CR-triggered)
    semi_async = False        # FedLesScan: late updates used next round
    needs_scaffold = False
    prox_mu = 0.0

    def __init__(self, cfg: StrategyConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    # -- durability (coordinated snapshots, DESIGN.md §14) ---------------------
    def state_dict(self) -> dict:
        """The mutable strategy state a durable resume must restore: the
        selection RNG position plus ``cfg.concurrency_ratio`` (the one
        config field a policy mutates in place — apodotiko-adaptive)."""
        return {"rng": self.rng.bit_generator.state,
                "concurrency_ratio": self.cfg.concurrency_ratio}

    def load_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.cfg.concurrency_ratio = state["concurrency_ratio"]

    # -- selection ------------------------------------------------------------
    def select(self, db: Database, round_: int) -> list[int]:
        """Default: uniform random among idle clients (FedAvg/FedProx/etc.).
        ``idle_client_ids`` yields the identical registration-ordered list
        on both control planes, so the shared ``rng.choice`` draw keeps
        selections bit-identical across planes."""
        idle = db.idle_client_ids()
        n = min(self.cfg.clients_per_round, len(idle))
        picks = self.rng.choice(len(idle), size=n, replace=False)
        return [idle[i] for i in picks]

    # -- aggregation gating -----------------------------------------------------
    def results_needed(self) -> int:
        if self.is_async:
            return max(1, int(np.ceil(self.cfg.clients_per_round
                                      * self.cfg.concurrency_ratio)))
        return self.cfg.clients_per_round

    # -- aggregation weights ------------------------------------------------------
    def staleness(self, t_i: int, T: int) -> float:
        return 1.0  # sync strategies only see current-round results

    def result_weight(self, rec: ResultRecord, T: int) -> float:
        return self.staleness(rec.round, T) * rec.n_samples

    def usable(self, rec: ResultRecord, T: int) -> bool:
        """May this un-aggregated result enter round T's aggregation?"""
        if self.is_async or self.semi_async:
            return T - rec.round <= self.cfg.max_staleness
        return rec.round == T


class FedAvg(Strategy):
    name = "fedavg"


class FedProx(Strategy):
    name = "fedprox"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.prox_mu = cfg.prox_mu


class Scaffold(Strategy):
    name = "scaffold"
    needs_scaffold = True

    def __init__(self, cfg):
        raise NotImplementedError(
            "SCAFFOLD (control-variate buffer and c_i update) comes with a "
            "later slice of the port")


class FedLesScan(Strategy):
    """Semi-asynchronous: clustering-based selection on past training
    durations + Eq. 1 staleness for late updates (the prior SoTA the paper
    improves on)."""

    name = "fedlesscan"
    semi_async = True

    def staleness(self, t_i: int, T: int) -> float:
        return eq1_fedlesscan(t_i, T)

    def select(self, db: Database, round_: int) -> list[int]:
        cfg = self.cfg
        if db.columnar:
            # vectorized twin: identical candidate order, identical means
            # (FleetStore.recent_mean replays np.mean's summation order),
            # identical rng.choice draws -> bit-identical tiers
            fleet = db.fleet
            idle = fleet.idle_slots(db.round)   # quarantine-aware
            ever = fleet.n_invocations[idle] > 0
            unv, inv = idle[~ever], idle[ever]
            if len(unv) >= cfg.clients_per_round:
                picks = self.rng.choice(len(unv), cfg.clients_per_round,
                                        replace=False)
                return fleet.ids[unv[picks]].tolist()
            selection = fleet.ids[unv].tolist()
            if not len(inv):
                return selection
            means = fleet.recent_mean(inv, 5)
            inv_ids = fleet.ids[inv].tolist()
        else:
            clients = list(db.clients.values())
            idle = [c for c in clients if c.status == "idle"
                    and c.quarantined_until <= db.round]
            uninvoked = [c for c in idle if not c.ever_invoked]
            if len(uninvoked) >= cfg.clients_per_round:
                picks = self.rng.choice(len(uninvoked), cfg.clients_per_round,
                                        replace=False)
                return [uninvoked[i].client_id for i in picks]
            selection = [c.client_id for c in uninvoked]
            invoked = [c for c in idle if c.ever_invoked]
            if not invoked:
                return selection
            # cluster invoked clients by mean duration (1-D k-means, k=3)
            means = np.array([np.mean(c.durations[-5:]) if c.durations else 0.0
                              for c in invoked])
            inv_ids = [c.client_id for c in invoked]
        order = np.argsort(means)
        k = 3 if len(inv_ids) >= 3 else 1
        clusters = np.array_split(order, k)  # duration-sorted tiers
        need = cfg.clients_per_round - len(selection)
        for cl in clusters:  # fastest tier first; stragglers fill remainder
            take = min(need, len(cl))
            picks = self.rng.choice(len(cl), take, replace=False)
            selection += [inv_ids[cl[i]] for i in picks]
            need -= take
            if need <= 0:
                break
        return selection


class FedBuff(Strategy):
    """Asynchronous buffered aggregation with *random* selection (the paper's
    closest async baseline; production at Meta). Selection is the base
    uniform-idle draw."""

    name = "fedbuff"
    is_async = True

    def staleness(self, t_i: int, T: int) -> float:
        return eq2_apodotiko(t_i, T)  # 1/sqrt(1+staleness), as in FedBuff


class Apodotiko(Strategy):
    """The paper's strategy: CEF scoring + probabilistic selection +
    CR-gated asynchronous aggregation with Eq. 2 staleness damping."""

    name = "apodotiko"
    is_async = True

    def staleness(self, t_i: int, T: int) -> float:
        if self.cfg.staleness_fn == "eq1":
            return eq1_fedlesscan(t_i, T)
        return eq2_apodotiko(t_i, T)

    def select(self, db: Database, round_: int) -> list[int]:
        return apodotiko_select(db, self.cfg.clients_per_round, self.rng,
                                adjustment_rate=self.cfg.adjustment_rate)


class ApodotikoTopK(Apodotiko):
    """The reference's Apodotiko with deterministic fleet-scale top-k
    selection over a device score state (``FleetStore.select_topk`` and the
    ``block_topk`` kernel). Not ported yet: building it raises."""

    name = "apodotiko-topk"

    def __init__(self, cfg):
        raise NotImplementedError(
            "apodotiko-topk comes with the next slice of the port "
            "(Scheduler + build_engine + block_topk)")


STRATEGIES = {
    s.name: s for s in (FedAvg, FedProx, Scaffold, FedLesScan, FedBuff,
                        Apodotiko, ApodotikoTopK)
}


# the reference's scheduler-only reactive policies (core/strategies/reactive.py)
REACTIVE_POLICIES = ("apodotiko-hedge", "apodotiko-adaptive")


def build_strategy(name: str, cfg: StrategyConfig) -> Strategy:
    if name in REACTIVE_POLICIES:
        raise NotImplementedError(
            f"reactive policy {name!r} needs the Scheduler engine, which "
            "comes with the next slice of the port")
    return STRATEGIES[name](cfg)
