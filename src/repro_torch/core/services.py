"""Shared FL execution substrate: config, state and round services (twin
of ``repro.core.services``).

:class:`FLRuntime` owns the execution state (global params on the card,
database, simulated platform, event loop, update store, resident dataset)
and the three round services the poll loop calls:

  * **invocation** (``invoke_round``): cohort-vectorized Client_Update on
    the card, then simulated FaaS invocations whose completions land the
    trained rows as results;
  * **aggregation** (``aggregate_round``): staleness x cardinality weights
    (Eq. 2) over the update store's rows, stale pruning;
  * **evaluation** (``evaluate``).

This slice of the port runs the ``Controller`` poll loop with the device
update and data planes, on the ``object`` or ``columnar`` control plane.
Settings that need a later slice raise ``NotImplementedError`` naming it
(``_check_supported``): the ``Scheduler`` engine, megastep, its reactive
policies and recovery layer, the blob update plane and host data plane,
SCAFFOLD, ``apodotiko-topk``, fault and traffic profiles, durability and
checkpointing, and meshes other than ``1x1``. The reference's fields that
only tune one of those features (retry backoff, quarantine length, hedge
fraction, journal sync and snapshot cadence) are not fields here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import weighted_aggregate_rows
from repro_torch.core.client import CohortTrainer
from repro_torch.core.data_plane import DatasetStore
from repro_torch.core.database import ClientRecord, Database, ResultRecord
from repro_torch.core.scoring import decay_rate
from repro_torch.core.strategies.base import (Strategy, StrategyConfig,
                                              build_strategy)
from repro_torch.core.update_store import UpdateStore
from repro_torch.device import resolve_device
from repro_torch.faas.cost import CostModel
from repro_torch.faas.events import EventLoop
from repro_torch.faas.hardware import HardwareProfile
from repro_torch.faas.platform import FaaSPlatform, InvocationRecord
from repro_torch.kernels.ops import RavelSpec, tree_leaves, tree_map

Params = Any


def _resolve(value: str, default: str) -> str:
    return default if value in (None, "", "auto") else value


def _check_supported(cfg: "FLConfig") -> None:
    """Raise for every setting this slice of the port does not run."""
    later = "comes with a later slice of the port"
    scheduler = "needs the Scheduler engine, which " + later
    engine = _resolve(cfg.engine, "legacy")
    if engine == "scheduler":
        raise NotImplementedError(f"engine='scheduler' {later}")
    if engine != "legacy":
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if _resolve(cfg.megastep, "stepwise") != "stepwise":
        raise NotImplementedError(f"megastep={cfg.megastep!r} {scheduler}")
    for knob in ("invocation_timeout", "retry_budget", "quarantine_threshold"):
        if getattr(cfg, knob):
            raise NotImplementedError(f"recovery ({knob}) {scheduler}")
    if cfg.quorum_fraction < 1.0:
        raise NotImplementedError(f"quorum_fraction < 1 {scheduler}")
    if _resolve(cfg.update_plane, "device") != "device":
        raise NotImplementedError(f"update_plane={cfg.update_plane!r} {later}")
    if _resolve(cfg.data_plane, "device") != "device":
        raise NotImplementedError(f"data_plane={cfg.data_plane!r} {later}")
    if _resolve(cfg.control_plane, "columnar") not in ("columnar", "object"):
        raise ValueError(f"unknown control plane {cfg.control_plane!r}")
    if _resolve(cfg.mesh, "1x1") != "1x1":
        raise NotImplementedError(f"mesh={cfg.mesh!r} {later}")
    if _resolve(cfg.fault_profile, "off") not in ("off", "none"):
        raise NotImplementedError(f"fault_profile={cfg.fault_profile!r} {later}")
    if _resolve(cfg.traffic_profile, "off") not in ("off", "none"):
        raise NotImplementedError(
            f"traffic_profile={cfg.traffic_profile!r} {later}")
    if _resolve(cfg.durability, "off") != "off":
        raise NotImplementedError(f"durability={cfg.durability!r} {later}")
    if cfg.checkpoint_every and cfg.checkpoint_dir:
        raise NotImplementedError(f"checkpointing {later}")


@dataclass
class FLConfig:
    """Experiment configuration. Each field maps to a paper quantity
    (symbol / section noted inline) or a simulator knob.

    Paper defaults (IV-A): 200 clients, 100 per round, E=5 local epochs,
    batch 10 (MNIST), Adam 1e-3, CR=0.3, rho=0.2, staleness cap 5.

    The fields and their meaning are the reference's. In the port an
    ``"auto"`` value resolves to the default the comment names without
    reading any ``REPRO_*`` environment variable, and a value this slice
    does not run raises (``_check_supported``)."""

    # -- population & schedule -------------------------------------------------
    n_clients: int = 200           # total registered clients (paper IV-A3: 200)
    clients_per_round: int = 100   # |clients| invoked per round ("100/round")
    rounds: int = 50               # max global rounds T
    target_accuracy: Optional[float] = None  # early stop (Alg. 1 line 3)
    # -- Client_Update (Alg. 2) ------------------------------------------------
    local_epochs: int = 5          # E, local epochs per invocation
    batch_size: int = 10           # B, local minibatch size
    optimizer: str = "adam"        # client-side optimizer (paper: Adam/SGD)
    lr: float = 1e-3               # client learning rate eta
    # -- strategy (Alg. 1 / Alg. 3) --------------------------------------------
    strategy: str = "apodotiko"    # STRATEGIES key or a reactive policy name
    #                                 (repro.core.strategies.reactive)
    concurrency_ratio: float = 0.3  # CR: aggregate at ceil(CR x clientsPerRound)
    #                                 results (Alg. 1 line 9; Fig. 6 sweeps it)
    adjustment_rate: float = 0.2   # rho: booster step for the CEF score
    #                                 (Alg. 3; score = booster x CEF, §III-A)
    max_staleness: int = 5         # staleness cap: results from at most this
    #                                 many previous rounds aggregate (§III-B)
    round_timeout: float = 300.0   # sync-strategy round deadline, sim-seconds
    # -- FaaS platform simulation (§IV-A) --------------------------------------
    keep_warm: float = 600.0       # provider keep-warm window before
    #                                 scale-to-zero, sim-seconds
    cold_start_s: float = 8.0      # container cold-start penalty, sim-seconds
    base_step_time: float = 0.05   # 1vCPU-seconds per optimizer step
    #                                 (hardware profiles scale this, Fig. 1/3)
    failure_rate: float = 0.0      # P(invocation crash) — fault tolerance
    fault_profile: str = "auto"    # fault injection: "auto"/"off" only in
    #                                 this slice (no extra RNG draws)
    traffic_profile: str = "auto"  # open-loop traffic: "auto"/"off" only in
    #                                 this slice (fixed fleet)
    # -- recovery layer (Scheduler engine only): only "off" in this slice ------
    invocation_timeout: float = 0.0  # per-invocation kill timer (0 = off)
    retry_budget: int = 0          # max retries per round (0 = off)
    quarantine_threshold: int = 0  # circuit breaker after this many
    #                                 consecutive failures (0 = off)
    quorum_fraction: float = 1.0   # sync rounds aggregate once this cohort
    #                                 fraction completed (1.0 = full gate,
    #                                 the only value in this slice)
    # -- aggregation (§III-B) --------------------------------------------------
    prox_mu: float = 0.01          # mu, FedProx proximal coefficient
    staleness_fn: str = "eq2"      # "eq2" = 1/sqrt(T - t_i + 1) (Eq. 2,
    #                                 Apodotiko) | "eq1" = t_i/T (FedLesScan)
    update_plane: str = "auto"     # client-update transport: "device"
    #                                 (= "auto"): updates stay rows of one
    #                                 card-resident [capacity, W] buffer
    engine: str = "auto"           # round driver: "legacy" (= "auto"), the
    #                                 Controller poll loop; "scheduler" comes
    #                                 with a later slice
    control_plane: str = "auto"    # per-client fleet state: "columnar"
    #                                 (= "auto") struct-of-arrays columns, or
    #                                 "object", the per-client ClientRecord
    #                                 oracle; both are host numpy
    data_plane: str = "auto"       # training-input transport: "device"
    #                                 (= "auto"): the dataset stays resident
    #                                 on the card, minibatches gathered there
    megastep: str = "auto"         # fused rounds (Scheduler only): "stepwise"
    #                                 (= "auto") only in this slice
    durability: str = "auto"       # durable runs: "auto"/"off" only in this
    #                                 slice
    mesh: str = "auto"             # device mesh: "1x1" (= "auto") only in
    #                                 this slice
    # -- harness ---------------------------------------------------------------
    eval_every: int = 1            # evaluate global model every k rounds
    seed: int = 0                  # RNG seed: selection, init, platform noise
    max_sim_time: float = 1e8      # simulated wall-clock budget, seconds
    checkpoint_dir: Optional[str] = None  # database checkpoint location
    checkpoint_every: int = 0      # checkpoint every k rounds (0 = off)


def strategy_config(cfg: FLConfig) -> StrategyConfig:
    """The strategy-facing slice of ``FLConfig``."""
    return StrategyConfig(
        clients_per_round=cfg.clients_per_round,
        concurrency_ratio=cfg.concurrency_ratio,
        adjustment_rate=cfg.adjustment_rate,
        max_staleness=cfg.max_staleness,
        round_timeout=cfg.round_timeout,
        prox_mu=cfg.prox_mu,
        staleness_fn=cfg.staleness_fn,
        quorum_fraction=cfg.quorum_fraction,
        seed=cfg.seed)


@dataclass
class RoundLog:
    round: int
    t_start: float
    t_end: float
    accuracy: float
    n_aggregated: int
    n_stale: int
    mean_loss: float


class FLRuntime:
    """State + round services of the ``Controller`` poll loop (see module
    docstring). ``device`` defaults to the CUDA card."""

    engine_name = "runtime"

    def __init__(self, cfg: FLConfig, model, data, fleet: list[HardwareProfile],
                 *, init_params: Optional[Params] = None,
                 strategy: Optional[Strategy] = None, device=None):
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.data = data        # FederatedDataset (repro_torch.data)
        self.fleet = fleet
        self.loop = EventLoop()
        self.fault_profile = "off"
        self.platform = FaaSPlatform(
            keep_warm=cfg.keep_warm, cold_start_s=cfg.cold_start_s,
            seed=cfg.seed, failure_rate=cfg.failure_rate)
        self.cost_model = CostModel()
        self.strategy: Strategy = (
            strategy if strategy is not None
            else build_strategy(cfg.strategy, strategy_config(cfg)))
        self.mesh_spec = "1x1"
        self.trainer = CohortTrainer(
            model, optimizer=cfg.optimizer, lr=cfg.lr,
            batch_size=cfg.batch_size, prox_mu=self.strategy.prox_mu,
            scaffold=self.strategy.needs_scaffold, seed=cfg.seed,
            device=self.device)

        self.control_plane = _resolve(cfg.control_plane, "columnar")
        self.db = Database(control_plane=self.control_plane)
        if self.db.columnar:
            self.db.fleet.decay = decay_rate(cfg.adjustment_rate)
        for cid in range(cfg.n_clients):
            self.db.register_client(ClientRecord(
                client_id=cid, hardware=fleet[cid].name,
                data_cardinality=int(data.n[cid]),
                batch_size=cfg.batch_size,
                local_epochs=cfg.local_epochs))
        self.hw = {cid: fleet[cid] for cid in range(len(fleet))}

        if init_params is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            init_params = model.init(gen)
        self.params = tree_map(
            lambda p: torch.as_tensor(p).to(self.device, torch.float32),
            init_params)
        self.history: list[RoundLog] = []
        self._acc = 0.0             # last evaluated accuracy (carried across
        #                             rounds when eval_every > 1)
        self._completed_this_round: set[int] = set()

        # update plane: trained models stay rows of one card-resident buffer
        self.update_plane = "device"
        self.spec = RavelSpec(self.params)
        self.store = UpdateStore(self.spec.n_params,
                                 capacity=max(cfg.clients_per_round, 1),
                                 device=self.device)
        # data plane: the federated dataset is resident on the card
        self.data_plane = "device"
        self.dataset = DatasetStore(data, device=self.device)

    # -------------------------------------------------- invocation service
    def invoke_round(self, round_: int, selection: list[int]) -> None:
        """Train the selected cohort against the current global model and
        start their simulated invocations."""
        cfg = self.cfg
        self._completed_this_round = set()
        n_i = self.data.n[selection]   # raises on an out-of-range selection
        steps = np.ceil(n_i / cfg.batch_size).astype(np.int64) * cfg.local_epochs
        steps = np.maximum(steps, 1)
        row_ids, _, _ = self.trainer.train_cohort_indexed(
            self.params, self.dataset, selection, n_i, steps,
            update_sink=self.store)
        for k, cid in enumerate(selection):
            rec = self.platform.invoke(cid, round_, self.loop.now,
                                       float(steps[k]), self.hw[cid],
                                       cfg.base_step_time)
            self.db.mark_running(cid, round_)
            self.loop.schedule(rec.duration, lambda cid=cid, rec=rec,
                               row=int(row_ids[k]), n=int(n_i[k]):
                               self._complete(cid, round_, rec, row, n))

    def _complete(self, cid: int, round_: int, rec: InvocationRecord,
                  row: int, n_samples: int) -> None:
        """Completion callback: land the trained row as a result, or record
        the failure and free the row."""
        if rec.failed:
            self.db.mark_failed(cid)
            self.store.free([row])
            return
        self.db.mark_complete(cid, rec.duration)  # includes startup/upload
        result = ResultRecord(client_id=cid, round=round_,
                              n_samples=n_samples, train_duration=rec.duration,
                              t_available=self.loop.now)
        self.db.put_update_row(result, row)
        self._completed_this_round.add(cid)

    # ------------------------------------------------- aggregation service
    def aggregate_round(self, round_: int) -> tuple[int, int, float]:
        strat = self.strategy
        pending = [r for r in self.db.pending_results(self.cfg.max_staleness, round_)
                   if strat.usable(r, round_)]
        if not pending:
            return 0, 0, float("nan")
        weights = np.array([strat.result_weight(r, round_) for r in pending],
                           np.float64)
        total = weights.sum()
        if not np.isfinite(total) or total <= 0:
            # e.g. Eq. 1 zeroes round-0 updates at T=1: fall back to
            # cardinality weighting so the aggregation stays well-defined
            weights = np.array([r.n_samples for r in pending], np.float64)
            total = weights.sum() or 1.0
        # cast THEN normalize in f32, as the reference does
        weights = weights.astype(np.float32)
        weights = weights / weights.sum()
        rows = [r.update_row for r in pending]
        if any(r < 0 for r in rows):
            raise RuntimeError("pending result without a row handle")
        self.params = weighted_aggregate_rows(
            self.store.buffer, rows, weights, self.spec,
            out_dtype=tree_leaves(self.params)[0].dtype)
        self.store.free(rows)
        n_stale = sum(1 for r in pending if r.round < round_)
        mean_dur = float(np.mean([r.train_duration for r in pending]))
        self.db.mark_aggregated(pending)
        # prune: results too stale to ever be usable again
        drop = [r for r in self.db.results
                if not r.aggregated and round_ - r.round >= self.cfg.max_staleness]
        self.store.free([r.update_row for r in drop if r.update_row >= 0])
        self.db.mark_aggregated(drop)
        return len(pending), n_stale, mean_dur

    # -------------------------------------------------- evaluation service
    @torch.no_grad()
    def evaluate(self) -> float:
        """Exact accuracy over the eval set, in batches of 256 on the card."""
        xs = torch.as_tensor(np.asarray(self.data.eval_x))
        ys = torch.as_tensor(np.asarray(self.data.eval_y)).long()
        n, bs = len(xs), 256
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, n, bs):
            xb = xs[i:i + bs].to(self.device)
            yb = ys[i:i + bs].to(self.device)
            pred = torch.argmax(self.model.predict(self.params, xb), dim=-1)
            correct += (pred == yb).sum()
        return float(correct.item()) / max(n, 1)

    # ---------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        inv = self.platform.invocations
        cost = self.cost_model.total(inv, lambda cid: self.hw[cid])
        counts = self.platform.invocation_counts()
        count_arr = [counts.get(cid, 0) for cid in self.db.client_ids()]
        return {
            "strategy": self.strategy.name,
            "engine": self.engine_name,
            "device": str(self.device),
            "control_plane": self.control_plane,
            "mesh": self.mesh_spec,
            "update_plane": self.update_plane,
            "data_plane": self.data_plane,
            "data_resident_bytes": self.dataset.resident_bytes,
            "rounds": len(self.history),
            "final_accuracy": self.history[-1].accuracy if self.history else 0.0,
            "total_time": self.loop.now,
            "total_cost_usd": cost,
            "cold_start_ratio": self.platform.cold_start_ratio(),
            "n_invocations": len(inv),
            "n_failures": sum(1 for r in inv if r.failed),
            "fault_profile": self.fault_profile,
            "selection_bias": (max(count_arr) - min(count_arr)) if count_arr else 0,
            "invocation_counts": count_arr,
            "history": [(l.t_end, l.round, l.accuracy) for l in self.history],
        }
