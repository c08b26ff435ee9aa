"""Shared FL execution substrate: config, state and round services (twin
of ``repro.core.services``).

:class:`FLRuntime` owns the execution state (global params on the card,
database, simulated platform, event loop, update store, resident dataset)
and the three round services both drivers share:

  * **invocation** (``invoke_round`` / ``hedge_invocations`` /
    ``cancel_client`` / ``timeout_invocation``): cohort-vectorized
    Client_Update on the card, simulated FaaS invocations, completion and
    failure callbacks, and the in-flight registry with reference-counted
    update payloads (hedge siblings share one trained row; the row is freed
    exactly once, by whichever invocation ends last without landing it);
  * **aggregation** (``aggregate_round``): staleness x cardinality weights
    (Eq. 2) over the update store's rows (or the blob plane's host trees),
    stale pruning;
  * **evaluation** (``evaluate``).

It also keeps SCAFFOLD's state (``c_global`` and the per-client variate
buffer ``c_buf``, flat ``[W]`` / ``[capacity, W]`` fp32 rows on the card in
``RavelSpec`` order), elastic membership (``add_clients`` /
``remove_clients``), seeded fault injection (``faas.faults``: the platform
evaluates ``FLConfig.fault_profile`` once an invocation) and the open-loop
traffic plane (``traffic``: a compiled schedule of bulk joins and leaves,
applied at fresh-round open by both engines). With ``durability="journal"``
a ``durability.DurabilityManager`` journals every protocol event before its
effects (``_emit``, and the Scheduler's ``_dispatch``) and writes a
coordinated snapshot at round close (``_durability_round_closed``), so a
killed run resumes bit-identically (``durability.resume_durable``); the
database checkpoints of ``checkpoint_every`` / ``checkpoint_dir`` are
``checkpoint`` and ``FLRuntime.resume``.

Drivers differ only in *when* they call the services: ``Controller`` keeps
the poll loop (Algorithm 1 verbatim); ``Scheduler`` dispatches typed
protocol events to a reactive policy through the ``_emit`` hook, a no-op
for the poll loop.

The port runs both engines on either update plane (``device`` rows, or
``blob``: host trees, the reference's equivalence oracle) and either data
plane (``device`` resident, or ``host``: per-dispatch upload), on the
``object`` or ``columnar`` control plane, with any fault or traffic
profile, and the Scheduler's fused-round megastep (``megastep="fused"``,
the default, as in the reference), durable or not, with database
checkpoints or without. A ``"<data>x<model>"`` mesh
(``sharding.flmesh``) runs under the caller's process group, one process
a rank, every rank running the whole host engine: the update store
sharded, the cohort split over ``data``, aggregation an all-reduce of the
ranks' partial sums. Under a mesh the device planes are required
(``ValueError`` otherwise, as in the reference). Durable runs and database
checkpoints run under a mesh with one writer, rank 0: it alone appends to
the journal and writes snapshots, the database and the update store's
live rows, which every rank gathers from its tile first; every rank
restores its own tile, and a database checkpoint resumes under another
mesh than the one that wrote it (the rows are saved whole).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import (weighted_aggregate,
                                          weighted_aggregate_rows)
from repro_torch.core.client import CohortTrainer
from repro_torch.core.data_plane import DatasetStore, resolve_data_plane
from repro_torch.core.database import ClientRecord, Database, ResultRecord
from repro_torch.core.protocol import (ClientJoined, ClientLeft,
                                       ClientsJoined, ClientsLeft, Event,
                                       InvocationFailed, InvocationTimedOut,
                                       ResultLanded)
from repro_torch.core.scoring import decay_rate
from repro_torch.core.strategies.base import (Strategy, StrategyConfig,
                                              build_strategy)
from repro_torch.core.update_store import (UpdateStore, _round_up,
                                          gather_stacked, grow_stacked,
                                          scatter_stacked_tree)
from repro_torch.device import fp32_exact, resolve_device
from repro_torch.faas.cost import CostModel
from repro_torch.faas.events import EventLoop
from repro_torch.faas.faults import build_fault_model, resolve_fault_profile
from repro_torch.faas.hardware import HardwareProfile
from repro_torch.faas.platform import FaaSPlatform, InvocationRecord
from repro_torch.kernels.ops import BLOCK_N, RavelSpec, tree_leaves, tree_map
from repro_torch.sharding import flmesh
from repro_torch.traffic import (build_traffic_schedule,
                                 resolve_traffic_profile, slo_summary)

Params = Any

UPDATE_STORE_DIRNAME = "update_store"


def _resolve(value: str, default: str) -> str:
    return default if value in (None, "", "auto") else value


def resolve_engine(mode: str) -> str:
    """'scheduler' (= 'auto': the event-driven reactive protocol) |
    'legacy' (the poll loop, kept as the equivalence oracle). Unlike the
    reference, no environment variable is read."""
    mode = _resolve(mode, "scheduler")
    if mode not in ("scheduler", "legacy"):
        raise ValueError(f"unknown engine {mode!r} "
                         "(expected 'scheduler', 'legacy', or 'auto')")
    return mode


def resolve_update_plane(mode: str) -> str:
    """'device' (= 'auto': updates stay rows of one card-resident buffer) |
    'blob' (host parameter trees, the reference's equivalence oracle).
    Unlike the reference, no environment variable is read."""
    mode = _resolve(mode, "device")
    if mode not in ("device", "blob"):
        raise ValueError(f"unknown update plane {mode!r} "
                         "(expected 'device', 'blob', or 'auto')")
    return mode


def resolve_megastep(mode: str) -> str:
    """'fused' (= 'auto': the Scheduler runs provably quiescent rounds as
    one fused loop, ``core.megastep``) | 'stepwise' (every round through
    the event-driven engine, the bit-exact oracle). Unlike the reference,
    no environment variable is read."""
    mode = _resolve(mode, "fused")
    if mode not in ("fused", "stepwise"):
        raise ValueError(f"unknown megastep mode {mode!r} "
                         "(expected 'fused', 'stepwise', or 'auto')")
    return mode


def resolve_durability(mode: str) -> str:
    """'off' (= 'auto': no journal, no snapshots, zero extra work — every
    trace bit-identical) | 'journal' (write-ahead event journal +
    coordinated round-boundary snapshots, ``repro_torch.durability``).
    Unlike the reference, no environment variable is read."""
    mode = _resolve(mode, "off")
    if mode not in ("off", "journal"):
        raise ValueError(f"unknown durability mode {mode!r} "
                         "(expected 'off', 'journal', or 'auto')")
    return mode


def resolve_durability_sync(mode: str) -> str:
    """'round' (= 'auto': fsync the journal at round boundaries only) |
    'event' (fsync every record — strongest, slowest). Unlike the
    reference, no environment variable is read."""
    mode = _resolve(mode, "round")
    if mode not in ("event", "round"):
        raise ValueError(f"unknown durability sync policy {mode!r} "
                         "(expected 'event', 'round', or 'auto')")
    return mode


def _check_supported(cfg: "FLConfig") -> None:
    """Raise for an unknown engine, megastep mode or control plane, and
    for a mesh with a plane that cannot shard, before any process group is
    read."""
    resolve_engine(cfg.engine)
    resolve_megastep(cfg.megastep)
    if _resolve(cfg.control_plane, "columnar") not in ("columnar", "object"):
        raise ValueError(f"unknown control plane {cfg.control_plane!r}")
    spec = flmesh.resolve_mesh(cfg.mesh)
    if spec == "1x1":
        return
    update_plane = resolve_update_plane(cfg.update_plane)
    data_plane = resolve_data_plane(cfg.data_plane)
    if update_plane != "device" or data_plane != "device":
        raise ValueError(
            f"mesh {spec!r} requires the device update and data planes (got "
            f"update_plane={update_plane!r}, data_plane={data_plane!r}): the "
            "blob/host paths move every row through the host and cannot "
            "shard")


@dataclass
class FLConfig:
    """Experiment configuration. Each field maps to a paper quantity
    (symbol / section noted inline) or a simulator knob.

    Paper defaults (IV-A): 200 clients, 100 per round, E=5 local epochs,
    batch 10 (MNIST), Adam 1e-3, CR=0.3, rho=0.2, staleness cap 5.

    The fields, their defaults and their meaning are the reference's. In
    the port an ``"auto"`` value resolves to the default the comment names
    without reading any ``REPRO_*`` environment variable. Every setting
    runs, under any mesh (a mesh other than ``1x1`` needs the device
    update and data planes)."""

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
    hedge_fraction: float = 0.5    # apodotiko-hedge: fraction of outstanding
    #                                 invocations speculatively re-invoked at
    #                                 the CR gate (slowest first)
    # -- FaaS platform simulation (§IV-A) --------------------------------------
    keep_warm: float = 600.0       # provider keep-warm window before
    #                                 scale-to-zero, sim-seconds
    cold_start_s: float = 8.0      # container cold-start penalty, sim-seconds
    base_step_time: float = 0.05   # 1vCPU-seconds per optimizer step
    #                                 (hardware profiles scale this, Fig. 1/3)
    failure_rate: float = 0.0      # P(invocation crash) — fault tolerance
    fault_profile: str = "auto"    # fault injection (DESIGN.md §12): a
    #                                 FAULT_PROFILES name ("crash-heavy",
    #                                 "outage-window", "lossy-network") or a
    #                                 raw faults.parse_faults spec string;
    #                                 "auto" = off (no extra RNG draws)
    traffic_profile: str = "auto"  # open-loop traffic (DESIGN.md §13): a
    #                                 TRAFFIC_PROFILES name ("steady-churn",
    #                                 "diurnal", "flash-crowd", "trace-demo")
    #                                 or a raw traffic.parse_traffic spec;
    #                                 "auto" = off (fixed fleet)
    # -- recovery layer (Scheduler engine only) --------------------------------
    invocation_timeout: float = 0.0  # per-invocation kill timer, sim-seconds
    #                                 (distinct from round_timeout; 0 = off)
    retry_budget: int = 0          # max retries per round (0 = no retries)
    retry_base_delay: float = 2.0  # backoff: delay = base * backoff^(k-1)
    retry_backoff: float = 2.0     #   * (1 + jitter * U[0,1)) for the k-th
    retry_jitter: float = 0.1      #   retry of a client within a round
    quarantine_threshold: int = 0  # circuit breaker: quarantine a client
    #                                 after this many consecutive failures
    #                                 (0 = off)
    quarantine_rounds: int = 3     # rounds a quarantined client sits out
    quorum_fraction: float = 1.0   # sync rounds aggregate once this cohort
    #                                 fraction completed (graceful
    #                                 degradation; 1.0 = the full gate)
    # -- aggregation (§III-B) --------------------------------------------------
    prox_mu: float = 0.01          # mu, FedProx proximal coefficient
    staleness_fn: str = "eq2"      # "eq2" = 1/sqrt(T - t_i + 1) (Eq. 2,
    #                                 Apodotiko) | "eq1" = t_i/T (FedLesScan)
    update_plane: str = "auto"     # client-update transport: "device"
    #                                 (= "auto"): updates stay rows of one
    #                                 card-resident [capacity, W] buffer;
    #                                 "blob": host parameter trees (oracle)
    engine: str = "auto"           # round driver: "scheduler" (= "auto"),
    #                                 the event-driven reactive protocol, or
    #                                 "legacy", the Controller poll loop
    control_plane: str = "auto"    # per-client fleet state: "columnar"
    #                                 (= "auto") struct-of-arrays columns, or
    #                                 "object", the per-client ClientRecord
    #                                 oracle; both are host numpy
    data_plane: str = "auto"       # training-input transport: "device"
    #                                 (= "auto"): the dataset stays resident
    #                                 on the card, minibatches gathered there;
    #                                 "host": the cohort's arrays uploaded
    #                                 every dispatch (oracle)
    megastep: str = "auto"         # fused rounds (Scheduler only): "fused"
    #                                 (= "auto"): runs of quiescent rounds as
    #                                 one fused loop (core.megastep), or
    #                                 "stepwise", the event-driven oracle
    durability: str = "auto"       # durable runs: "journal"
    #                                 write-ahead-journals every protocol
    #                                 event and snapshots all planes at
    #                                 round boundaries so a killed run
    #                                 resumes bit-identically
    #                                 (durability.resume_durable); "off"
    #                                 (= "auto") does nothing
    durability_sync: str = "auto"  # journal fsync policy: "event" (every
    #                                 record) | "round" (= "auto": round
    #                                 boundaries only)
    durability_snap_every: int = 1  # coordinated snapshot every k closed
    #                                 rounds (journal validation covers the
    #                                 re-executed gap on resume)
    mesh: str = "auto"             # device mesh (sharding.flmesh): "1x1"
    #                                 (= "auto") | "<data>x<model>", one
    #                                 process a rank in the caller's group
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
        hedge_fraction=cfg.hedge_fraction,
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


@dataclass
class _Payload:
    """One trained client update, shared by an invocation and its hedge
    siblings. Freed exactly once: either ownership passes to the landed
    ``ResultRecord`` (``landed``) or the last reference releases it."""

    row: int = -1          # UpdateStore row handle (device plane)
    blob: Any = None       # host parameter tree (blob plane)
    refs: int = 1
    landed: bool = False


@dataclass
class Inflight:
    """Registry entry for one live invocation (the substrate for
    Hedge/CancelInvocation and the invocation timeout)."""

    client_id: int
    round: int
    steps: float
    t_invoked: float
    rec: InvocationRecord
    payload: _Payload
    n_samples: int
    loss: float
    is_hedge: bool = False
    done: bool = False
    event: Any = None      # the loop completion event (cancellable)


class FLRuntime:
    """State + round services shared by the ``Controller`` poll loop and the
    event-driven ``Scheduler`` (see module docstring). ``device`` defaults
    to the CUDA card. ``db`` is a restored database (``resume``,
    ``durability.resume_durable``): its control plane is authoritative and
    no client is registered anew."""

    engine_name = "runtime"

    def __init__(self, cfg: FLConfig, model, data, fleet: list[HardwareProfile],
                 *, db: Optional[Database] = None,
                 init_params: Optional[Params] = None,
                 strategy: Optional[Strategy] = None, device=None):
        _check_supported(cfg)
        # mesh plane: "1x1" builds nothing (mesh None, the single-device
        # path); a wider mesh reads the caller's process group and names
        # this rank's device
        self.mesh_spec = flmesh.resolve_mesh(cfg.mesh)
        self.mesh = flmesh.build_fl_mesh(self.mesh_spec, device)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self._mesh_counters0 = (self.mesh.counters() if self.mesh is not None
                                else None)
        self.cfg = cfg
        self.model = model
        self.data = data        # FederatedDataset (repro_torch.data)
        self.fleet = fleet
        self.loop = EventLoop()
        # fault injection (faas.faults): off by default; the model owns its
        # own RNG stream, so the platform's draw order is untouched either way
        self.fault_profile = resolve_fault_profile(cfg.fault_profile)
        self.platform = FaaSPlatform(
            keep_warm=cfg.keep_warm, cold_start_s=cfg.cold_start_s,
            seed=cfg.seed, failure_rate=cfg.failure_rate,
            faults=build_fault_model(self.fault_profile, cfg.seed))
        self.cost_model = CostModel()
        # open-loop traffic (traffic, DESIGN.md §13): off by default. The
        # arrival process is compiled once, ahead of the run, from its own
        # numpy RNG stream; the off path compiles nothing
        self.traffic_profile = resolve_traffic_profile(cfg.traffic_profile)
        self.traffic = build_traffic_schedule(
            self.traffic_profile, cfg.n_clients, seed=cfg.seed,
            horizon_cap=cfg.max_sim_time)
        self._traffic_pos = 0       # next unapplied schedule segment
        self.n_traffic_joins = 0
        self.n_traffic_leaves = 0
        self.strategy: Strategy = (
            strategy if strategy is not None
            else build_strategy(cfg.strategy, strategy_config(cfg)))
        self.trainer = CohortTrainer(
            model, optimizer=cfg.optimizer, lr=cfg.lr,
            batch_size=cfg.batch_size, prox_mu=self.strategy.prox_mu,
            seed=cfg.seed, device=self.device, mesh=self.mesh)

        # control plane: a restored database's plane is authoritative (its
        # client state is stored in that representation)
        self.control_plane = (db.control_plane if db is not None
                              else _resolve(cfg.control_plane, "columnar"))
        self.db = db or Database(control_plane=self.control_plane,
                                 device=self.device)
        if self.db.columnar:
            # incremental-EMA decay (lambda = 1 - rho)
            self.db.fleet.decay = decay_rate(cfg.adjustment_rate)
        if db is None:
            if self.traffic is not None:
                # open-loop: only the schedule's initial membership exists
                # at t=0; later arrivals land via bulk traffic segments
                init = self.traffic.initial
                self.db.register_clients_bulk(
                    init, data.n[init], cfg.batch_size, cfg.local_epochs,
                    hardware=[fleet[int(c)].name for c in init])
            else:
                for cid in range(cfg.n_clients):
                    self.db.register_client(ClientRecord(
                        client_id=cid, hardware=fleet[cid].name,
                        data_cardinality=int(data.n[cid]),
                        batch_size=cfg.batch_size,
                        local_epochs=cfg.local_epochs))
        self.hw = {cid: fleet[cid] for cid in range(len(fleet))}
        # never pruned: cost/metrics must resolve hardware for historical
        # invocations of since-removed clients
        self._hw_history = dict(self.hw)
        # client id -> position in ``fleet``: removal must drop the entry
        # the id owns, not the first list entry that compares equal (two
        # clients may share one HardwareProfile object)
        self._fleet_pos = {cid: cid for cid in range(len(fleet))}

        if init_params is None and self.db.global_models:
            init_params = self.db.latest_global()
        elif init_params is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            init_params = model.init(gen)
        self.params = tree_map(
            lambda p: torch.as_tensor(p).to(self.device, torch.float32),
            init_params)
        self.history: list[RoundLog] = []
        self._acc = 0.0             # last evaluated accuracy (carried across
        #                             rounds when eval_every > 1)
        self._completed_this_round: set[int] = set()
        self.inflight: dict[int, list[Inflight]] = {}
        self.n_hedges = 0           # speculative re-invocations issued
        self.n_hedge_wins = 0       # hedges that beat their original
        self.n_cancelled = 0        # invocations cancelled (race/explicit)
        # recovery-layer observability
        self.n_retries = 0          # backoff re-invocations fired
        self.n_timeouts = 0         # invocations killed by the timeout
        self.n_quarantined = 0      # circuit-breaker quarantines issued
        self.retry_latency_s = 0.0  # total failure->retry delay, sim-seconds

        # update plane: trained models stay rows of one card-resident
        # buffer, or (blob) travel as host trees through the database
        self.update_plane = resolve_update_plane(cfg.update_plane)
        self.spec = RavelSpec(self.params)
        self.store: Optional[UpdateStore] = None
        self.update_host_bytes = 0  # bytes moved host<->card for updates
        if db is not None:
            self._check_plane_compatible(db)
        if self.update_plane == "device":
            self.store = UpdateStore(self.spec.n_params,
                                     capacity=max(cfg.clients_per_round, 1),
                                     device=self.device, mesh=self.mesh)
            if db is not None and cfg.checkpoint_dir:
                self._rehydrate_store()
        # data plane: the federated dataset is resident on the card, or
        # (host) each cohort's arrays are uploaded per dispatch
        self.data_plane = resolve_data_plane(cfg.data_plane)
        self.dataset: Optional[DatasetStore] = None
        if self.data_plane == "device":
            self.dataset = DatasetStore(data, device=self.device)
        # SCAFFOLD state: c_global plus a persistent card-resident buffer of
        # per-client control variates indexed by client id, both flat rows
        # of the update store's width
        self.c_global: Optional[torch.Tensor] = None
        self.c_buf: Optional[torch.Tensor] = None
        self._c_cap = 0
        if self.strategy.needs_scaffold:
            self.c_global = torch.zeros(self._row_width(),
                                        dtype=torch.float32,
                                        device=self.device)
            self._ensure_c_capacity(max(cfg.n_clients, 1))
        # durability plane: off by default — no journal, no snapshots, no
        # RNG draws, every trace bit-identical
        self.durability = None
        if resolve_durability(cfg.durability) == "journal":
            from repro_torch.durability.manager import DurabilityManager
            self.durability = DurabilityManager(self)

    # -- driver view contract (protocol.DatabaseView reads these) ------------
    @property
    def current_round(self) -> int:
        return self.db.round

    @property
    def round_start(self) -> float:
        return getattr(self, "_t0", 0.0)

    def _check_plane_compatible(self, db: Database) -> None:
        """A checkpoint written under one update plane cannot feed pending
        results to the other: blob records carry update_row=-1 (which would
        silently index the last buffer row) and device records carry no
        blob. Switching planes across a resume is fine once nothing is
        in flight."""
        saved = db.meta.get("update_plane")
        if saved is None or saved == self.update_plane:
            return
        if any(not r.aggregated for r in db.results):
            raise ValueError(
                f"checkpoint was written with update_plane={saved!r} and "
                f"has un-aggregated results; resuming with "
                f"update_plane={self.update_plane!r} would corrupt them — "
                f"set cfg.update_plane={saved!r} to resume, or aggregate "
                f"before switching planes")

    def _rehydrate_store(self) -> None:
        """Resume path: reload the live un-aggregated update rows saved at
        checkpoint time, at their original ids so ResultRecord handles in
        the restored database stay valid. Under a mesh each rank writes
        its own tile of the saved whole rows; rows saved by a store of
        another W (another mesh's alignment) are trimmed or zero-padded
        to this one's by ``write_at``."""
        from repro_torch.checkpoint import restore_update_store
        d = os.path.join(self.cfg.checkpoint_dir, UPDATE_STORE_DIRNAME)
        if not os.path.isdir(d):
            return
        ids, rows, n_params = restore_update_store(d)
        if n_params != self.spec.n_params:
            raise ValueError(
                f"update-store checkpoint has N={n_params} params but the "
                f"model has N={self.spec.n_params}")
        self.store.write_at(ids, rows)

    def _row_width(self) -> int:
        """The flat row width of an update or a SCAFFOLD variate: the
        update store's, or on the blob plane the same rounding of N."""
        if self.store is not None:
            return self.store.row_width
        return _round_up(self.spec.n_params, BLOCK_N)

    # ------------------------------------------------------- SCAFFOLD buffer
    def _ensure_c_capacity(self, n: int) -> None:
        """Grow the control-variate buffer to hold client ids < ``n``
        (amortized doubling, zero-initialized new rows)."""
        if n <= self._c_cap:
            return
        cap = max(n, 2 * self._c_cap)
        if self.c_buf is None:
            self.c_buf = torch.zeros((cap, self._row_width()),
                                     dtype=torch.float32, device=self.device)
        else:
            self.c_buf = grow_stacked(self.c_buf, self._c_cap, cap)
        self._c_cap = cap

    # ---------------------------------------------------------------- elastic
    def add_clients(self, records: list[ClientRecord],
                    profiles: list[HardwareProfile]) -> None:
        for rec, hw in zip(records, profiles):
            self.db.register_client(rec)
            self.hw[rec.client_id] = hw
            self._hw_history[rec.client_id] = hw
            self._fleet_pos[rec.client_id] = len(self.fleet)
            self.fleet.append(hw)
            if self.c_buf is not None:
                self._ensure_c_capacity(rec.client_id + 1)
            self._emit(ClientJoined(t=self.loop.now, client_id=rec.client_id))

    def remove_clients(self, client_ids: list[int]) -> None:
        """Deregister clients mid-run: cancel their in-flight invocations
        (releasing update rows), drop their hardware profile from ``hw``
        and ``fleet`` (by the id's recorded fleet position — a
        ``list.remove`` identity scan would evict the wrong entry when two
        clients share one HardwareProfile object), and emit ``ClientLeft``
        through the protocol."""
        for cid in client_ids:
            for inv in list(self.inflight.get(cid, ())):
                self._cancel_inflight(inv)
            self.inflight.pop(cid, None)
            if not self.db.unregister_client(cid):
                continue
            if self.c_buf is not None and cid < self._c_cap:
                # a rejoining id must start from zero variates, like any
                # fresh client
                self.c_buf[cid] = 0.0
            self.hw.pop(cid, None)
            pos = self._fleet_pos.pop(cid, None)
            if pos is not None:
                del self.fleet[pos]
                for c, p in self._fleet_pos.items():
                    if p > pos:
                        self._fleet_pos[c] = p - 1
            self._emit(ClientLeft(t=self.loop.now, client_id=cid))

    # ------------------------------------------------------------- traffic
    def _traffic_boundary(self) -> Optional[float]:
        """Start time of the next unapplied traffic segment (None when
        traffic is off or the schedule is exhausted)."""
        if (self.traffic is None
                or self._traffic_pos >= len(self.traffic.segments)):
            return None
        return self.traffic.segments[self._traffic_pos].start

    def _apply_due_traffic(self) -> bool:
        """Apply every compiled traffic segment with start <= now (both
        engines call this at fresh-round open). Returns True if fleet
        membership changed."""
        applied = False
        while True:
            nb = self._traffic_boundary()
            if nb is None or nb > self.loop.now:
                return applied
            seg = self.traffic.segments[self._traffic_pos]
            self._traffic_pos += 1
            self._apply_traffic_segment(seg)
            applied = True

    def _apply_traffic_segment(self, seg) -> None:
        """One bulk membership delta: leaves first (cancelling their
        in-flight work, reclaiming their platform instances and zeroing
        their SCAFFOLD variate rows), then joins: one columnar scatter and
        one append instead of per-event Python. The hardware universe
        (``fleet``/``hw``/``_fleet_pos``) is untouched: traffic ids live in
        the fixed [0, n_clients) universe, so a departed id keeps its
        profile for its eventual re-join (unlike ``remove_clients``, which
        retires an id for good)."""
        now = self.loop.now
        leaves = [int(c) for c in seg.leaves if self.db.has_client(int(c))]
        if leaves:
            for cid in leaves:
                for inv in list(self.inflight.get(cid, ())):
                    self._cancel_inflight(inv)
                self.inflight.pop(cid, None)
            self.db.unregister_clients_bulk(leaves)
            # departed containers scale to zero: a re-join under the same
            # id pays a fresh cold start (cold-start-rate SLO accounting)
            self.platform.scale_down(leaves)
            if self.c_buf is not None:
                idx = [c for c in leaves if c < self._c_cap]
                if idx:
                    self.c_buf[torch.as_tensor(idx, device=self.device)] = 0.0
            self.n_traffic_leaves += len(leaves)
            self._emit(ClientsLeft(t=now, client_ids=tuple(leaves)))
        joins = [int(c) for c in seg.joins
                 if not self.db.has_client(int(c))]
        if joins:
            self.db.register_clients_bulk(
                joins, self.data.n[joins], self.cfg.batch_size,
                self.cfg.local_epochs,
                hardware=[self.fleet[c].name for c in joins])
            if self.c_buf is not None:
                self._ensure_c_capacity(max(joins) + 1)
            self.n_traffic_joins += len(joins)
            self._emit(ClientsJoined(t=now, client_ids=tuple(joins)))

    def _traffic_fast_forward(self) -> bool:
        """The run is stalled: no pending events and no idle client. Under
        a fixed fleet that ends the run; under open-loop traffic the clock
        jumps to the next arrival boundary instead and applies it. Returns
        True when the jump changed membership (so the caller re-opens
        selection)."""
        nb = self._traffic_boundary()
        if nb is None or nb >= self.cfg.max_sim_time:
            return False
        if self.loop.peek() is not None:
            return False
        self.loop.now = max(self.loop.now, nb)
        return self._apply_due_traffic()

    # -------------------------------------------------- protocol emit hook
    def _emit(self, event: Event) -> None:
        """Protocol dispatch hook: journal-only for the poll loop; the
        ``Scheduler`` overrides this to hand the event to its policy
        (which journals at the top of ``_dispatch`` instead)."""
        if self.durability is not None:
            self.durability.record_event(event)

    def _durability_round_closed(self) -> None:
        """Both engines call this immediately after ``db.round``
        advances: the round-close journal marker plus, on cadence, the
        coordinated snapshot (``repro_torch.durability``)."""
        if self.durability is not None:
            self.durability.on_round_closed()

    # -------------------------------------------------- invocation service
    def invoke_round(self, round_: int, selection: list[int],
                     *, reset_completed: bool = True) -> None:
        """Train the selected cohort against the current global model and
        start their simulated invocations. ``reset_completed`` clears the
        sync gating set — the first invocation of a round does, follow-up
        reinforcements must not."""
        cfg = self.cfg
        if reset_completed:
            self._completed_this_round = set()
        n_i = self.data.n[selection]   # raises on an out-of-range selection
        steps = np.ceil(n_i / cfg.batch_size).astype(np.int64) * cfg.local_epochs
        steps = np.maximum(steps, 1)
        cg, ci = self.c_global, None
        if self.strategy.needs_scaffold:
            # card gather out of the persistent variate buffer
            self._ensure_c_capacity(max(selection) + 1)
            ci = gather_stacked(self.c_buf, selection)
        device = self.update_plane == "device"
        if self.data_plane == "device":
            out, ci_new, losses = self.trainer.train_cohort_indexed(
                self.params, self.dataset, selection, n_i, steps, cg, ci,
                update_sink=self.store)
        else:
            out, ci_new, losses = self.trainer.train_cohort(
                self.params, self.data.X[selection], self.data.y[selection],
                n_i, steps, cg, ci, update_sink=self.store)
        if not device:
            # blob plane: the trained models come back as host trees
            out = tree_map(lambda x: x.cpu().numpy(), out)
            self.update_host_bytes += sum(l.nbytes for l in tree_leaves(out))
        if self.strategy.needs_scaffold:
            self._apply_scaffold_updates(selection, ci_new)
        for k, cid in enumerate(selection):
            payload = (_Payload(row=int(out[k])) if device
                       else _Payload(blob=tree_map(lambda x: x[k], out)))
            self._launch(cid, round_, float(steps[k]), payload, int(n_i[k]),
                         float(losses[k]))

    def _launch(self, cid: int, round_: int, steps: float, payload: _Payload,
                n_samples: int, loss: float, *, is_hedge: bool = False
                ) -> Inflight:
        rec = self.platform.invoke(cid, round_, self.loop.now, steps,
                                   self.hw[cid], self.cfg.base_step_time)
        self.db.mark_running(cid, round_)
        inv = Inflight(client_id=cid, round=round_, steps=steps,
                       t_invoked=self.loop.now, rec=rec, payload=payload,
                       n_samples=n_samples, loss=loss, is_hedge=is_hedge)
        inv.event = self.loop.schedule(rec.duration,
                                       lambda: self._complete(inv))
        self.inflight.setdefault(cid, []).append(inv)
        return inv

    def _complete(self, inv: Inflight) -> None:
        """Completion callback: land the result (or record the failure),
        settle the payload, and cancel any losing hedge siblings."""
        inv.done = True
        self._drop_inflight(inv)
        pay = inv.payload
        siblings = [o for o in self.inflight.get(inv.client_id, ())
                    if o.round == inv.round and not o.done]
        if inv.rec.failed:
            if siblings:
                # a hedge is still racing: count the failure but keep the
                # client marked running for the surviving invocation
                self.db.incr_failures(inv.client_id)
            else:
                self.db.mark_failed(inv.client_id)
            pay.refs -= 1
            if pay.refs <= 0 and not pay.landed:
                self._free_payload(pay)
            self._emit(InvocationFailed(t=self.loop.now, round=inv.round,
                                        client_id=inv.client_id))
            return
        train_dur = inv.rec.duration  # includes startup/load/upload
        self.db.mark_complete(inv.client_id, train_dur)
        result = ResultRecord(client_id=inv.client_id, round=inv.round,
                              n_samples=inv.n_samples,
                              train_duration=train_dur,
                              t_available=self.loop.now)
        if self.update_plane == "device":
            self.db.put_update_row(result, pay.row)
        else:
            self.db.put_update(result, pay.blob)
        pay.landed = True
        pay.refs -= 1
        self._completed_this_round.add(inv.client_id)
        if inv.is_hedge:
            self.n_hedge_wins += 1
        for sib in siblings:        # losers of the hedge race
            self._cancel_inflight(sib)
        self._emit(ResultLanded(t=self.loop.now, round=inv.round,
                                result=result))

    def _drop_inflight(self, inv: Inflight) -> None:
        invs = self.inflight.get(inv.client_id)
        if invs and inv in invs:
            invs.remove(inv)
            if not invs:
                self.inflight.pop(inv.client_id, None)

    def _cancel_inflight(self, inv: Inflight) -> None:
        if inv.done:
            return
        inv.done = True
        self.loop.cancel(inv.event)
        self._drop_inflight(inv)
        # bill only the elapsed fraction and stop the container clocks —
        # unless a sibling invocation still runs on the instance (its own
        # completion then bounds the busy/keep-warm horizon)
        live = [i.rec.t_completed
                for i in self.inflight.get(inv.client_id, ()) if not i.done]
        self.platform.cancel(inv.rec, self.loop.now,
                             live_until=max(live) if live else None)
        self.n_cancelled += 1
        pay = inv.payload
        pay.refs -= 1
        if pay.refs <= 0 and not pay.landed:
            self._free_payload(pay)

    def timeout_invocation(self, inv: Inflight) -> None:
        """Kill an in-flight invocation that outlived the per-invocation
        timeout (``FLConfig.invocation_timeout``): the container is
        cancelled at ``now``, the payload released, the failure counted
        against the client, and ``InvocationTimedOut`` emitted so the
        recovery policy can retry or quarantine."""
        if inv.done:
            return
        inv.done = True
        self.loop.cancel(inv.event)
        self._drop_inflight(inv)
        live = [i.rec.t_completed
                for i in self.inflight.get(inv.client_id, ()) if not i.done]
        self.platform.cancel(inv.rec, self.loop.now,
                             live_until=max(live) if live else None)
        inv.rec.failed = True
        inv.rec.timed_out = True
        inv.rec.failed_phase = "timeout"
        pay = inv.payload
        pay.refs -= 1
        if pay.refs <= 0 and not pay.landed:
            self._free_payload(pay)
        if live:
            self.db.incr_failures(inv.client_id)    # a sibling still races
        else:
            self.db.mark_failed(inv.client_id)
        self.n_timeouts += 1
        self._emit(InvocationTimedOut(t=self.loop.now, round=inv.round,
                                      client_id=inv.client_id))

    def _free_payload(self, pay: _Payload) -> None:
        if self.update_plane == "device" and pay.row >= 0:
            self.store.free([pay.row])
        pay.blob = None

    def cancel_client(self, cid: int) -> None:
        """Cancel every live invocation of ``cid`` and return the client
        to the idle pool (the ``CancelInvocation`` action)."""
        for inv in list(self.inflight.get(cid, ())):
            self._cancel_inflight(inv)
        self.db.release_client(cid)

    def hedge_invocations(self, cids: list[int]) -> list[int]:
        """Speculatively re-invoke the outstanding invocation of each
        client on its (still-warm, per the keep-warm window the original
        opened) container. The hedge reuses the original's trained update
        — same data, same global model — and races its simulated duration;
        ``_complete`` settles the race. Returns the clients hedged."""
        launched = []
        for cid in cids:
            if not self.db.has_client(cid) or cid not in self.hw:
                continue
            invs = self.inflight.get(cid, ())
            if any(i.is_hedge and not i.done for i in invs):
                continue            # already hedged
            live = [i for i in invs if not i.done and not i.is_hedge]
            if not live:
                continue
            orig = live[0]
            orig.payload.refs += 1
            self._launch(cid, orig.round, orig.steps, orig.payload,
                         orig.n_samples, orig.loss, is_hedge=True)
            self.n_hedges += 1
            launched.append(cid)
        return launched

    def _apply_scaffold_updates(self, selection, ci_new: torch.Tensor) -> None:
        """c <- c + sum(c_i' - c_i) / N_total, all on the card: the old
        variates are gathered out of the persistent buffer, the delta is a
        sum over the cohort's lanes (divided by N_total as an fp32 tensor,
        a true division as the reference's), and the new variates scatter
        back in place."""
        old = gather_stacked(self.c_buf, selection)
        n_total = torch.tensor(float(max(self.db.n_clients, 1)),
                               dtype=torch.float32, device=self.device)
        self.c_global = self.c_global + torch.sum(ci_new - old, dim=0) / n_total
        scatter_stacked_tree(self.c_buf, selection, ci_new)

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
        out_dtype = tree_leaves(self.params)[0].dtype
        if self.update_plane == "device":
            rows = [r.update_row for r in pending]
            if any(r < 0 for r in rows):
                raise RuntimeError("pending result without a row handle")
            self.params = weighted_aggregate_rows(
                self.store.buffer, rows, weights, self.spec,
                out_dtype=out_dtype, mesh=self.mesh)
            self.store.free(rows)
        else:
            updates = [tree_map(lambda x: torch.as_tensor(x).to(self.device),
                                self.db.blobs[r.update_key])
                       for r in pending]
            self.update_host_bytes += sum(
                l.nbytes for r in pending
                for l in tree_leaves(self.db.blobs[r.update_key]))
            self.params = weighted_aggregate(updates, weights,
                                             out_dtype=out_dtype)
        n_stale = sum(1 for r in pending if r.round < round_)
        mean_dur = float(np.mean([r.train_duration for r in pending]))
        self.db.mark_aggregated(pending)
        # prune: results too stale to ever be usable again
        drop = [r for r in self.db.results
                if not r.aggregated and round_ - r.round >= self.cfg.max_staleness]
        if self.update_plane == "device":
            self.store.free([r.update_row for r in drop
                             if r.update_row >= 0])
        self.db.mark_aggregated(drop)
        return len(pending), n_stale, mean_dur

    # -------------------------------------------------- evaluation service
    @torch.no_grad()
    def evaluate(self) -> float:
        """Exact accuracy over the eval set, in batches of 256 on the card.
        The count of correct samples is scaled in fp32 as the reference's
        jitted ``correct.astype(f32) / n`` runs: XLA folds the division by
        the constant n into a multiply by its fp32 reciprocal. So
        accuracies (and a ``target_accuracy`` stop) are the reference's to
        the bit. TF32 is off for the pass (``device.fp32_exact``)."""
        xs = torch.as_tensor(np.asarray(self.data.eval_x))
        ys = torch.as_tensor(np.asarray(self.data.eval_y)).long()
        n, bs = len(xs), 256
        if not hasattr(self.model, "predict"):
            # a model with only ``accuracy`` (the LM adapter, which masks
            # its targets) takes the reference's per-batch loop: each
            # batch's fp32 accuracy weighted by its size, summed in float64
            total = 0.0
            with fp32_exact():
                for i in range(0, n, bs):
                    batch = {"x": xs[i:i + bs].to(self.device),
                             "y": ys[i:i + bs].to(self.device)}
                    total += float(self.model.accuracy(self.params, batch)
                                   ) * len(batch["x"])
            return total / max(n, 1)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        with fp32_exact():
            for i in range(0, n, bs):
                xb = xs[i:i + bs].to(self.device)
                yb = ys[i:i + bs].to(self.device)
                pred = torch.argmax(self.model.predict(self.params, xb),
                                    dim=-1)
                correct += (pred == yb).sum()
        recip = float(np.float32(1.0) / np.float32(max(n, 1)))
        return float((correct.to(torch.float32) * recip).item())

    # ---------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        inv = self.platform.invocations
        # _hw_history, not hw: invocation records outlive removed clients
        cost = self.cost_model.total(inv, lambda cid: self._hw_history[cid])
        counts = self.platform.invocation_counts()
        count_arr = [counts.get(cid, 0) for cid in self.db.client_ids()]
        return {
            "strategy": self.strategy.name,
            "engine": self.engine_name,
            "device": str(self.device),
            "control_plane": self.control_plane,
            "mesh": self.mesh_spec,
            # the mesh's collectives during this engine's life: bytes
            # staged through the host (gloo with card tensors), host-clock
            # seconds, calls
            **self._mesh_metrics(),
            "update_plane": self.update_plane,
            "update_host_bytes": int(self.update_host_bytes),
            "data_plane": self.data_plane,
            # per-dispatch training-input uploads (0 on the device plane:
            # the dataset is resident, see data_resident_bytes)
            "data_host_bytes": int(self.trainer.data_h2d_bytes),
            "data_resident_bytes": (self.dataset.resident_bytes
                                    if self.dataset is not None else 0),
            "rounds": len(self.history),
            "final_accuracy": self.history[-1].accuracy if self.history else 0.0,
            "total_time": self.loop.now,
            "total_cost_usd": cost,
            "cold_start_ratio": self.platform.cold_start_ratio(),
            "n_invocations": len(inv),
            "n_hedges": self.n_hedges,
            "n_hedge_wins": self.n_hedge_wins,
            "n_cancelled": self.n_cancelled,
            "fault_profile": self.fault_profile,
            # open-loop traffic and the SLO layer (DESIGN.md §13)
            "traffic_profile": self.traffic_profile,
            "n_traffic_joins": self.n_traffic_joins,
            "n_traffic_leaves": self.n_traffic_leaves,
            "n_traffic_dropped": (self.traffic.n_dropped
                                  if self.traffic is not None else 0),
            "traffic_segments_applied": self._traffic_pos,
            **slo_summary(
                self.history, self.platform.cold_start_ratio(), cost,
                time_to_accuracy=(
                    self.time_to_accuracy(self.cfg.target_accuracy)
                    if self.cfg.target_accuracy else None)),
            "n_failures": sum(1 for r in inv if r.failed),
            "n_timeouts": self.n_timeouts,
            "n_retries": self.n_retries,
            "n_quarantined": self.n_quarantined,
            "retry_latency_s": self.retry_latency_s,
            "failures_by_phase": self._failures_by_phase(inv),
            # durability plane
            **(self.durability.metrics() if self.durability is not None
               else {"durability": "off"}),
            "selection_bias": (max(count_arr) - min(count_arr)) if count_arr else 0,
            "invocation_counts": count_arr,
            "history": [(l.t_end, l.round, l.accuracy) for l in self.history],
        }

    def _mesh_metrics(self) -> dict:
        if self.mesh is None:
            return {"mesh_host_bytes": 0, "mesh_collective_s": 0.0,
                    "mesh_collectives": 0}
        now = self.mesh.counters()
        return {k: now[k] - self._mesh_counters0[k] for k in now}

    def time_to_accuracy(self, target: float) -> Optional[float]:
        """Simulated time at which an evaluation first reached ``target``
        (None if none did)."""
        for l in self.history:
            if l.accuracy >= target:
                return l.t_end
        return None

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self) -> None:
        """Save the database (client records, results, round, the global
        model as host arrays) to ``cfg.checkpoint_dir``, and on the device
        plane the live un-aggregated update rows beside it. Under a mesh
        every rank calls it and keeps the same database; rank 0 alone
        writes, every rank joins the gather of the live rows, and all meet
        at a barrier once the files are written."""
        if not self.cfg.checkpoint_dir:
            return
        self.db.meta["update_plane"] = self.update_plane
        self.db.put_global_model(self.db.round, tree_map(
            lambda p: p.detach().cpu().numpy(), self.params))
        if flmesh.is_writer(self.mesh):
            self.db.save(self.cfg.checkpoint_dir)
        if self.update_plane == "device":
            # persist the live un-aggregated rows so the async in-flight
            # state survives a crash bit-exactly (handles stay valid)
            from repro_torch.checkpoint import save_update_store
            ids = [r.update_row for r in self.db.results
                   if not r.aggregated and r.update_row >= 0]
            save_update_store(
                self.store, ids,
                os.path.join(self.cfg.checkpoint_dir, UPDATE_STORE_DIRNAME))
        if self.mesh is not None:
            flmesh.barrier(self.mesh)

    @classmethod
    def resume(cls, cfg: FLConfig, model, data, fleet, device=None):
        """Rebuild an engine from the database ``checkpoint`` saved in
        ``cfg.checkpoint_dir`` (on the card unless ``device`` says
        otherwise), under ``cfg.mesh``, whichever mesh wrote it: each rank
        loads the database onto its own device."""
        mesh = flmesh.build_fl_mesh(flmesh.resolve_mesh(cfg.mesh), device)
        device = mesh.device if mesh is not None else resolve_device(device)
        db = Database.load(cfg.checkpoint_dir, device=device)
        return cls(cfg, model, data, fleet, db=db, device=device)

    @staticmethod
    def _failures_by_phase(inv) -> dict:
        """Count failed invocations by attributed phase (Bernoulli
        failures carry phase "train", timeouts "timeout")."""
        by: dict[str, int] = {}
        for r in inv:
            if not r.failed:
                continue
            phase = r.failed_phase or "unattributed"
            by[phase] = by.get(phase, 0) + 1
        return by
