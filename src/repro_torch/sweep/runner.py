"""Local in-process sweep executor (twin of ``repro.sweep.runner``).

``LocalRunner`` turns a ``RunSpec`` cell into one engine run (the
event-driven ``Scheduler`` by default, the poll loop with
``engine="legacy"`` in the cell's overrides — see
``repro_torch.core.scheduler.build_engine``) with real local training on
the serverless simulator, on the runner's device (the CUDA card unless
``device="cpu"``). The expensive shared setup — synthetic federated
datasets, proxy models, hardware fleets — is built once per (dataset,
scenario) and reused by every cell, including concurrent ones: caches are
populated under a lock and the cached artifacts are read-only for the
engines (each run gets a *copy* of the fleet list and its own Database).

Optional JSON result caching (``cache_dir``) keys each cell by its
``RunSpec.key`` + scale + fidelity + pinned update plane (the reference's
key) and the device, so re-running a sweep composes tables without
re-training.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import asdict, replace
from typing import Optional

from repro_torch.core.scheduler import build_engine
from repro_torch.core.services import FLConfig
from repro_torch.device import resolve_device
from repro_torch.sweep.grid import RunSpec, SweepScale

# Per-dataset simulated compute weight (1vCPU-seconds per optimizer step),
# calibrated so round durations land in the paper's Fig-1/Fig-3 ranges.
BASE_STEP_TIME = {"mnist": 0.8, "femnist": 4.0, "shakespeare": 6.0,
                  "speech": 1.5}
# Every strategy gets the SAME simulated wall-clock budget per dataset: the
# paper compares time-to-accuracy, not round counts — async strategies run
# many more, shorter rounds inside the same budget.
SIM_BUDGET = {"mnist": 2_000.0, "femnist": 8_000.0, "shakespeare": 12_000.0,
              "speech": 4_000.0}
OPTIMIZER = {"shakespeare": ("sgd", 0.5)}  # others: (adam, 1e-3)


class LocalRunner:
    """Callable run executor with shared, thread-safe setup caches.

    ``update_plane`` pins every cell to one client-update transport
    ("device" = flat-buffer UpdateStore, "blob" = host pytrees) so a sweep
    compares strategies on identical plumbing; None keeps the engine's
    default. ``device`` (None = the CUDA card) is where every cell's
    engine runs."""

    def __init__(self, scale: SweepScale, *, fidelity: str = "proxy",
                 cache_dir: Optional[str] = None,
                 update_plane: Optional[str] = None, device=None):
        self.scale = scale
        self.fidelity = fidelity
        self.cache_dir = cache_dir
        self.update_plane = update_plane
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._models: dict = {}
        self._data: dict = {}
        self._fleets: dict = {}

    # ------------------------------------------------------- shared setup
    def model(self, dataset: str):
        with self._lock:
            if dataset not in self._models:
                from repro_torch.models.proxy_models import build_bench_model
                self._models[dataset] = build_bench_model(dataset,
                                                          self.fidelity)
            return self._models[dataset]

    def data(self, dataset: str):
        with self._lock:
            if dataset not in self._data:
                from repro_torch.data.synthetic import make_federated_dataset
                self._data[dataset] = make_federated_dataset(
                    dataset, n_clients=self.scale.n_clients,
                    scale=self.scale.data_scale, seed=self.scale.data_seed,
                    fidelity=self.fidelity)
            return self._data[dataset]

    def fleet(self, scenario: str) -> list:
        with self._lock:
            if scenario not in self._fleets:
                self._fleets[scenario] = _build_fleet(scenario,
                                                      self.scale.n_clients)
            return self._fleets[scenario]

    def warm(self, runs: list[RunSpec]) -> None:
        """Build all shared artifacts up front (serially), so concurrent
        cells never duplicate the expensive setup work."""
        for ds in {r.dataset for r in runs}:
            self.model(ds)
            self.data(ds)
        for sc in {r.scenario for r in runs}:
            self.fleet(sc)

    # ------------------------------------------------------------- config
    def config(self, run: RunSpec) -> FLConfig:
        s = self.scale
        opt, lr = OPTIMIZER.get(run.dataset, ("adam", 1e-3))
        # paper batch sizes are 10/10/32/5; proxy client shards are ~8x
        # smaller, so batches shrink to keep steps-per-epoch comparable
        batch = 8 if run.dataset == "shakespeare" else s.batch_size
        cfg = FLConfig(
            n_clients=s.n_clients, clients_per_round=s.clients_per_round,
            rounds=s.rounds, strategy=run.strategy,
            concurrency_ratio=run.concurrency_ratio,
            local_epochs=s.local_epochs, batch_size=batch,
            optimizer=opt, lr=lr,
            base_step_time=BASE_STEP_TIME.get(run.dataset, 1.0),
            round_timeout=600.0, staleness_fn=run.staleness_fn,
            seed=run.seed, eval_every=s.eval_every,
            data_plane=run.data_plane,
            control_plane=run.control_plane,
            fault_profile=run.fault_profile,
            traffic_profile=run.traffic_profile,
            mesh=run.mesh,
            max_sim_time=s.sim_budget or SIM_BUDGET.get(run.dataset, 2_000.0))
        if self.update_plane:
            cfg = replace(cfg, update_plane=self.update_plane)
        if run.overrides:
            cfg = replace(cfg, **dict(run.overrides))
        return cfg

    # ---------------------------------------------------------------- run
    def cache_key(self, run: RunSpec) -> str:
        """The cell's key, the reference's: a hash of the run's key, the
        scale, the fidelity and the pinned update plane."""
        key_src = json.dumps([run.key, asdict(self.scale), self.fidelity,
                              self.update_plane], sort_keys=True)
        return hashlib.sha1(key_src.encode()).hexdigest()[:16]

    def _cache_path(self, run: RunSpec) -> Optional[str]:
        """The cell's cached result: its key and the device it ran on."""
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir,
                            f"{self.cache_key(run)}-{self.device.type}.json")

    def engine(self, run: RunSpec):
        """The cell's engine, built and not yet run."""
        return build_engine(self.config(run), self.model(run.dataset),
                            self.data(run.dataset),
                            list(self.fleet(run.scenario)),
                            device=self.device)

    def __call__(self, run: RunSpec) -> dict:
        path = self._cache_path(run)
        if path and os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        t0 = time.time()
        metrics = self.engine(run).run()
        metrics["wall_s"] = time.time() - t0
        metrics["run_key"] = run.key
        metrics.pop("invocation_counts", None)  # bulky; bias is scalarized
        if path:
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(metrics, f)
        return metrics


def _build_fleet(scenario: str, n_clients: int) -> list:
    """Paper hardware scenarios: heterogeneous (IV-A3 65/25/10 mix),
    homogeneous (Fig 1 scenario 1), two-tier (Fig 1 scenario 2), and
    straggler (75% 1vCPU vs 25% GPU — the widest duration gap, used by the
    hedging presets)."""
    import numpy as np

    from repro_torch.faas.hardware import HARDWARE_PROFILES, paper_fleet
    if scenario == "heterogeneous":
        return list(paper_fleet(n_clients))
    if scenario == "homogeneous":
        return [HARDWARE_PROFILES["cpu2"]] * n_clients
    if scenario == "two-tier":
        rng = np.random.default_rng(0)
        fleet = [HARDWARE_PROFILES["cpu1"]] * round(n_clients * 0.6) + \
                [HARDWARE_PROFILES["cpu2"]] * (n_clients - round(n_clients * 0.6))
        rng.shuffle(fleet)
        return fleet
    if scenario == "straggler":
        rng = np.random.default_rng(0)
        n_slow = round(n_clients * 0.75)
        fleet = [HARDWARE_PROFILES["cpu1"]] * n_slow + \
                [HARDWARE_PROFILES["gpu"]] * (n_clients - n_slow)
        rng.shuffle(fleet)
        return fleet
    raise ValueError(f"unknown hardware scenario {scenario!r}")
