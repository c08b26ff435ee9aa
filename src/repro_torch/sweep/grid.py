"""Declarative sweep grids: strategy x seed x dataset x scenario x CR.

A ``SweepSpec`` names the axes of a comparison experiment (the paper's
tables are strategy x dataset grids on a fixed hardware mix); ``expand_grid``
enumerates it into an ordered, deterministic list of ``RunSpec`` cells. Every
cell shares one ``SweepScale`` — the knobs that trade fidelity for wall-clock
(client counts, rounds, data size; DESIGN.md §8) — so results within a sweep
are directly comparable.

Determinism contract: ``expand_grid`` is a pure function of the spec — same
spec, same list, same order — and each cell's ``seed`` flows into
``FLConfig.seed`` (strategy selection RNG, platform noise, model init) while
the *data* partition seed is shared sweep-wide, so strategies compete on the
identical federated dataset.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product
from typing import Any, Optional, Sequence, Tuple


@dataclass(frozen=True)
class RunSpec:
    """One cell of a sweep grid (one Controller.run())."""
    dataset: str
    strategy: str
    scenario: str = "heterogeneous"
    seed: int = 0
    concurrency_ratio: float = 0.3       # CR (paper Alg. 1); async only
    staleness_fn: str = "eq2"            # Eq. 2 (Apodotiko) | Eq. 1
    data_plane: str = "auto"             # training-input transport
    #                                      (device | host | auto)
    control_plane: str = "auto"          # fleet-state backing
    #                                      (columnar | object | auto)
    fault_profile: str = "auto"          # fault schedule (repro.faas.faults)
    #                                      (auto = REPRO_FAULTS env, "" off)
    traffic_profile: str = "auto"        # open-loop traffic (repro.traffic)
    #                                      (auto = REPRO_TRAFFIC env, "" off)
    mesh: str = "auto"                   # device mesh (repro.sharding.flmesh)
    #                                      (auto = REPRO_MESH env, 1x1 off)
    overrides: Tuple[Tuple[str, Any], ...] = ()  # extra FLConfig fields

    @property
    def key(self) -> str:
        ov = ";".join(f"{k}={v}" for k, v in self.overrides)
        dp = "" if self.data_plane == "auto" else f"/dp={self.data_plane}"
        cp = ("" if self.control_plane == "auto"
              else f"/ctl={self.control_plane}")
        fp = ("" if self.fault_profile == "auto"
              else f"/faults={self.fault_profile or 'none'}")
        tp = ("" if self.traffic_profile == "auto"
              else f"/traffic={self.traffic_profile or 'none'}")
        ms = "" if self.mesh == "auto" else f"/mesh={self.mesh}"
        return (f"{self.dataset}/{self.scenario}/{self.strategy}"
                f"/cr={self.concurrency_ratio:g}/{self.staleness_fn}"
                f"/seed={self.seed}" + dp + cp + fp + tp + ms
                + (f"/{ov}" if ov else ""))

    @property
    def group(self) -> tuple:
        """Comparison group: strategies within one group share a baseline
        (FedAvg) for speedup / cold-start / cost ratios. The data and
        control planes are group axes: a device/columnar cell must be
        ratioed against the matching-plane FedAvg, never silently against
        another plane's. Likewise the fault profile: a chaos cell's
        speedup is measured against the FedAvg that suffered the same
        schedule. And the traffic profile: under open-loop load, ratios
        compare runs that faced the same arrival process. The mesh is a
        group axis too: sharded cells ratio against the same-mesh
        baseline."""
        return (self.dataset, self.scenario, self.seed, self.data_plane,
                self.control_plane, self.fault_profile,
                self.traffic_profile, self.mesh, self.overrides)


@dataclass(frozen=True)
class SweepScale:
    """Sweep-wide scale knobs, shared by every cell (DESIGN.md §8)."""
    n_clients: int = 16
    clients_per_round: int = 8
    rounds: int = 48
    data_scale: float = 0.12        # fraction of the proxy dataset per sweep
    local_epochs: int = 3
    batch_size: int = 5
    sim_budget: Optional[float] = None  # None -> per-dataset default
    eval_every: int = 2
    data_seed: int = 0              # shared across cells: same partition


# Bench scale keeps the paper's *structure* (client mix, non-IID scheme, CR)
# at 1-core-container cost; paper scale is the real Table IV-VI grid (hours).
BENCH_SCALE = SweepScale()
PAPER_SCALE = SweepScale(n_clients=200, clients_per_round=100, rounds=500,
                         data_scale=0.5, local_epochs=5, batch_size=10)
SMOKE_SCALE = SweepScale(n_clients=8, clients_per_round=4, rounds=6,
                         data_scale=0.06, local_epochs=1, sim_budget=400.0)


@dataclass(frozen=True)
class SweepSpec:
    """A full comparison experiment: the cross product of its axes."""
    name: str
    datasets: Sequence[str] = ("mnist",)
    strategies: Sequence[str] = ("fedavg", "fedprox", "scaffold",
                                 "fedlesscan", "fedbuff", "apodotiko")
    seeds: Sequence[int] = (0,)
    scenarios: Sequence[str] = ("heterogeneous",)
    concurrency_ratios: Sequence[float] = (0.3,)
    staleness_fns: Sequence[str] = ("eq2",)
    data_planes: Sequence[str] = ("auto",)   # device/host transport ablation
    control_planes: Sequence[str] = ("auto",)  # columnar/object fleet state
    fault_profiles: Sequence[str] = ("auto",)  # chaos axis ("" = faults off)
    traffic_profiles: Sequence[str] = ("auto",)  # open-loop load axis
    meshes: Sequence[str] = ("auto",)  # device-mesh axis ("1x1" = off)
    scale: SweepScale = field(default=BENCH_SCALE)
    overrides: Tuple[Tuple[str, Any], ...] = ()

    @property
    def n_runs(self) -> int:
        return (len(self.datasets) * len(self.strategies) * len(self.seeds)
                * len(self.scenarios) * len(self.concurrency_ratios)
                * len(self.staleness_fns) * len(self.data_planes)
                * len(self.control_planes) * len(self.fault_profiles)
                * len(self.traffic_profiles) * len(self.meshes))


def expand_grid(spec: SweepSpec) -> list[RunSpec]:
    """Enumerate the grid in deterministic (dataset-major) order."""
    runs = [
        RunSpec(dataset=ds, strategy=strat, scenario=sc, seed=seed,
                concurrency_ratio=cr, staleness_fn=fn, data_plane=dp,
                control_plane=cp, fault_profile=fp, traffic_profile=tp,
                mesh=ms, overrides=tuple(spec.overrides))
        for ds, sc, seed, cr, fn, dp, cp, fp, tp, ms, strat in product(
            spec.datasets, spec.scenarios, spec.seeds,
            spec.concurrency_ratios, spec.staleness_fns, spec.data_planes,
            spec.control_planes, spec.fault_profiles,
            spec.traffic_profiles, spec.meshes, spec.strategies)
    ]
    keys = [r.key for r in runs]
    if len(set(keys)) != len(keys):
        dupes = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(f"sweep {spec.name!r} has duplicate cells: {dupes}")
    return runs
