"""Named sweeps reproducing the paper's comparison tables (twin of
``repro.sweep.presets``; the specs are the reference's, field for field).

Each preset is a ``SweepSpec`` at bench scale (minutes); set
``SWEEP_FULL=1`` to lift any preset to the paper-scale grid (200 clients,
100/round — hours). Entry point:

    PYTHONPATH=src python examples/torch_sweep_paper_tables.py [preset]
"""
from __future__ import annotations

import os
from dataclasses import replace

from repro_torch.sweep.grid import (PAPER_SCALE, SMOKE_SCALE, SweepScale,
                                    SweepSpec)

ALL_STRATEGIES = ("fedavg", "fedprox", "scaffold", "fedlesscan", "fedbuff",
                  "apodotiko")
# Natively-reactive policies (scheduler-only; repro.core.strategies.reactive)
REACTIVE_STRATEGIES = ("apodotiko-hedge", "apodotiko-adaptive")

# 3-round hedging smoke: long enough for hedges to fire (the CR gate must
# leave stragglers outstanding), short enough for CI
SMOKE_HEDGE_SCALE = SweepScale(n_clients=8, clients_per_round=4, rounds=3,
                               data_scale=0.06, local_epochs=1,
                               sim_budget=1500.0)

# Open-loop load: enough rounds/sim-budget that every canned traffic
# profile actually bites (the flash-crowd surge lands at t=150, past a
# 6-round smoke run's end)
PROD_SCALE = SweepScale(n_clients=8, clients_per_round=4, rounds=12,
                        data_scale=0.06, local_epochs=1, sim_budget=900.0)

# Fleet-scale selection demo: the widest fleet a bench-scale FL run
# affords (selection/scoring at M=1e6 is benchmarked without training in
# benchmarks/bench_round.py --controlplane)
FLEET_SCALE = SweepScale(n_clients=256, clients_per_round=32, rounds=6,
                         data_scale=0.06, local_epochs=1, sim_budget=2_000.0)

PRESETS: dict[str, SweepSpec] = {
    # Tables IV-VI, one dataset at a time (all six strategies, paper's
    # heterogeneous 65/25/10 hardware mix)
    "paper_mnist": SweepSpec(name="paper_mnist", datasets=("mnist",)),
    "paper_femnist": SweepSpec(name="paper_femnist", datasets=("femnist",)),
    "paper_shakespeare": SweepSpec(name="paper_shakespeare",
                                   datasets=("shakespeare",)),
    "paper_speech": SweepSpec(name="paper_speech", datasets=("speech",)),
    # the full Table IV-VI grid
    "paper_tables": SweepSpec(name="paper_tables",
                              datasets=("mnist", "femnist", "shakespeare",
                                        "speech")),
    # Fig 1/3 hardware scenarios: does the speedup survive homogeneity?
    "hardware_scenarios": SweepSpec(
        name="hardware_scenarios", datasets=("mnist",),
        strategies=("fedavg", "fedlesscan", "apodotiko"),
        scenarios=("heterogeneous", "two-tier", "homogeneous")),
    # Fig 6: concurrency-ratio sensitivity of the async strategies
    "cr_sweep": SweepSpec(
        name="cr_sweep", datasets=("mnist",),
        strategies=("fedavg", "fedbuff", "apodotiko"),
        concurrency_ratios=(0.3, 0.5, 0.7)),
    # Eq. 1 vs Eq. 2 staleness damping ablation (paper §III-B)
    "staleness_ablation": SweepSpec(
        name="staleness_ablation", datasets=("mnist",),
        strategies=("fedavg", "apodotiko"), staleness_fns=("eq1", "eq2")),
    # Straggler-heavy hedging comparison: 75/25 cpu1-vs-gpu fleet, big cold
    # starts, keep-warm below the round cadence — every fresh straggler
    # invocation is cold while hedges ride the warm container, so the
    # reactive apodotiko-hedge policy's time-to-accuracy win is structural
    # (tests/test_reactive.py pins it)
    "straggler_hedge": SweepSpec(
        name="straggler_hedge", datasets=("mnist",),
        strategies=("fedavg", "apodotiko", "apodotiko-hedge"),
        scenarios=("straggler",),
        concurrency_ratios=(0.5,),
        overrides=(("cold_start_s", 120.0), ("keep_warm", 30.0),
                   ("hedge_fraction", 1.0))),
    # between-round CR adaptation vs fixed-CR async baselines
    "adaptive_cr": SweepSpec(
        name="adaptive_cr", datasets=("mnist",),
        strategies=("fedbuff", "apodotiko", "apodotiko-adaptive"),
        concurrency_ratios=(0.3,)),
    # device-vs-host data-plane ablation: same strategies, same seeds,
    # only the training-input transport differs — time-to-accuracy must
    # match (bit-identical traces, tests/test_data_plane.py) while wall
    # clock and H2D bytes diverge (BENCH_dataplane.json quantifies it)
    "dataplane_ablation": SweepSpec(
        name="dataplane_ablation", datasets=("mnist",),
        strategies=("fedavg", "apodotiko"),
        data_planes=("device", "host")),
    # columnar-vs-object control-plane ablation: same strategies, same
    # seeds, only the fleet-state backing differs — traces are
    # bit-identical (tests/test_control_plane.py) while the score+select
    # dispatch cost diverges (BENCH_controlplane.json quantifies it)
    "controlplane_ablation": SweepSpec(
        name="controlplane_ablation", datasets=("mnist",),
        strategies=("fedavg", "apodotiko"),
        control_planes=("columnar", "object")),
    # fleet-scale cohort selection: a 256-client fleet on the columnar
    # plane, Algorithm 3 sampling vs the device-resident top-k selector
    "fleet_scale": SweepSpec(
        name="fleet_scale", datasets=("mnist",),
        strategies=("fedavg", "apodotiko", "apodotiko-topk"),
        control_planes=("columnar",),
        scale=FLEET_SCALE),
    # fault-injection robustness grid (DESIGN.md §12): the same two
    # strategies under no faults vs each canned chaos profile, with the
    # retry/quarantine recovery layer armed — `fault_profile` is a group
    # axis, so every speedup ratio compares runs that suffered the same
    # seeded schedule
    "chaos": SweepSpec(
        name="chaos", datasets=("mnist",),
        strategies=("fedavg", "apodotiko"),
        fault_profiles=("none", "crash-heavy", "outage-window",
                        "lossy-network"),
        scale=SMOKE_SCALE,
        overrides=(("retry_budget", 8), ("invocation_timeout", 300.0),
                   ("quarantine_threshold", 3))),
    # open-loop production load (DESIGN.md §13): the same three
    # strategies under a fixed fleet vs each canned traffic profile —
    # `traffic_profile` is a group axis, so every ratio compares runs
    # that faced the same seeded arrival process, and the SLO columns
    # (p50/p99 round latency, cold-start rate, cost-per-round) say which
    # policy earns its keep under churn, diurnal load, and flash crowds
    "production_load": SweepSpec(
        name="production_load", datasets=("mnist",),
        strategies=("fedavg", "apodotiko", "apodotiko-hedge"),
        traffic_profiles=("none", "steady-churn", "diurnal", "flash-crowd"),
        concurrency_ratios=(0.5,),
        scale=PROD_SCALE,
        overrides=(("cold_start_s", 60.0), ("keep_warm", 120.0))),
    # CI-sized end-to-end check (two strategies, seconds)
    "smoke": SweepSpec(name="smoke", datasets=("mnist",),
                       strategies=("fedavg", "apodotiko"),
                       scale=SMOKE_SCALE),
    # CI-sized hedging check: 3-round apodotiko-hedge on the straggler mix
    "smoke_hedge": SweepSpec(
        name="smoke_hedge", datasets=("mnist",),
        strategies=("apodotiko", "apodotiko-hedge"),
        scenarios=("straggler",),
        concurrency_ratios=(0.5,),
        scale=SMOKE_HEDGE_SCALE,
        overrides=(("cold_start_s", 120.0), ("keep_warm", 30.0),
                   ("hedge_fraction", 1.0))),
}


def get_preset(name: str) -> SweepSpec:
    try:
        spec = PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown sweep preset {name!r}; available: "
                       f"{', '.join(sorted(PRESETS))}") from None
    if os.environ.get("SWEEP_FULL"):
        spec = replace(spec, scale=PAPER_SCALE)
    return spec
