"""Declarative strategy-sweep engine (paper Tables IV-VI; twin of
``repro.sweep``).

Expand a strategy x seed x config grid, execute the cells concurrently on
the serverless simulator with shared data/model/fleet setup, and derive the
paper's comparison columns (time-to-accuracy, speedup vs. FedAvg, cold
starts, cost). Cells run on the CUDA card unless ``device="cpu"``::

    from repro_torch.sweep import get_preset, run_sweep
    table = run_sweep(get_preset("paper_mnist"))
    print(table.to_markdown())
"""
from repro_torch.sweep.engine import run_sweep
from repro_torch.sweep.grid import (
    BENCH_SCALE,
    PAPER_SCALE,
    SMOKE_SCALE,
    RunSpec,
    SweepScale,
    SweepSpec,
    expand_grid,
)
from repro_torch.sweep.presets import (ALL_STRATEGIES, PRESETS,
                                       REACTIVE_STRATEGIES, get_preset)
from repro_torch.sweep.results import SCHEMA, ResultTable
from repro_torch.sweep.runner import LocalRunner

__all__ = [
    "ALL_STRATEGIES", "BENCH_SCALE", "LocalRunner", "PAPER_SCALE", "PRESETS",
    "REACTIVE_STRATEGIES", "ResultTable", "RunSpec", "SCHEMA", "SMOKE_SCALE",
    "SweepScale", "SweepSpec", "expand_grid", "get_preset", "run_sweep",
]
