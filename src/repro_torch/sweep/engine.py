"""Concurrent sweep execution (twin of ``repro.sweep.engine``): expand the
grid, run every cell, build the comparison table.

Runs execute on a thread pool (``max_workers`` arg or ``SWEEP_WORKERS`` env,
default 1): torch releases the GIL inside its kernels and the card runs
what the threads queue, so concurrent cells overlap host and device work.
Shared setup (datasets, models, fleets) is pre-warmed serially before the
pool starts, so worker threads never duplicate it.

Under a mesh other than ``1x1`` (a cell's ``mesh``, ``sharding.flmesh``)
every rank runs the sweep and every cell's engine runs collectives over
the ranks' group, so the cells run one at a time, in the grid's order, on
every rank: threads would interleave one rank's collectives across cells
and deadlock the group. ``max_workers > 1`` with such a grid raises.

Results are collected by grid index — the output table is byte-identical
for any worker count or completion order. A cell that raises becomes an
``error`` row instead of poisoning the sweep.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from repro_torch.sharding.flmesh import resolve_mesh
from repro_torch.sweep.grid import SweepSpec, expand_grid
from repro_torch.sweep.results import ResultTable
from repro_torch.sweep.runner import LocalRunner

Progress = Callable[[int, int, object, dict], None]


def run_sweep(spec: SweepSpec, runner: Optional[Callable] = None,
              max_workers: Optional[int] = None,
              progress: Optional[Progress] = None,
              device=None) -> ResultTable:
    """Execute ``spec`` and return its ``ResultTable``.

    ``runner``: any callable ``RunSpec -> metrics dict`` (defaults to
    ``LocalRunner(spec.scale, device=device)``: the CUDA card unless
    ``device="cpu"``); inject a stub for tests or a remote executor for
    distributed sweeps."""
    runs = expand_grid(spec)
    if max_workers is None:
        max_workers = int(os.environ.get("SWEEP_WORKERS", "1"))
    meshed = sorted({r.mesh for r in runs if resolve_mesh(r.mesh) != "1x1"})
    if meshed and max_workers > 1:
        raise ValueError(
            f"a sweep over mesh {meshed} runs its cells one at a time on "
            f"every rank (their collectives share one process group); got "
            f"max_workers={max_workers}")
    max_workers = max(1, min(max_workers, len(runs)))
    if runner is None:
        runner = LocalRunner(spec.scale, device=device)
    if hasattr(runner, "warm"):
        runner.warm(runs)

    metrics: list[Optional[dict]] = [None] * len(runs)

    def one(i: int) -> None:
        try:
            m = runner(runs[i])
        except Exception as e:  # noqa: BLE001 — keep the sweep alive
            m = {"error": f"{type(e).__name__}: {e}"}
        metrics[i] = m
        if progress:
            progress(i, len(runs), runs[i], m)

    if max_workers == 1:
        for i in range(len(runs)):
            one(i)
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            list(ex.map(one, range(len(runs))))

    return ResultTable.from_runs(spec.name, runs, metrics)
