"""A run of every cell at a tiny size on the CPU (the kernels' plain
versions), held to the reference, and what it records of the host.

    PYTHONPATH=src python -m pytest -q portbench/test_portbench_runs.py
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402
from tinycells import TINY_CELLS, tiny  # noqa: E402


@pytest.mark.parametrize("name", TINY_CELLS)
def test_tiny_run_is_correct(name):
    """A whole run at a tiny size on the CPU (the kernels' plain versions):
    every check within its limit, the window counted."""
    res = harness.run_cell(tiny(name), 2 ** 33 + 17, TINY_CELLS[name],
                           False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["base"]["rounds"] >= 3
    assert res["base"]["attempted"] > 0 and res["base"]["failed"] == 0
    metrics = res["metrics"]
    assert set(metrics) == {m["name"] for m in tiny(name).end_to_end}
    assert all(m["value"] > 0 for m in metrics.values())
    host = res["base"]["host"]
    assert host["cpu_s"] > 0 and host["cpus"] >= 1
    assert "sm_mhz_median" not in host          # no card, no nvidia-smi


def test_a_fused_window_is_refused(monkeypatch):
    """The harness sees the layers of stepwise rounds only: a window in
    which a round fuses raises instead of reading them as idle."""
    cell = tiny("femnist_cnn.apodotiko")
    build = harness.build

    def fusing(*args):
        sched, data = build(*args)
        run = sched.run

        def run_and_count(progress=None):
            def count(log):
                sched.megastep_rounds += 1
                progress(log)
            return run(progress=count)
        sched.run = run_and_count
        return sched, data
    monkeypatch.setattr(harness, "build", fusing)
    with pytest.raises(RuntimeError, match="ran fused"):
        harness.run_cell(cell, 3, 0.1, False, device="cpu")
