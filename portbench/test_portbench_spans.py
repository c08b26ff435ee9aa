"""The program's spans and counters as ``program_trace.py`` reads them: a
tiny traced run on the CPU, the placement and interval arithmetic of
``hostclock.py``, and on the card the device-trace readers and the check
of the placement against the spans.

    PYTHONPATH=src python -m pytest -q portbench/test_portbench_spans.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402
import hostclock  # noqa: E402
import program_trace  # noqa: E402
from tinycells import BENCH, TINY_CELLS, tiny  # noqa: E402

CELL = "femnist_cnn.apodotiko"


def test_tiny_traced_run_reads_the_program():
    """``lane_steps.useful`` and ``host_us.step`` read; the device-trace
    readers read nothing on the CPU, and the run stays correct."""
    line = program_trace.run(tiny(CELL), 2 ** 33 + 5, TINY_CELLS[CELL], True,
                             device="cpu")
    assert line["correct"], line["checks"]
    c = line["counters"]
    assert c["lane_steps_run"] >= c["lane_steps_useful"] + c["lane_steps_pad"]
    assert c["lane_steps_run"] > 0 and c["local_steps"] > 0
    m = line["metrics"]
    assert 0 < m["lane_steps.useful"] <= 100
    assert m["host_us.step"] > 0
    assert "kernels.step" not in m and "device_idle.step" not in m
    assert "idle_by_span" not in line


def test_idle_is_named_by_the_innermost_span():
    """Idle splits where spans begin and end; each piece goes to the
    shortest span holding it, ``engine`` outside every span (before the
    first, after the last), and the parts sum to the idle time, gaps that
    overlap once placed included."""
    spans = [("train", 10, 90), ("cohort", 20, 80), ("step", 30, 40),
             ("step", 50, 60)]
    idle = [(0, 15), (35, 55), (85, 100)]
    out = hostclock.idle_by_span(idle, spans)
    assert out == pytest.approx({"engine": 20e-9, "train": 10e-9,
                                 "step": 10e-9, "cohort": 10e-9})
    assert sum(out.values()) == pytest.approx(50e-9)
    out = hostclock.idle_by_span([(32, 38), (36, 45)], spans)
    assert out == pytest.approx({"step": 10e-9, "cohort": 5e-9})
    assert hostclock.longest_gaps(idle, spans, 2) == [
        ["cohort", 20e-9], ["engine", 15e-9]]


def _ops(rows, names=("k",)):
    """``Ops`` from ``(start, end, launch, name index)`` rows by start."""
    a = np.array(rows, np.int64).reshape(-1, 4)
    return hostclock.Ops(a[:, 0], a[:, 1], a[:, 2], a[:, 3], list(names))


def test_each_operation_takes_the_tightest_launch_bound_nearby():
    """An operation launched into the idle card (launch call 40 µs after
    its card stamp) pins the offset for those within ``WINDOW_NS``, the
    queued ones (launched long before they ran) included, so none is
    placed before its launch call; one farther off keeps its own bound,
    one with no launch call nearby the profiler's shift (0). Each gap
    keeps its length and moves with the operation that ends it, so the
    gaps sum to the window less the busy time."""
    ms = 1_000_000
    ops = _ops([(0, 100_000, -50_000, 0), (105_000, 200_000, -9 * ms, 0),
                (300_000, 400_000, 340_000, 0),
                (20 * ms, 20 * ms + 10, 20 * ms - 30, 0),
                (40 * ms, 40 * ms + 10, -1, 0)])
    off, idle = hostclock.place(ops, 0, 50 * ms)
    assert off.tolist() == [40_000, 40_000, 40_000, -30, 0]
    assert (ops.start + off >= ops.launch)[ops.launch >= 0].all()
    assert idle == [(140_000, 145_000), (240_000, 340_000),
                    (399_970, 20 * ms - 30), (20 * ms + 10, 40 * ms),
                    (40 * ms + 10, 50 * ms)]
    busy = int((ops.end - ops.start).sum())
    assert sum(b - a for a, b in idle) == 50 * ms - busy


def test_kernels_by_lanes_counts_the_ops_launched_in_each_cohort():
    """Operations whose launch call lies inside each cohort span, over its
    steps, pooled by the cohort's lanes; the card's own stamps (here all
    outside every cohort) do not count."""
    Span = program_trace.tracing.Span
    spans = [Span("cohort", 0, 10, -1, 0), Span("step", 1, 5, 0, 0),
             Span("step", 5, 9, 0, 0), Span("cohort", 20, 30, -1, 0),
             Span("step", 21, 29, 3, 0), Span("cohort", 40, 50, -1, 1),
             Span("step", 41, 49, 5, 1)]
    ops = _ops([(100 + t, 101 + t, t, 0)
                for t in (2, 3, 6, 7, 15, 22, 23, 24, 42)])
    assert program_trace.kernels_by_lanes(spans, ops, [4, 8, 4]) == {
        4: 5 / 3, 8: 3.0}


def test_clock_check_reads_the_placement_against_the_host():
    """The i-th ``step.opt`` span against the i-th placed
    ``fused_adam_kernel`` (placed 25 and 10 ns after the spans' starts: no
    lead), its launch call (20 and 10 ns after), its card stamp (30 ns
    before its launch call); and the copy launched inside a ``.wait`` span
    ending, placed, 5 ns before the span does."""
    Span = program_trace.tracing.Span
    spans = [Span("step.opt", 100, 200, -1, 0),
             Span("step.opt", 300, 400, -1, 0),
             Span("cohort.wait", 500, 600, -1, 0)]
    ops = _ops([(90, 95, 120, 0), (150, 160, 130, 1), (280, 290, 310, 0),
                (560, 590, 510, 1)], ("fused_adam_kernel", "copy"))
    off = np.array([35, 35, 30, 5])
    assert hostclock.clock_check(spans, ops, off) == {
        "us": -0.01, "launch_us": -0.01, "card_us": 0.03, "lag_us": -0.005,
        "step_opt": 2, "fused_adam": 2}


@pytest.mark.cuda
def test_program_spans_on_card(cuda_device):
    """A traced run on the card reads all four metrics; no placed
    ``fused_adam`` kernel starts more than 50 µs before the ``step.opt``
    span that launched it, nor its launch call (the program's clock and
    the profiler's host stamps agree), and no operation the host waited on
    ends more than 50 µs after the wait; the idle by span sums to the
    window less its busy time."""
    line = program_trace.run(harness.Cell(CELL, BENCH), 2 ** 31 + 99, 4.0,
                             True, device=cuda_device)
    assert line["correct"], line["checks"]
    assert set(program_trace.METRICS) <= set(line["metrics"])
    lead = line["clock_lead"]
    assert lead["step_opt"] == lead["fused_adam"] > 0
    assert lead["us"] <= 50 and lead["launch_us"] <= 50, lead
    assert lead["lag_us"] <= 50, lead
    idle = sum(line["idle_by_span"].values())
    assert idle == pytest.approx(line["window_s"] - line["busy_s"], rel=1e-3)
