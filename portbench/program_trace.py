"""Runs of one cell that read the program's own spans and counters: the
per-layer metrics that ``repro_torch.tracing`` and ``CohortTrainer``'s
lane-step counters feed (``metrics/lane_steps.useful.py``,
``host_us.step.py``, ``kernels.step.py``, ``device_idle.step.py``), the
card's idle time by the innermost span the host was in, and the check of
how the card's operations are placed on the spans' clock
(``hostclock.py``).

    python3 portbench/program_trace.py --workload femnist_cnn.apodotiko \\
        --seconds 40 --trace 1 --seeds 11 12 13

A run is ``harness.run_cell``'s, with a probe that also reads the four
counters and starts the program's span recorder at the window's open, and
stops both at its close. With ``--trace 0`` it is ``run.py --trace 0``
with the recorder on, so the two in turns give tracing's cost. One JSON
line a run on standard output: ``correct``, ``round_s``, ``setup_s``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, and those of the four that read: the two on the host
clock read untraced too), ``counters`` (the window's deltas), ``host``
(``harness.HostRecord``), and with ``--trace 1``:

  * ``kernels_step_by_lanes``: ``kernels.step`` by the cohort's padded
    lanes, flat if vmap folds the lanes, growing with them if not;
  * ``idle_by_span``: idle seconds by the innermost span, the harness's
    and the program's together, ``engine`` where none holds the host;
    they sum to the window less its busy seconds;
  * ``idle_gaps``: the breakdown's longest gaps, named by both span lists;
  * ``clock_lead``: ``hostclock.clock_check``, the most by which a
    placed ``fused_adam_kernel`` starts before its ``step.opt`` span, the
    most by which an operation the host waited on ends after the wait
    (sound placement reads each at most a few µs), and the skew of the
    card's own stamps that placement takes out.

``idle_by_span`` and ``clock_lead_us`` also go to standard error. The
interval arithmetic is ``hostclock.py``'s; once ``run.py`` reads the four
metrics, this script goes.

It needs a CUDA card (the tests call ``run`` on the CPU).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter, defaultdict  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import harness  # noqa: E402  (puts src/ on the path)
import devtrace  # noqa: E402
import hostclock  # noqa: E402
from repro_torch import tracing  # noqa: E402

COUNTERS = ("local_steps", "lane_steps_run", "lane_steps_useful",
            "lane_steps_pad")
METRICS = ("lane_steps.useful", "host_us.step", "kernels.step",
           "device_idle.step")


def counters(trainer) -> dict:
    return {k: getattr(trainer, k) for k in COUNTERS}


class SpanProbe(harness.Probe):
    """The harness's probe, which at the window's open and close (``drive``
    sets ``active``) also reads the trainer's lane-step counters and
    starts and stops the program's span recorder."""

    def __init__(self, sched, device, trace: bool, seed: int):
        self.program_spans, self.counters = [], {}
        super().__init__(sched, device, trace, seed)

    @property
    def active(self) -> bool:
        return self._active

    @active.setter
    def active(self, on: bool) -> None:
        was = getattr(self, "_active", False)
        self._active = on
        if on and not was:
            self._counters0 = counters(self.s.trainer)
            tracing.start()
        elif was and not on:
            self.program_spans = tracing.stop()
            now = counters(self.s.trainer)
            self.counters = {k: now[k] - self._counters0[k] for k in COUNTERS}


def kernels_by_lanes(spans: list, ops, lanes: list) -> dict:
    """Device operations a local step by the cohort's padded lanes:
    ``lanes[i]`` the lanes of the i-th ``cohort`` span."""
    launched = hostclock.launched_in(ops, spans, "cohort")
    steps = Counter(s.parent for s in spans if s.name == "step")
    tot = defaultdict(lambda: [0, 0])
    for i, kp in zip(sorted(launched), lanes):
        tot[kp][0] += launched[i]
        tot[kp][1] += steps[i]
    return {kp: n / st for kp, (n, st) in sorted(tot.items()) if st}


def read_metrics(ctx: dict) -> dict:
    out = {}
    for name in METRICS:
        value = harness.load_module(
            harness.HERE / "metrics" / f"{name}.py").read(ctx)
        if value is not None:
            out[name] = value
    return out


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None) -> dict:
    """One run of ``cell`` (``harness.run_cell``'s steps, with
    ``SpanProbe``); returns the run's line."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    with contextlib.ExitStack() as stack:
        sched, data = harness.build(cell, seed, device)
        harness.warm_buckets(sched, cell, device)
        probe = SpanProbe(sched, device, trace, seed)
        probe.install(stack)
        dtrace = (devtrace.DeviceTrace() if trace and device.type == "cuda"
                  else None)
        w = harness.drive(sched, probe, cell.mix, seconds, device, dtrace)
        res = harness.measure(cell, sched, probe, w, t_start, dtrace, device)
        base = res["base"]
        t0, t1 = w["ns0"], w["ns1"]
        spans = probe.program_spans
        lanes = [sched.trainer.cohort_bucket(len(losses))
                 for _, losses in probe.train_log]
        ctx = {"program_spans": spans, "counters": probe.counters,
               "window_s": base["window_s"], "rounds": base["rounds"]}
        line = {"workload": cell.name, "seed": seed, "trace": trace,
                "round_s": base["window_s"] / base["rounds"],
                "setup_s": base["setup_s"], "rounds": base["rounds"],
                "counters": probe.counters, "host": base["host"]}
        if dtrace is not None:
            ops = hostclock.device_ops(dtrace, t0, t1)
            off, idle = hostclock.place(ops, t0, t1)
            ctx["trace"] = {"window_s": (t1 - t0) / 1e9, "idle": idle,
                            "launch": np.sort(ops.launch[ops.launch >= 0])}
            named = probe.spans + [(s.name, s.start_ns, s.end_ns)
                                   for s in spans]
            line.update(
                busy_s=res["busy_s"], window_s=res["traced_window_s"],
                idle_by_span=hostclock.idle_by_span(idle, named),
                idle_gaps=hostclock.longest_gaps(idle, named),
                clock_lead=hostclock.clock_check(spans, ops, off),
                kernels_step_by_lanes=kernels_by_lanes(spans, ops, lanes))
            del ops, off, idle
        line["metrics"] = dict(
            {k: v["value"] for k, v in res["metrics"].items()},
            **read_metrics(ctx))
        n_params = sched.spec.n_params
        del sched, ctx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks, _ = harness.judge(cell, probe, data, n_params, device, False)
    line["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    line["checks"] = {k: c["value"] for k, c in checks.items()}
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cell = harness.Cell(args.workload)
    for i, seed in enumerate(args.seeds):
        line = run(cell, seed, args.seconds, bool(args.trace),
                   t_start=T_START if i == 0 else None)
        line["device"] = torch.cuda.get_device_name(0)
        if "idle_by_span" in line:
            print("idle_by_span " + " ".join(
                f"{n} {s!r}" for n, s in line["idle_by_span"].items()),
                file=sys.stderr)
            lead = line["clock_lead"]
            print(f"clock_lead_us {lead['us']!r} launch {lead['launch_us']!r}"
                  f" card {lead['card_us']!r} lag {lead['lag_us']!r}",
                  file=sys.stderr)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
