"""One run of one cell: build the program's engine from the benchmark's
inputs, warm it up, measure a window of whole FL rounds, read the layer
metrics, then decide ``correct`` against the plain reference.

The program under test is ``repro_torch`` (``build_engine(...).run()``).
The harness wraps a few of the engine's calls from outside, never editing
the program, at points that every round of a stepwise cell passes:

  * cohort training: ``CohortTrainer.train_cohort_indexed``, and the
    trainer's minibatch draw ``batch_indices`` and gradient function
    ``_grad_fn``;
  * selection: the strategy's ``select``;
  * optimizer: the trainer optimizer's ``cohort_step``;
  * aggregation: ``weighted_aggregate_rows`` as the engine calls it;
  * evaluation.

The fused megastep's body calls none of these, so a window in which a
round fuses is refused rather than measured with its layers unseen.

In an untraced run these wrappers only count and, at the few calls the
seed samples for the check, copy the inputs and outputs that the
reference needs. In a traced run they also record host spans (drained
with ``torch.cuda.synchronize`` at both ends) and CUDA events, and a
profiler session covers the window.

A window opens at the close of the last warm-up round and closes at the
first round close at or past ``--seconds`` (and no sooner than the
sampled calls' rounds), watched through ``run(progress=...)``.

Beside the window the harness records what the host and the card were
doing (``host_record``): the process's CPU seconds and involuntary
context switches, the host's load, and the card's SM clock, power and
temperature sampled by ``nvidia-smi`` once a second, so that a run that
reads slow can be told apart from one that ran on a slow or busy machine.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import generate  # noqa: E402
import reference  # noqa: E402
import roofline  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
N_SAMPLED = 3            # a sampled call is one of the window's first three
#                          (and a window holds at least three rounds)
N_LANES = 4              # lanes a sampled cohort checks, beside its longest


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A python file of the benchmark, by path (names may hold dots)."""
    name = "portbench_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str, e2e: list) -> bool:
    """A metric with ``workloads`` applies to those cells; one without, to
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e


class Cell:
    """A workload of ``BENCHMARK.json``: its configuration (sizes and plain
    reference) and its traffic mix, found by name."""

    def __init__(self, name: str, bench: dict | None = None,
                 config: dict | None = None):
        bench = bench or load_json(HERE.parent / "BENCHMARK.json")
        spec = {w["name"]: w for w in bench["workloads"]}[name]
        self.name = name
        self.chips = spec["chips"]
        self.config = config or load_json(
            HERE / "configs" / f"{spec['config']}.json")
        self.model_ref = load_module(HERE / "configs" / f"{spec['config']}.py")
        self.mix = load_json(HERE / "traffic" / f"{spec['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = [m["name"] for m in self.end_to_end]
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, name, e2e)]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    """Counters, spans and the sampled captures of one run."""

    def __init__(self, sched, device, trace: bool, seed: int):
        self.s, self.device, self.trace = sched, device, trace
        self.active = False
        rng = generate.streams(seed, 3)[2]
        self.pick = {k: int(rng.integers(0, N_SAMPLED))
                     for k in ("train", "agg", "select")}
        self.lane_key = rng.random(1 << 16)
        self.step_key = rng.integers(0, 1 << 30, 2)
        self.lanes = None            # the sampled cohort's checked lanes
        self.step = 0
        self.calls = {"train": 0, "agg": 0, "select": 0, "eval": 0}
        self.spans, self.opt_events, self.agg_events = [], [], []
        self.train_log = []          # (lane-steps, losses) a window call
        self.row_meta = {}           # row id -> (round trained, samples)
        self.width = None
        self.cap = {}                # the sampled calls' captures

    # ------------------------------------------------------------ spans
    @contextlib.contextmanager
    def span(self, name: str):
        if not (self.trace and self.active):
            yield
            return
        sync(self.device)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            sync(self.device)
            self.spans.append((name, t0, time.perf_counter_ns()))

    @contextlib.contextmanager
    def events(self, sink: list, nbytes: int):
        if not (self.trace and self.active and self.device.type == "cuda"):
            yield
            return
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        try:
            yield
        finally:
            e1.record()
            sink.append((e0, e1, nbytes))

    def _sampled(self, kind: str) -> bool:
        if not self.active:
            return False
        hit = self.calls[kind] == self.pick[kind]
        self.calls[kind] += 1
        return hit

    # ------------------------------------------------------------ hooks
    def install(self, stack: contextlib.ExitStack) -> None:
        import repro_torch.core.services as services
        s, tr = self.s, self.s.trainer
        tr.train_cohort_indexed = self._train_indexed(tr.train_cohort_indexed)
        tr.batch_indices = self._indices(tr.batch_indices)
        tr.opt = tr.opt._replace(cohort_step=self._opt(tr.opt.cohort_step))
        tr._grad_fn = self._grad(tr._grad_fn)
        s.strategy.select = self._select(s.strategy.select)
        s.evaluate = self._evaluate(s.evaluate)
        orig = services.weighted_aggregate_rows
        services.weighted_aggregate_rows = self._aggregate(orig)
        stack.callback(setattr, services, "weighted_aggregate_rows", orig)

    def _indices(self, orig):
        def batch_indices(kp, max_steps, n_i):
            out = orig(kp, max_steps, n_i)
            if self.lanes is not None:
                self.cap["train"]["prog_idx"] = out
            return out
        return batch_indices

    def _begin_train(self, params, clients, steps):
        """At the sampled cohort: the generator's position, the global
        model, and which lanes and local steps the check follows."""
        self.step = 0
        if not self._sampled("train"):
            return False
        K = int((steps > 0).sum())
        self.lanes = lane_choice(self, K, steps)
        self.lane_steps = steps
        mid = self.step_key % max(int(steps.max()) - 3, 1) + 3
        self.checked = ({0, 1, 2} | {int(m) for m in mid}
                        | {int(steps[l]) - 1 for l in self.lanes})
        self.cap["train"] = {
            "gen_state": self.s.trainer.generator.get_state().clone(),
            "params0": {k: v.detach().clone() for k, v in params.items()},
            "clients": np.asarray(clients[:K], np.int64), "lanes": self.lanes,
            "steps": {}, "loss": {}}
        return True

    def _end_train(self, buffer, rows) -> None:
        """After the sampled cohort: the rows its lanes landed in."""
        t = torch.as_tensor(np.asarray(rows)[self.lanes], device=self.device)
        self.cap["train"]["rows"] = buffer[t]
        self.lanes = None

    def _train_indexed(self, orig):
        def train_cohort_indexed(params, store, selection, n_i, steps,
                                 *args, update_sink=None, **kw):
            sampled = self._begin_train(params, np.asarray(selection),
                                        np.asarray(steps))
            with self.span("train"):
                out = orig(params, store, selection, n_i, steps, *args,
                           update_sink=update_sink, **kw)
            ids, losses = np.asarray(out[0]), np.asarray(out[2])
            for k, row in enumerate(ids):
                self.row_meta[int(row)] = (self.s.db.round, int(n_i[k]))
            if self.active:
                self.train_log.append((int(np.sum(steps)), losses))
            if sampled:
                self._end_train(update_sink.buffer, ids)
            return out
        return train_cohort_indexed

    def _grad(self, orig):
        def grad_fn(params, X, y, params0):
            g, loss = orig(params, X, y, params0)
            if self.lanes is not None and self.step in self.checked:
                t = torch.as_tensor(self._lanes_at(self.step),
                                    device=loss.device)
                self.cap["train"]["loss"][self.step] = loss[t]
            return g, loss
        return grad_fn

    def _lanes_at(self, s: int) -> list:
        return [l for l in self.lanes if self.lane_steps[l] > s]

    def _opt(self, orig):
        def cohort_step(flat, state, g, steps, s):
            self.width = flat.shape[1]
            rec = None
            if self.lanes is not None and s in self.checked:
                lanes = self._lanes_at(s)
                t = torch.as_tensor(lanes, device=flat.device)
                rec = {"lanes": lanes, "p0": flat[t], "m0": state["m"][t],
                       "v0": state["v"][t], "g": g[t]}
            with self.events(self.opt_events, 0):
                orig(flat, state, g, steps, s)
            if rec is not None:
                rec.update(p1=flat[t], m1=state["m"][t], v1=state["v"][t])
                self.cap["train"]["steps"][s] = rec
            self.step = s + 1
        return cohort_step

    def _select(self, orig):
        def select(db, round_):
            sampled = self._sampled("select") and db.columnar and \
                self.s.strategy.name == "apodotiko"
            if sampled:
                f = db.fleet
                order = f.ordered_slots()
                state = {c: getattr(f, c)[order].copy() for c in (
                    "ids", "status", "quarantined_until", "n_invocations",
                    "booster", "dur_len", "cardinality", "local_epochs",
                    "batch_size")}
                state["durations"] = f.durations[order].copy()
                state["round"] = db.round
                state["rng"] = self.s.strategy.rng.bit_generator.state
            with self.span("select"):
                out = orig(db, round_)
            if sampled:
                self.cap["select"] = {
                    "state": state, "sel": list(out),
                    "booster": db.fleet.booster[order].copy()}
            return out
        return select

    def _aggregate(self, orig):
        def weighted_aggregate_rows(buffer, row_idx, weights, spec,
                                    *args, **kw):
            rows = [int(r) for r in row_idx]
            sampled = self._sampled("agg")
            if sampled:
                self.cap["agg"] = {
                    "rows": buffer[torch.as_tensor(rows,
                                                   device=buffer.device)],
                    "meta": [self.row_meta[r] for r in rows],
                    "T": self.s.db.round}
            nbytes = roofline.aggregation_bytes(len(rows), buffer.shape[1])
            with self.span("aggregate"), self.events(self.agg_events,
                                                     nbytes):
                out = orig(buffer, row_idx, weights, spec, *args, **kw)
            if sampled:
                self.cap["agg"]["out"] = reference.ravel(out)
            return out
        return weighted_aggregate_rows

    def _evaluate(self, orig):
        def evaluate():
            if self.active:
                self.calls["eval"] += 1
            with self.span("evaluate"):
                return orig()
        return evaluate


def build(cell: Cell, seed: int, device):
    """The program's engine for ``cell`` at ``seed``, from the benchmark's
    dataset, fleet and weights. The FL schedule (hardware, the platform's
    noise, selection and minibatch draws: ``FLConfig.seed``) is the mix's
    ``schedule_seed``, so every seed runs the same rounds of the same
    cohorts; the seed changes the images, labels and weights."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.core.services import FLConfig
    from repro_torch.data.synthetic import FederatedDataset
    from repro_torch.faas.hardware import HardwareProfile
    from repro_torch.models.paper_models import build_paper_model

    cfg = cell.config
    n_clients = cfg["fl"]["n_clients"]
    data = generate.make_dataset(cfg["dataset"], n_clients, seed)
    schedule = cell.mix["schedule_seed"]
    fleet = [HardwareProfile(*p)
             for p in generate.make_fleet(cfg["fleet"], n_clients, schedule)]
    weights = generate.make_weights(cell.model_ref.LEAVES, seed, device)
    fl = dict(cfg["fl"], **cell.mix["fl"])
    fl.update(rounds=10 ** 9, seed=schedule)
    sched = build_engine(
        FLConfig(**fl), build_paper_model(cfg["model"]),
        FederatedDataset(data.X, data.y, data.n, data.eval_x, data.eval_y),
        fleet, init_params=weights, device=device)
    return sched, data


def warm_buckets(sched, cell, device) -> None:
    """One local step of a throwaway trainer at every cohort bucket up to
    the cell's cohort (2, 4, ..., 128 lanes), so that no convolution shape
    is first met inside the window; the engine's own generator and rows
    are untouched."""
    from repro_torch.core.client import CohortTrainer
    fl = cell.config["fl"]
    trainer = CohortTrainer(sched.model, optimizer=fl["optimizer"],
                            lr=fl["lr"], batch_size=fl["batch_size"],
                            device=device)
    lanes = 2
    while True:
        sel = np.arange(lanes) % fl["n_clients"]
        trainer.train_cohort_indexed(sched.params, sched.dataset, sel,
                                     sched.data.n[sel],
                                     np.ones(lanes, np.int64))
        if lanes >= fl["clients_per_round"]:
            return
        lanes *= 2


def launches() -> dict:
    from repro_torch.kernels import launch_counts
    return launch_counts()


class HostRecord:
    """What the host and the card did over a window: the process's CPU
    seconds and involuntary context switches, the host's one-minute load
    at the close, and the card's SM clock, power draw, power limit and
    temperature, sampled by ``nvidia-smi`` once a second in a process of
    its own (none on a host without it)."""

    QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self, device):
        self.device, self.smi, self.out = device, None, {}

    def start(self) -> None:
        if self.device.type == "cuda" and shutil.which("nvidia-smi"):
            self.smi = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.cpu0 = time.process_time()
        self.csw0 = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw

    def stop(self, window_s: float) -> dict:
        cpu_s = time.process_time() - self.cpu0
        self.out = {
            "cpu_s": cpu_s, "cpu_share": cpu_s / window_s,
            "nivcsw": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
            - self.csw0,
            "load1": os.getloadavg()[0], "cpus": len(os.sched_getaffinity(0))}
        if self.smi is not None:
            self.smi.terminate()
            text, _ = self.smi.communicate()
            rows = []
            for line in text.splitlines():
                try:
                    rows.append([float(x) for x in line.split(",")])
                except ValueError:
                    continue
            if rows:
                sm, power, limit, temp = (np.array(c) for c in zip(*rows))
                self.out.update(
                    samples=len(rows), sm_mhz_min=float(sm.min()),
                    sm_mhz_median=float(np.median(sm)),
                    power_w_median=float(np.median(power)),
                    power_limit_w=float(limit.max()),
                    temp_c_max=float(temp.max()))
        return self.out


def drive(sched, probe: Probe, mix: dict, seconds: float, device,
          dtrace) -> dict:
    """Warm up, then run whole rounds until the first close at or past
    ``seconds``. Returns the window's clock and counters."""
    w = {}
    host = HostRecord(device)

    def open_window(closed: int):
        host.start()
        if dtrace is not None:
            dtrace.start()
        sync(device)
        w.update(t0=time.perf_counter(), ns0=time.perf_counter_ns(),
                 closes=[], round0=closed, fused0=sched.megastep_rounds,
                 launches0=launches())
        probe.active = True

    def close_window(closed: int):
        sync(device)
        w.update(t1=time.perf_counter(), ns1=time.perf_counter_ns(),
                 round1=closed, fused1=sched.megastep_rounds,
                 launches1=launches())
        probe.active = False
        w["host"] = host.stop(w["t1"] - w["t0"])
        if dtrace is not None:
            dtrace.stop()

    # the callback runs before the engine advances ``db.round``; a round
    # count it sets ends the run at this close
    def progress(log):
        closed = log.round + 1
        if "t0" not in w:
            if closed >= mix["warmup_rounds"]:
                open_window(closed)
        else:
            w["closes"].append(time.perf_counter())
            if (w["closes"][-1] - w["t0"] >= seconds
                    and closed - w["round0"] >= N_SAMPLED):
                close_window(closed)
                sched.cfg.rounds = closed
    sched.run(progress=progress)
    if w["fused1"] > w["fused0"]:
        raise RuntimeError(
            f"{w['fused1'] - w['fused0']} window rounds ran fused: the "
            "harness sees the layers of stepwise rounds only")
    return w


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object (and, with
    ``control``, the control's readings under ``control``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    with contextlib.ExitStack() as stack:
        sched, data = build(cell, seed, device)
        warm_buckets(sched, cell, device)
        probe = Probe(sched, device, trace, seed)
        probe.install(stack)
        dtrace = None
        if trace and device.type == "cuda":
            import devtrace
            dtrace = devtrace.DeviceTrace()
        w = drive(sched, probe, cell.mix, seconds, device, dtrace)
        window = measure(cell, sched, probe, w, t_start, dtrace, device)
        n_params = sched.spec.n_params
        del sched
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks, ctl = judge(cell, probe, data, n_params, device, control)
    window["checks"] = checks
    window["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    if control:
        window["control"] = ctl
    return window


def measure(cell, sched, probe, w, t_start, dtrace, device) -> dict:
    """The window's end-to-end numbers, or with a trace its layer
    metrics, and the run's counts."""
    rounds = w["round1"] - w["round0"]
    window_s = w["t1"] - w["t0"]
    invs = [r for r in sched.platform.invocations
            if w["round0"] <= r.round < w["round1"]]
    nonfinite = lane_steps = 0
    for steps, losses in probe.train_log:
        nonfinite += int((~np.isfinite(losses)).sum())
        lane_steps += steps
    samples = lane_steps * cell.config["fl"]["batch_size"]
    base = {
        "window_s": window_s, "rounds": rounds,
        "setup_s": w["t0"] - t_start,
        "round_walls": np.diff([w["t0"]] + w["closes"]).tolist(),
        "host": w["host"],
        "attempted": len(invs),
        "failed": sum(1 for r in invs if r.failed) + nonfinite,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
    }
    ctx = dict(base)
    ctx.update(spans=probe.spans,
               launches={k: w["launches1"][k] - w["launches0"][k]
                         for k in w["launches0"]})
    if probe.trace and device.type == "cuda":
        torch.cuda.synchronize(device)
        fwd, train = roofline.flops_per_sample(
            cell.model_ref, cell.config["dataset"]["shape"])
        n_eval = cell.config["dataset"]["n_eval"]
        ctx["flops"] = samples * train + probe.calls["eval"] * n_eval * fwd
        ctx["opt"] = (roofline.adam_bytes(lane_steps, probe.width or 0),
                      sum(a.elapsed_time(b) for a, b, _ in probe.opt_events)
                      / 1e3)
        ctx["agg"] = (sum(n for _, _, n in probe.agg_events),
                      sum(a.elapsed_time(b) for a, b, _ in probe.agg_events)
                      / 1e3)
        red = dtrace.reduce(w["ns0"], w["ns1"], probe.spans)
        for kernel, name in (("fused_adam", "fused_adam_kernel"),
                             ("staleness_agg", "staleness_agg_kernel")):
            seen = sum(c for n, c in red["counts"].items() if name in n)
            if seen < ctx["launches"][kernel]:
                raise RuntimeError(
                    f"the profiler saw {seen} {kernel} launches of the "
                    f"{ctx['launches'][kernel]} counted: its trace is "
                    "incomplete")
        ctx["trace"] = red
    metrics = {}
    if probe.trace:
        for m in cell.per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(
                ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = (base["setup_s"] if m["name"] == "setup_s"
                     else window_s / rounds)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"base": base, "metrics": metrics}
    if "trace" in ctx:
        out["breakdown"] = {k: ctx["trace"][k]
                            for k in ("device_ops", "idle_gaps")}
        out["busy_s"] = ctx["trace"]["busy_s"]
        out["traced_window_s"] = ctx["trace"]["window_s"]
    return out


def judge(cell, probe, data, n_params, device, control: bool):
    """The numbers compared with the reference, each beside its limit;
    with ``control``, the control's readings of the same numbers."""
    limits = cell.config["limits"]
    vals, ctl = {}, {}
    if "train" in probe.cap:
        v, c = check_training(cell, probe, data, n_params, device, control)
        vals.update(v)
        ctl.update(c)
    else:
        vals["train_missing"] = 1.0
    if "agg" in probe.cap:
        v, c = check_aggregation(probe, n_params, control)
        vals.update(v)
        ctl.update(c)
    else:
        vals["agg_missing"] = 1.0
    if "select" in probe.cap:
        vals["select_mismatch"] = float(check_selection(cell, probe))
    else:
        vals["select_missing"] = 1.0
    checks = {k: {"value": v, "limit": float(limits.get(k, 0.0))}
              for k, v in vals.items()}
    return checks, ctl


def lane_choice(probe, K: int, steps: np.ndarray) -> list:
    """The sampled lanes of a cohort of K: N_LANES drawn from the seed and
    the lane with the largest step budget."""
    drawn = np.argsort(probe.lane_key[:K])[:N_LANES].tolist()
    longest = int(np.argmax(steps[:K]))
    return sorted(set(drawn) | {longest})


def second_largest(gaps: list) -> float:
    """The second largest of ``gaps`` (its one value if it has one; 1, a
    failing reading, if it has none)."""
    return sorted(gaps)[-2] if len(gaps) > 1 else (gaps[0] if gaps else 1.0)


def check_training(cell, probe, data, n_params, device, control):
    """The sampled cohort, followed step by step from the program's own
    state at each checked step: the minibatch draw (exact), the start from
    the global model and the landed rows (exact), each step's loss and
    gradient against the reference's from the same parameters and batch,
    and Adam's step from the program's (p, m, v, g): the parameters it
    wrote and the moments it wrote, which the next step reads.

    Gaps are measured in a lane's first-step scales (its loss, each leaf's
    gradient and Adam step at step 0): late in local training the loss and
    its gradient shrink towards zero, where fp32's absolute rounding of a
    cross-entropy near 0 would read as a large relative gap. The gradient's
    gap is the median over the checked lane-steps of each one's worst
    leaf: a ReLU or max-pool input within rounding of its kink flips one
    lane-step's mask now and then, on either side, and that lane-step
    alone reads up to a few per cent. Beside the median, the second
    largest lane-step gap (``grad_gap_2nd``) lets one such flip pass and
    catches a backward fault confined to one lane or a few steps, which
    the median would let through. The moments' gap is each lane-step's
    worst leaf of m and v against the reference's, in that leaf's own
    norm: they are elementwise, with no kink to flip."""
    cap, cfg = probe.cap["train"], cell.config
    fl, leaves = cfg["fl"], cell.model_ref.LEAVES
    clients = cap["clients"]
    K = len(clients)
    Kp = reference.bucket(K)
    lanes_c = np.concatenate([clients, np.repeat(clients[-1:], Kp - K)])
    n = data.n[lanes_c]
    steps = reference.step_budget(n, fl["batch_size"], fl["local_epochs"])
    steps[K:] = 0
    idx = reference.minibatch_indices(cap["gen_state"], n, int(steps.max()),
                                      fl["batch_size"], device)
    prog_idx = cap.get("prog_idx")
    index_mismatch = (float((prog_idx != idx).sum())
                      if prog_idx is not None
                      and prog_idx.shape == idx.shape else float(idx.numel()))
    flat0 = reference.ravel(cap["params0"])
    xs = {c: (torch.as_tensor(data.X[c], device=device),
              torch.as_tensor(data.y[c], device=device))
          for c in set(lanes_c[cap["lanes"]].tolist())}
    vals = dict.fromkeys(("loss_gap", "opt_gap", "moment_gap"), 0.0)
    ctl = dict.fromkeys(("loss_gap", "moment_gap", "moment_gap.unwritten"),
                        0.0)
    grad_gaps, grad_lanes, ctl_grad, half_grad = [], [], [], []
    state_mismatch = 0
    landed = set()
    scales = {}                         # lane -> its step-0 scales
    for s, rec in sorted(cap["steps"].items()):
        for j, lane in enumerate(rec["lanes"]):
            p0 = rec["p0"][j, :n_params]
            if s == 0:
                state_mismatch += int((p0 != flat0).sum())
            x, y = xs[int(lanes_c[lane])]
            batch = (x[idx[lane, s]], y[idx[lane, s]])
            params = reference.unravel(p0, leaves)
            g_ref, loss_ref = reference.gradient(cell.model_ref, params,
                                                 *batch)
            m0, v0 = rec["m0"][j, :n_params], rec["v0"][j, :n_params]
            p1_ref, m1_ref, v1_ref = reference.adam_step(
                p0, m0, v0, rec["g"][j, :n_params], s + 1, fl["lr"],
                cfg["adam"])
            d_ref = reference.unravel(p1_ref - p0.double(), leaves)
            if s == 0:
                scales[lane] = (reference.leaf_norms(g_ref), loss_ref,
                                reference.leaf_norms(d_ref))
            g_scale, loss_scale, d_scale = scales[lane]
            g_prog = reference.unravel(rec["g"][j, :n_params], leaves)
            grad_gaps.append(reference.leaf_gap(g_prog, g_ref, g_scale))
            grad_lanes.append(lane)
            loss = float(cap["loss"][s][j])
            vals["loss_gap"] = max(vals["loss_gap"],
                                   abs(loss - loss_ref) / loss_scale)
            p1 = rec["p1"][j, :n_params]
            vals["opt_gap"] = max(vals["opt_gap"], reference.leaf_gap(
                reference.unravel(p1 - p0, leaves), d_ref, d_scale))
            vals["moment_gap"] = max(vals["moment_gap"], reference.moment_gap(
                rec["m1"][j, :n_params], rec["v1"][j, :n_params], m1_ref,
                v1_ref, leaves))
            if s == steps[lane] - 1:          # the row the lane landed in
                row = cap["rows"][cap["lanes"].index(lane)]
                state_mismatch += int((row != rec["p1"][j]).sum())
                landed.add(lane)
            if control:
                g_c, loss_c = reference.gradient(
                    cell.model_ref, params, *batch, cast=reference.tf32)
                ctl_grad.append(reference.leaf_gap(g_c, g_ref, g_scale))
                ctl["loss_gap"] = max(ctl["loss_gap"],
                                      abs(loss_c - loss_ref) / loss_scale)
                half = len(batch[0]) // 2       # the half-batch fault
                g_h, _ = reference.gradient(cell.model_ref, params,
                                            batch[0][:half], batch[1][:half])
                half_grad.append(reference.leaf_gap(g_h, g_ref, g_scale))
                # the moments stored in bf16, and left as they were read
                bf16 = [x.float().bfloat16() for x in (m1_ref, v1_ref)]
                ctl["moment_gap"] = max(ctl["moment_gap"], reference.moment_gap(
                    *bf16, m1_ref, v1_ref, leaves))
                ctl["moment_gap.unwritten"] = max(
                    ctl["moment_gap.unwritten"],
                    reference.moment_gap(m0, v0, m1_ref, v1_ref, leaves))
    vals["grad_gap"] = float(np.median(grad_gaps)) if grad_gaps else 1.0
    vals["grad_gap_2nd"] = second_largest(grad_gaps)
    if control:
        ctl["grad_gap"] = float(np.median(ctl_grad))
        ctl["grad_gap.half_batch"] = float(np.median(half_grad))
        ctl["grad_gap_2nd"] = second_largest(ctl_grad)
        # the half-batch fault confined to one lane, the lane where the
        # second largest gap reads least
        ctl["grad_gap_2nd.one_lane"] = min(
            second_largest([h if ln == lane else g for g, h, ln in zip(
                grad_gaps, half_grad, grad_lanes)])
            for lane in set(grad_lanes))
    # a lane whose last step the program did not take where the reference
    # takes it counts as one mismatch
    state_mismatch += len(set(cap["lanes"]) - landed)
    vals["index_mismatch"] = index_mismatch
    vals["state_mismatch"] = float(state_mismatch)
    return vals, ctl


def check_aggregation(probe, n_params, control):
    cap = probe.cap["agg"]
    rows = cap["rows"][:, :n_params]
    want = reference.aggregate(rows, cap["meta"], cap["T"])
    out = {"agg_gap": reference.relative_gap(cap["out"], want)}
    ctl = {}
    if control:
        ctl["agg_gap"] = reference.relative_gap(
            reference.aggregate(rows, cap["meta"], cap["T"],
                                cast=reference.tf32), want)
    return out, ctl


def check_selection(cell, probe) -> int:
    cap, fl = probe.cap["select"], cell.config["fl"]
    sel, booster = reference.select_apodotiko(
        cap["state"], fl["clients_per_round"], fl["adjustment_rate"])
    return int(sel != cap["sel"]) + int((booster != cap["booster"]).sum())
