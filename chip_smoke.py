#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda``)
and ``nvidia-smi``; imports neither ``jax`` nor the JAX package ``repro``.
Phases, each printed as one JSON line; any failure exits non-zero:

  1. card: name and power limit (``nvidia-smi``), torch/CUDA versions, the
     TF32 flags (both set False: convolutions would otherwise run in TF32);
  2. build: both kernels compiled from ``src/repro_torch/kernels/csrc``
     into ``build/kernels/`` (one ``nvcc`` per source, all started together);
  3. main path: the paper's MNIST setup at published width (MnistCNN,
     582,026 params; 200 clients on the 65/25/10 fleet, 100 per round,
     E=5, B=10, Adam 1e-3, CR=0.3) through ``Controller.run()``, once with
     ``apodotiko`` (3 rounds) and once with ``fedavg`` (1 round). Every
     kernel count is set to 0 just before each run and read just after;
     a kernel the run never launched fails the script. The result must be
     finite, of the model's shapes, with a consistent update store;
  4. profile: one more fedavg round under ``torch.profiler`` (device busy
     time, idle share, kernel time by name; informational, no limit);
  5. reference: a small ProxyCNN run on the card against the same run on
     the CPU (the kernels' plain versions), on one shared minibatch-index
     table: identical host trace, params within rtol 1e-4 / atol 1e-5;
  6. kernels: each kernel at the shapes the main path gave it, against its
     plain torch version on the same inputs (rtol 1e-5 / atol 1e-6), and
     timed (median of CUDA-event times) beside the plain version, one
     PyTorch library call where one computes the same function, and the
     bound: the larger of bytes / HBM rate and operations / fp32 rate.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet, fp32 outside the tensor cores
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
SEED = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


class NumpyBatchIndices:
    """Minibatch indices from a numpy generator, identical on every device:
    the card run and the CPU run of the reference phase share the table."""

    def __init__(self, seed: int, batch_size: int):
        self.rng = np.random.default_rng(seed)
        self.batch_size = batch_size

    def __call__(self, Kp, max_steps, n_i):
        n = np.maximum(n_i.cpu().numpy(), 1)[:, None, None]
        u = self.rng.random((Kp, max_steps, self.batch_size))
        return torch.as_tensor((u * n).astype(np.int64), device=n_i.device)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def host_trace(engine):
    hist = [(l.round, l.t_start, l.t_end, l.n_aggregated, l.n_stale)
            for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


# ---------------------------------------------------------------- main path
def paper_controller(strategy: str, rounds: int, data, dev):
    """The paper's MNIST setup (IV-A) at published width: MnistCNN, 200
    clients on the 65/25/10 fleet, 100 per round, E=5, B=10, Adam 1e-3,
    CR=0.3. Only the number of rounds is cut."""
    from repro_torch.core.controller import Controller, FLConfig
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.paper_models import MnistCNN

    cfg = FLConfig(n_clients=200, clients_per_round=100, rounds=rounds,
                   strategy=strategy, concurrency_ratio=0.3, local_epochs=5,
                   batch_size=10, optimizer="adam", lr=1e-3, seed=SEED)
    return Controller(cfg, MnistCNN(), data, list(paper_fleet(200)),
                      device=dev)


def run_main_path(strategy: str, rounds: int, data, dev):
    """One paper-width Controller run with the kernel counts zeroed just
    before and read just after. Returns (controller, record)."""
    from repro_torch.core import aggregation
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.staleness_agg import staleness_agg
    from repro_torch.models.paper_models import MnistCNN

    ctl = paper_controller(strategy, rounds, data, dev)
    rounds_log = []
    clock = [time.perf_counter()]

    def progress(log):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rounds_log.append({
            "round": log.round, "wall_s": now - clock[0],
            "accuracy": log.accuracy, "n_aggregated": log.n_aggregated,
            "n_stale": log.n_stale, "store_capacity": ctl.store.capacity,
            "agg_route": aggregation.last_path()})
        clock[0] = now

    guard0 = aggregation.guard_recomputes()
    staleness_agg.launches = 0
    fused_adam.launches = 0
    clock[0] = time.perf_counter()
    metrics = ctl.run(progress=progress)
    torch.cuda.synchronize()
    launches = {"staleness_agg": staleness_agg.launches,
                "fused_adam": fused_adam.launches}
    cohorts = collections.Counter(r.round for r in ctl.platform.invocations)
    record = {"strategy": strategy, "rounds": rounds_log,
              "cohort_sizes": [cohorts[r] for r in sorted(cohorts)],
              "launches": launches, "last_path": aggregation.last_path(),
              "guard_recomputes": aggregation.guard_recomputes() - guard0,
              "final_accuracy": metrics["final_accuracy"],
              "total_sim_time_s": metrics["total_time"],
              "n_params": ctl.spec.n_params,
              "row_width": ctl.store.row_width}
    emit("main_path", **record)

    # what comes out is right: the model's shapes, finite values, a
    # consistent update store, every kernel of the path launched
    if ctl.spec.n_params != 582_026:
        raise AssertionError(f"MnistCNN has {ctl.spec.n_params} params")
    if len(ctl.history) != rounds:
        raise AssertionError(f"{len(ctl.history)} of {rounds} rounds ran")
    template = MnistCNN().init(torch.Generator().manual_seed(0))
    for name, leaf in ctl.params.items():
        if tuple(leaf.shape) != tuple(template[name].shape):
            raise AssertionError(f"{name}: shape {tuple(leaf.shape)}")
        if leaf.device.type != "cuda" or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name}: not finite on the card")
    if not all(0.0 <= r["accuracy"] <= 1.0 for r in rounds_log):
        raise AssertionError("accuracy out of [0, 1]")
    pending = {r.update_row for r in ctl.db.results if not r.aggregated}
    live = set(map(int, ctl.store.live_rows()))
    if not pending <= live:
        raise AssertionError("a pending result lost its update row")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{strategy}: {name} was never launched")
    return ctl, record


def reference_phase(dev) -> None:
    """Small ProxyCNN run on the card vs the same run on the CPU."""
    from repro_torch.core.controller import Controller, FLConfig
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.staleness_agg import staleness_agg
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.proxy_models import ProxyCNN

    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    init = params_to_numpy(ProxyCNN(10).init(torch.Generator().manual_seed(1)))
    out = {}
    for strategy in ("fedavg", "apodotiko"):
        cfg = FLConfig(n_clients=10, clients_per_round=4, rounds=3,
                       local_epochs=1, batch_size=5, base_step_time=0.5,
                       round_timeout=200.0, strategy=strategy, seed=0)
        runs = {}
        for where in (dev, "cpu"):
            ctl = Controller(cfg, ProxyCNN(10), data,
                             list(paper_fleet(10)), device=where,
                             init_params=params_from_numpy(init, where))
            ctl.trainer.batch_indices = NumpyBatchIndices(7, 5)
            before = (staleness_agg.launches, fused_adam.launches)
            ctl.run()
            runs[str(where)] = (ctl, (staleness_agg.launches - before[0],
                                      fused_adam.launches - before[1]))
        (card, card_launches), (cpu, cpu_launches) = runs[str(dev)], runs["cpu"]
        if host_trace(card) != host_trace(cpu):
            raise AssertionError(f"{strategy}: host trace differs card vs cpu")
        if min(card_launches) <= 0 or max(cpu_launches) != 0:
            raise AssertionError(f"{strategy}: launches card {card_launches} "
                                 f"cpu {cpu_launches}")
        err = 0.0
        for name, leaf in card.params.items():
            a, b = leaf.cpu().numpy(), cpu.params[name].numpy()
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{strategy}: {name}")
            err = max(err, float(np.max(np.abs(a - b))))
        acc_card = [l.accuracy for l in card.history]
        acc_cpu = [l.accuracy for l in cpu.history]
        out[strategy] = {"params_max_abs_err": err, "acc_card": acc_card,
                         "acc_cpu": acc_cpu,
                         "rounds": len(card.history)}
    emit("reference", rtol=PARAM_RTOL, atol=PARAM_ATOL, **out)


def profile_round(data, dev, unprofiled_wall_s: float) -> None:
    """One more fedavg round of the main-path setup under torch.profiler
    (device activity only, to keep the host-side overhead small): device
    busy time as the union of kernel intervals, the idle share, and kernel
    time by name. The idle share is also given against the unprofiled
    wall time of the main path's fedavg round."""
    from torch.profiler import ProfilerActivity, profile

    ctl = paper_controller("fedavg", 1, data, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctl.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:                       # union of kernel intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy = busy_us / 1e6
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            entry = by_name[e.name[:90]]
            entry[0] += 1
            entry[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:12]
    emit("profile", strategy="fedavg", rounds=1, profiled_wall_s=wall,
         device_busy_s=busy, n_device_events=len(spans),
         idle_share=(1 - busy / wall) if busy else None,
         idle_share_vs_unprofiled=((1 - busy / unprofiled_wall_s)
                                   if busy else None),
         top=[{"name": n, "calls": c, "ms": ms} for n, (c, ms) in top])


# ------------------------------------------------------------------ kernels
def check(name: str, got, want) -> dict:
    """Kernel output vs plain output: the max abs error, the max abs error
    over the largest magnitude, and the allclose criterion as a ratio
    (``tol_ratio`` <= 1 passes)."""
    diff = (got - want).abs()
    max_abs = float(diff.max())
    tol_ratio = float((diff / (KERNEL_ATOL + KERNEL_RTOL * want.abs())).max())
    if tol_ratio > 1.0:
        raise AssertionError(f"{name}: kernel vs plain max abs {max_abs}, "
                             f"{tol_ratio} x the tolerance")
    return {"max_abs_err": max_abs,
            "max_rel_err": max_abs / float(want.abs().max()),
            "tol_ratio": tol_ratio}


def agg_kernel_entry(name: str, record: dict, dev, rows_form: bool) -> dict:
    """``staleness_agg`` at the shapes of the main path's last aggregate:
    the sweep form (weights scattered over the whole [C, W] buffer) or the
    rows form (only the K referenced rows)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import SUBLANE
    from repro_torch.kernels.staleness_agg import staleness_agg

    last = record["rounds"][-1]
    C, W = last["store_capacity"], record["row_width"]
    k = last["n_aggregated"]
    kp = k + (-k) % SUBLANE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    buf = torch.randn(C, W, device=dev, generator=gen) * 0.05
    rows = torch.randperm(C, device=dev, generator=gen)[:k]
    w = torch.rand(k, device=dev, generator=gen)
    w = w / w.sum()
    if rows_form:   # zero-weight repeats of row 0 pad K, as ops._pad_rows
        rows = torch.cat([rows, rows[:1].repeat(kp - k)])
        w = torch.cat([w, torch.zeros(kp - k, device=dev)])
        args = (buf, w, rows)
        nbytes = (k * W + W) * 4 + kp * (4 + 8)
        flops = 2 * k * W
        # one bag of the referenced rows, weighted and summed
        library = lambda: torch.nn.functional.embedding_bag(
            rows[None], buf, mode="sum", per_sample_weights=w[None])[0]
    else:
        full_w = torch.zeros(C, device=dev).index_add_(0, rows, w)
        args = (buf, full_w, None)
        nbytes = (C * W + C + W) * 4
        flops = 2 * C * W
        library = lambda: full_w @ buf
    got = staleness_agg(*args)
    torch.cuda.synchronize()
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/staleness_agg.cu",
             "replaces": "src/repro/kernels/staleness_agg.py:38",
             "launches": record["launches"]["staleness_agg"],
             "shape": {"C": C, "W": W, "K": k, "K_padded": kp,
                       "rows_form": rows_form},
             **check(name, got, ref.staleness_agg(*args))}
    entry["library_max_abs_diff"] = float((library() - got).abs().max())
    entry["ms"] = time_ms(lambda: staleness_agg(*args))
    entry["plain_ms"] = time_ms(lambda: ref.staleness_agg(*args))
    entry["library_ms"] = time_ms(library)
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops)
    entry["bytes"] = nbytes
    return entry


def adam_kernel_entry(record: dict, dev) -> dict:
    """``fused_adam`` at the main path's largest cohort: Kp lanes (the
    cohort padded to a power of two), the pad lanes inactive."""
    from repro_torch.core.client import DEFAULT_COHORT_FLOOR, _bucket
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam

    k = max(record["cohort_sizes"])
    kp, W = _bucket(k, DEFAULT_COHORT_FLOOR), record["row_width"]
    lr, b1, b2, eps, s = 1e-3, 0.9, 0.999, 1e-8, 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = torch.randn(kp, W, device=dev, generator=gen) * 0.05
    g = torch.randn(kp, W, device=dev, generator=gen) * 0.01
    m = torch.randn(kp, W, device=dev, generator=gen) * 1e-3
    v = torch.rand(kp, W, device=dev, generator=gen) * 1e-5
    steps = torch.zeros(kp, dtype=torch.int32, device=dev)
    steps[:k] = 150
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps)

    mine = [t.clone() for t in (p, m, v)]
    plain = [t.clone() for t in (p, m, v)]
    fused_adam(*mine, g, steps, s, **hyper)
    ref.fused_adam(*plain, g, steps, s, **hyper)
    torch.cuda.synchronize()
    errs = [check("fused_adam", a, b) for a, b in zip(mine, plain)]
    entry = {"name": "fused_adam", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fused_adam.cu",
             "replaces": "src/repro/kernels/fused_adam.py:52",
             "launches": record["launches"]["fused_adam"],
             "shape": {"Kp": kp, "W": W, "active_lanes": k},
             **{k: max(e[k] for e in errs) for k in errs[0]}}
    entry["ms"] = time_ms(lambda: fused_adam(*mine, g, steps, s, **hyper))
    entry["plain_ms"] = time_ms(
        lambda: ref.fused_adam(*plain, g, steps, s, **hyper))

    # yardstick: PyTorch's own fused Adam over the active lanes' rows
    lib = [list(t[:k].clone().unbind(0)) for t in (p, m, v)]
    grads = list(g[:k].unbind(0))
    step_t = [torch.tensor(float(s + 1), device=dev) for _ in range(k)]

    def library():
        torch._fused_adam_(lib[0], grads, lib[1], lib[2], [], step_t, lr=lr,
                           beta1=b1, beta2=b2, weight_decay=0.0, eps=eps,
                           amsgrad=False, maximize=False)

    entry["library_ms"] = time_ms(library)
    nbytes = k * W * 7 * 4 + kp * 4      # read p m v g, write p m v
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, k * W * 14)
    entry["bytes"] = nbytes
    return entry


# --------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        return fail("no CUDA card is available; this script runs only on one")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    for mod in ("jax", "repro"):          # the port must not need either
        sys.modules[mod] = None

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         build_dir=str(_build.BUILD_DIR),
         ptxas={k: [l.strip() for l in v.splitlines() if "registers" in l]
                for k, v in logs.items()})

    from repro_torch.data.synthetic import make_federated_dataset
    t0 = time.perf_counter()
    data = make_federated_dataset("mnist", n_clients=200, scale=1.0, seed=SEED,
                                  fidelity="paper")
    emit("data", seconds=time.perf_counter() - t0, X=list(data.X.shape),
         eval_n=len(data.eval_y))
    _, apo = run_main_path("apodotiko", 3, data, dev)
    _, avg = run_main_path("fedavg", 1, data, dev)
    reference_phase(dev)
    profile_round(data, dev, avg["rounds"][0]["wall_s"])

    kernels = [agg_kernel_entry("staleness_agg", avg, dev, rows_form=False),
               agg_kernel_entry("staleness_agg[rows]", apo, dev,
                                rows_form=True),
               adam_kernel_entry(apo, dev)]
    for e in kernels:
        emit("kernel", **e)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)   # the card's name and power limit, verbatim
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
