#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda``)
and ``nvidia-smi``; imports neither ``jax`` nor the JAX package ``repro``.
Phases, each printed as one JSON line; any failure exits non-zero:

  1. card: name and power limit (``nvidia-smi``), torch/CUDA versions, the
     TF32 flags (both set False: convolutions would otherwise run in TF32);
  2. build: the five kernel sources compiled from
     ``src/repro_torch/kernels/csrc`` into ``build/kernels/`` (one ``nvcc``
     per source, all started together), with ptxas's register, spill and
     wgmma-serialisation lines;
  3. main path: the paper's MNIST setup at published width (MnistCNN,
     582,026 params; 200 clients on the 65/25/10 fleet, 100 per round,
     E=5, B=10, Adam 1e-3, CR=0.3) through ``build_engine(...).run()`` (the
     event-driven ``Scheduler``), with ``apodotiko`` (3 rounds), ``fedavg``
     (1 round) and ``apodotiko-topk`` (3 rounds). Every kernel count is
     set to 0 just before each run and read just after; a kernel of the
     run's path that it never launched fails the script (the top-k kernel,
     counted as ``block_topk``: at least once per round, and each
     ``select_topk`` timed). The result
     must be finite, of the model's shapes, with a consistent update store;
  4. fleet: the control plane at a million clients: ``select_topk(100,
     1.2)`` over a 2^20-slot ``FleetStore`` for five rounds on the card and
     on a CPU copy of the same state; selections and the device booster
     must be identical, and each call on the card one launch of the fused
     top-k kernel. Median ms per call, launches per call, and the
     dirty-slot flush (the host's share of a call) over 20 repetitions,
     whole and split into host packing, host-to-device copies and index
     writes; then the top-k past the kernel's k (the sort route, the
     reference's ``lax.top_k`` route): ``masked_topk`` at k = 4096 on the
     2^20 fleet-shaped scores and ``scored_topk`` at k = 1025 on the fleet
     state, bit-equal to the plain versions on the card and on the CPU,
     one sort a call and no kernel launch, each timed beside its byte
     bound and ``torch.topk`` at the same k;
  5. profile: one more fedavg round under ``torch.profiler`` (device busy
     time, idle share, kernel time by name; informational, no limit);
  6. reference: small ProxyCNN runs on the card against the same runs on
     the CPU (the kernels' plain versions), on one shared minibatch-index
     table, for ``fedavg``, ``apodotiko``, ``apodotiko-topk`` and
     ``apodotiko-hedge`` (hedges firing): identical host trace, params
     within rtol 1e-4 / atol 1e-5; and the ``Controller`` poll loop
     against the ``Scheduler`` on the card: identical host trace;
  7. compress: the apodotiko run's update (final minus initial MnistCNN
     params) through three ``compress_update`` calls with the error
     feedback carried, then ``decompress_update``, on the card and on a CPU
     copy: each card round's codes, scales and error equal to the plain
     version run on the card to the bit; codes and scales equal to the
     CPU copy's to the bit, the error and the decompressed update within
     rtol 1e-6 / atol 1e-7 of it; and exactly 3 fused ``compress_q8``
     launches, 1 ``dequantize_q8`` and no ``quantize_q8`` (counts zeroed
     just before the card calls, read just after);
  8. attention: causal ``flash_attention`` at qwen3-1.7b's attention width
     (16 heads of 128; k/v given 16 heads, grouped-query expansion being
     the caller's). Every check is per block of 128 query rows, at
     tol * (the block's rms + |value|), tol 1e-2 for bf16 and fp16 and
     2e-4 for fp32: a causal row's values shrink with its prefix, so the
     limit follows them. At 4,096 tokens, bf16, fp32 and fp16, against
     the plain version; at 1,024 tokens and head dim 96 (run padded to
     128), bf16 and fp32, against the plain version; at 32,768 tokens
     (bf16), whose plain version would need a 64 GiB score matrix, the
     first 4,096 query rows must equal the 4,096-token run to the bit and
     every row must match a plain computation of 1,024 rows at a time;
     each call one launch;
  9. kernels: each kernel at the shapes its path gave it, against its
     plain torch version on the same inputs (rtol 1e-5 / atol 1e-6;
     the top-k entries and the quant8 kernels exactly; attention by its
     phase's check), and timed (median of CUDA-event times) beside the
     plain version, one PyTorch library call where one computes the same
     function (``dequantize_q8``: ``torch.mul``, held to the bit;
     attention: ``scaled_dot_product_attention``; ``quantize_q8`` and
     ``compress_q8`` have none: ``compress_q8``, at the compress phase's
     update with its error feedback carried, is timed beside the stepwise
     path it replaces, event and device time), and the bound: the larger
     of bytes / HBM rate and operations / the peak rate of their type
     (fp32; the 16-bit tensor rate for bf16 and fp16 attention; for fp32
     attention, three TF32 products a product at the TF32 tensor rate,
     with the fp32 FMA time beside it). Attention has an entry per input
     type at 4,096 tokens (bf16 and fp16: the wgmma/TMA kernel; fp32: the
     kernel of three TF32 mma.sync products) and the bf16 one at 32,768,
     each with its achieved TFLOP/s. ``staleness_agg`` has two, the sweep
     form at the ``fedavg`` round's shape and the rows form at the
     ``apodotiko`` round's, each with two calls bit-equal, its column split
     on this card (``ctas``, ``pieces_per_cta``, ``piece_bytes_max``), the
     event time warm (``ms``) and with the L2 flushed before each call by
     256 MB of scratch written and read back outside the events
     (``flushed_ms``), the
     kernel's own profiler time both ways (``device_ms``,
     ``flushed_device_ms``), and ``bound_share``, the bound over the
     flushed device time. Top-k has four: ``block_topk`` (the
     one-launch ``masked_topk`` on seeded scores at M = 256) and
     ``block_topk[fleet]`` (at 2^20), each beside ``torch.topk``;
     ``scored_topk`` (the fused selection step at the ``apodotiko-topk``
     run's own state, M = 256, k = 100, beta 1.2: the main path's call)
     and ``scored_topk[fleet]`` (at the fleet phase's state), each beside
     the stepwise torch composition.

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
BF16_FLOP_PER_S = 989e12      # H100 SXM data sheet, dense bf16 (and fp16) tensor cores
TF32_FLOP_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
TF32_PRODUCTS = 3             # TF32 products per fp32 product (hi/lo split)
L2_FLUSH_BYTES = 256 << 20   # scratch written and read between flushed reps
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


def time_ms(fn, reps: int = 20, warmup: int = 3, before=None) -> float:
    """Median of per-call CUDA-event times, in ms; ``before`` (if given)
    runs ahead of each call, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(calls: dict, reps: int = 10) -> dict:
    """Median device time, by kernel name, of the kernels whose name holds
    each key of ``calls`` over ``reps`` calls of its function, all in one
    ``torch.profiler`` session (device activity only): the kernel's own
    time, without the host work of its wrapper, which a CUDA-event time of
    one short call includes. None for a name the profiler did not see:
    this time is informational, the contract's ``ms`` is the event time."""
    from torch.profiler import ProfilerActivity, profile
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for name in calls:
        times = [(e.time_range.end - e.time_range.start) / 1e3
                 for e in events if name in e.name]
        out[name] = statistics.median(times) if times else None
    return out


def device_total_ms(fn, reps: int = 10):
    """Device time of one call of ``fn``, all its kernels together: the sum
    of every device activity over ``reps`` calls in one ``torch.profiler``
    session, divided by ``reps``. None where the profiler saw nothing."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(spans) / reps if spans else None


def l2_flush(dev):
    """A function that writes ``L2_FLUSH_BYTES`` of scratch on ``dev``,
    several times the card's 50 MB L2, then reads it back: after it, a
    kernel finds none of its inputs in the L2, as a caller that last
    touched them a round ago does, and no dirty line of the scratch that
    the kernel would have to write back to make room."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    return lambda: scratch.fill_(1.0).sum()


def put_device_ms(entry: dict, key: str, ms) -> None:
    entry[key] = ms
    if ms is None:
        entry[f"{key}_note"] = "the profiler saw no such kernel"


def bound(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_wrappers() -> dict:
    """Every port kernel's wrapper, by name; each counts its launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.quant8 import (compress_q8, dequantize_q8,
                                            quantize_q8)
    from repro_torch.kernels.staleness_agg import staleness_agg
    from repro_torch.kernels.topk import block_topk
    return {"staleness_agg": staleness_agg, "fused_adam": fused_adam,
            "block_topk": block_topk, "quantize_q8": quantize_q8,
            "dequantize_q8": dequantize_q8, "compress_q8": compress_q8,
            "flash_attention": flash_attention}


def zero_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def path_kernels(strategy: str) -> tuple:
    """The kernels a run of ``strategy`` must launch."""
    base = ("staleness_agg", "fused_adam")
    return base + ("block_topk",) if strategy == "apodotiko-topk" else base


def host_trace(engine):
    hist = [(l.round, l.t_start, l.t_end, l.n_aggregated, l.n_stale)
            for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


# ---------------------------------------------------------------- main path
def paper_engine(strategy: str, rounds: int, data, dev):
    """The paper's MNIST setup (IV-A) at published width: MnistCNN, 200
    clients on the 65/25/10 fleet, 100 per round, E=5, B=10, Adam 1e-3,
    CR=0.3, through ``build_engine`` (the Scheduler). Only the number of
    rounds is cut."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.core.services import FLConfig
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.paper_models import MnistCNN

    cfg = FLConfig(n_clients=200, clients_per_round=100, rounds=rounds,
                   strategy=strategy, concurrency_ratio=0.3, local_epochs=5,
                   batch_size=10, optimizer="adam", lr=1e-3, seed=SEED)
    return build_engine(cfg, MnistCNN(), data, list(paper_fleet(200)),
                        device=dev)


def run_main_path(strategy: str, rounds: int, data, dev):
    """One paper-width run with every kernel count zeroed just before and
    read just after. Returns (engine, record)."""
    from repro_torch.core import aggregation
    from repro_torch.models.paper_models import MnistCNN

    ctl = paper_engine(strategy, rounds, data, dev)
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

    # each selection's wall time on the card (the dirty flush, the fused
    # selection launch and the copy of the cohort to the host), queued
    # work drained before it starts
    select_ms = []
    select_topk = ctl.db.fleet.select_topk

    def timed_select_topk(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = select_topk(*args, **kwargs)
        torch.cuda.synchronize()
        select_ms.append((time.perf_counter() - t) * 1e3)
        return out

    ctl.db.fleet.select_topk = timed_select_topk
    guard0 = aggregation.guard_recomputes()
    zero_counts()
    clock[0] = time.perf_counter()
    metrics = ctl.run(progress=progress)
    torch.cuda.synchronize()
    launches = read_counts()
    cohorts = collections.Counter(r.round for r in ctl.platform.invocations)
    record = {"strategy": strategy, "engine": metrics["engine"],
              "rounds": rounds_log,
              "cohort_sizes": [cohorts[r] for r in sorted(cohorts)],
              "launches": launches, "select_topk_ms": select_ms,
              "last_path": aggregation.last_path(),
              "guard_recomputes": aggregation.guard_recomputes() - guard0,
              "final_accuracy": metrics["final_accuracy"],
              "total_sim_time_s": metrics["total_time"],
              "n_params": ctl.spec.n_params,
              "row_width": ctl.store.row_width}
    emit("main_path", **record)

    # what comes out is right: the model's shapes, finite values, a
    # consistent update store, every kernel of the path launched
    if metrics["engine"] != "scheduler":
        raise AssertionError(f"build_engine ran {metrics['engine']}")
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
    for name in path_kernels(strategy):
        if launches[name] <= 0:
            raise AssertionError(f"{strategy}: {name} was never launched")
    if "block_topk" in path_kernels(strategy) and \
            min(launches["block_topk"], len(select_ms)) < rounds:
        raise AssertionError(f"{strategy}: block_topk launched "
                             f"{launches['block_topk']} times in "
                             f"{len(select_ms)} selections, {rounds} rounds")
    return ctl, record


def straggler_fleet(n: int) -> list:
    """The sweep's "straggler" hardware mix (75% 1vCPU, 25% GPU), as the
    reference's hedging presets use it."""
    from repro_torch.faas.hardware import HARDWARE_PROFILES
    rng = np.random.default_rng(0)
    n_slow = round(n * 0.75)
    fleet = ([HARDWARE_PROFILES["cpu1"]] * n_slow
             + [HARDWARE_PROFILES["gpu"]] * (n - n_slow))
    rng.shuffle(fleet)
    return fleet


# -------------------------------------------------------------------- fleet
FLEET_M, FLEET_CAPACITY, FLEET_K, FLEET_ROUNDS = 1_000_000, 1 << 20, 100, 5
FLEET_BETA, FLUSH_REPS = 1.2, 20


def fleet_store(where):
    """A million clients, each invoked three times with seeded durations
    (so selection scores, not only the uninvoked bootstrap), in a 2^20-slot
    columnar store whose device score state lives on ``where``."""
    from repro_torch.core.database import Database
    from repro_torch.core.fleet_store import FleetStore

    rng = np.random.default_rng(SEED)
    card = rng.integers(50, 500, FLEET_M).astype(np.int64)
    durs = rng.uniform(1.0, 60.0, (FLEET_M, 3))
    db = Database(control_plane="columnar")
    db.fleet = FleetStore(capacity=FLEET_CAPACITY, device=where)
    db.register_clients_bulk(np.arange(FLEET_M), card, 10, 5)
    db.fleet.bulk_history(durs)
    return db


def flush_split(fs, reps: int = FLUSH_REPS) -> dict:
    """The dirty-slot flush that ``select_topk`` runs before its launch,
    on ``fs``'s pending dirty slots (the last round's cohort), repeated
    ``reps`` times on the same slots: whole, and in its three parts, host
    packing (iterating the dirty set, gathering the columns), the
    host-to-device copies and the index writes on the card. Each is the
    median of wall times with the card drained before and after (host
    clock). The writes put back the values already there."""
    dirty = set(fs._dev_dirty)
    dev = fs._device()
    times = {"total": [], "host": [], "h2d": [], "write": []}

    def timed(part, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[part].append((time.perf_counter() - t) * 1e3)
        return out

    for _ in range(reps):
        fs._dev_dirty.update(dirty)
        timed("total", fs._flush_device)
        fs._dev_dirty.update(dirty)
        cols = timed("host", fs._dirty_columns)
        tensors = timed("h2d", lambda: dev.upload(*cols))
        timed("write", lambda: dev.write(*tensors))
    return {"slots": len(dirty), "reps": reps,
            "first_total_ms": times["total"][0],
            **{f"{part}_ms": statistics.median(t)
               for part, t in times.items()}}


def fleet_phase(dev) -> tuple[dict, object]:
    """Five rounds of ``select_topk`` at M = 1e6 on the card and on a CPU
    copy of the same state: each round selects, marks the cohort running,
    then completes it with seeded durations. Selections and the device
    booster must be identical, and each call on the card one launch.
    Returns the phase record and the card store's device score state."""
    from repro_torch.kernels.topk import block_topk

    t0 = time.perf_counter()
    card_db, cpu_db = fleet_store(dev), fleet_store("cpu")
    setup_s = time.perf_counter() - t0
    if card_db.fleet.capacity != FLEET_CAPACITY:
        raise AssertionError(f"capacity {card_db.fleet.capacity}")
    ms, launches = [], []
    for t in range(FLEET_ROUNDS):
        before = block_topk.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sel = card_db.fleet.select_topk(FLEET_K, FLEET_BETA)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        launches.append(block_topk.launches - before)
        before = block_topk.launches
        sel_cpu = cpu_db.fleet.select_topk(FLEET_K, FLEET_BETA)
        if block_topk.launches != before:
            raise AssertionError("the CPU store launched the kernel")
        if sel != sel_cpu or len(sel) != FLEET_K:
            raise AssertionError(f"round {t}: card and CPU selections differ")
        a = card_db.fleet._dev.booster.cpu().view(torch.int32)
        b = cpu_db.fleet._dev.booster.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"round {t}: device booster differs")
        for db in (card_db, cpu_db):
            for j, cid in enumerate(sel):
                db.mark_running(cid, t)
                db.mark_complete(cid, 1.0 + ((cid * 7 + j + t) % 50))
    record = {"M": FLEET_M, "capacity": FLEET_CAPACITY, "k": FLEET_K,
              "rounds": FLEET_ROUNDS, "setup_s": setup_s,
              "select_topk_ms": ms,
              "select_topk_median_ms": statistics.median(ms),
              "launches_per_call": launches,
              "flush": flush_split(card_db.fleet)}
    emit("fleet", **record)
    if launches != [1] * FLEET_ROUNDS:
        raise AssertionError(f"select_topk on the card launched {launches} "
                             "kernels per call, not one")
    return record, card_db.fleet._dev


SORT_K_MASKED, SORT_K_SCORED = 4096, 1025   # past the kernel's k <= 1024


def topk_sort_route_phase(state, dev) -> dict:
    """The top-k past the kernel's k (k > 1024: the sort route, the
    counterpart of the reference's ``lax.top_k`` route) at fleet scale on
    the card: ``ops.masked_topk`` at k = 4096 on the seeded 2^20
    fleet-shaped scores and ``ops.scored_topk`` at k = 1025 on the fleet
    phase's device state, each held to its plain version on the card and
    on CPU copies to the bit (vals and idx; idx, valid and the new
    booster). The sort route must run once a call (``masked_topk.sorts``)
    and the kernel never (``block_topk.launches``). Median ms a call, each
    beside its byte bound and ``torch.topk``'s time at the same k on the
    same scores."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.topk import block_topk, masked_topk

    s = topk_scores(FLEET_CAPACITY, dev)
    args = (state.num, state.den, state.booster, state.eligible, state.ever,
            FLEET_BETA, SORT_K_SCORED)
    sorts, launches = masked_topk.sorts, block_topk.launches
    vals, idx = ops.masked_topk(s, SORT_K_MASKED)
    got = ops.scored_topk(*args)
    torch.cuda.synchronize()
    counts = {"sorts": masked_topk.sorts - sorts,
              "kernel_launches": block_topk.launches - launches}
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args)
    wants = {"masked_topk": (ref.masked_topk(s, SORT_K_MASKED),
                             ref.masked_topk(s.cpu(), SORT_K_MASKED)),
             "scored_topk": (ref.scored_topk(*args),
                             ref.scored_topk(*cpu_args))}
    for name, result in (("masked_topk", (vals, idx)),
                         ("scored_topk", got)):
        for where, want in zip(("card", "CPU"), wants[name]):
            for a, b in zip(result, want):
                a, b = a.cpu(), b.cpu()
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} past k = 1024 differs "
                                         f"from the plain version on the "
                                         f"{where}")
    m = FLEET_CAPACITY
    # bytes as the kernel entries count them: the scores read and the k
    # values and int64 indices written; the step's 18 B a slot (num, den,
    # booster, eligible, ever read, the booster written) and 9 B a pick
    masked_bytes = 4 * m + 12 * SORT_K_MASKED
    scored_bytes = 18 * m + 9 * SORT_K_SCORED
    record = {"M": m, "masked_k": SORT_K_MASKED,
              "scored_k": SORT_K_SCORED, **counts, "exact": True,
              "scored_valid": int(got[1].sum()),
              "masked_ms": time_ms(lambda: ops.masked_topk(s, SORT_K_MASKED)),
              "scored_ms": time_ms(lambda: ops.scored_topk(*args)),
              "masked_bytes": masked_bytes,
              "masked_bound_ms": bound(masked_bytes, m)[0],
              "scored_bytes": scored_bytes,
              "scored_bound_ms": bound(scored_bytes, m)[0],
              # torch.topk on the same scores at each k (no ordering of
              # ties promised; a yardstick of time only)
              "masked_library_ms": time_ms(
                  lambda: torch.topk(s, SORT_K_MASKED)),
              "scored_library_ms": time_ms(
                  lambda: torch.topk(s, SORT_K_SCORED))}
    emit("topk_sort_route", **record)
    if counts != {"sorts": 2, "kernel_launches": 0}:
        raise AssertionError(f"past k = 1024: {counts}, want one sort a "
                             "call and no kernel launch")
    return record


def reference_phase(dev) -> None:
    """Small ProxyCNN runs on the card vs the same runs on the CPU, and the
    Controller poll loop vs the Scheduler on the card."""
    from repro_torch.core.controller import Controller
    from repro_torch.core.scheduler import Scheduler, build_engine
    from repro_torch.core.services import FLConfig
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.faas.hardware import paper_fleet
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.proxy_models import ProxyCNN

    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    init = params_to_numpy(ProxyCNN(10).init(torch.Generator().manual_seed(1)))
    base = dict(n_clients=10, clients_per_round=4, rounds=3, local_epochs=1,
                batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0)
    # the reference's smoke_hedge setting, on its straggler hardware mix
    hedge = dict(rounds=4, cold_start_s=120.0, keep_warm=30.0,
                 hedge_fraction=1.0, concurrency_ratio=0.5)
    out = {}
    for strategy in ("fedavg", "apodotiko", "apodotiko-topk",
                     "apodotiko-hedge"):
        kw = {**base, **(hedge if strategy == "apodotiko-hedge" else {}),
              "strategy": strategy}
        runs = {}
        for where in (dev, "cpu"):
            fleet = (straggler_fleet(10) if strategy == "apodotiko-hedge"
                     else list(paper_fleet(10)))
            eng = build_engine(FLConfig(**kw), ProxyCNN(10), data, fleet,
                               device=where,
                               init_params=params_from_numpy(init, where))
            eng.trainer.batch_indices = NumpyBatchIndices(7, 5)
            before = read_counts()
            m = eng.run()
            after = read_counts()
            runs[str(where)] = (eng, m, tuple(after[k] - before[k]
                                              for k in path_kernels(strategy)))
        (card, m_card, card_launches) = runs[str(dev)]
        (cpu, m_cpu, cpu_launches) = runs["cpu"]
        if host_trace(card) != host_trace(cpu):
            raise AssertionError(f"{strategy}: host trace differs card vs cpu")
        if min(card_launches) <= 0 or max(cpu_launches) != 0:
            raise AssertionError(f"{strategy}: launches card {card_launches} "
                                 f"cpu {cpu_launches}")
        if m_card["n_hedges"] != m_cpu["n_hedges"]:
            raise AssertionError(f"{strategy}: hedges differ")
        if strategy == "apodotiko-hedge" and m_card["n_hedges"] <= 0:
            raise AssertionError("apodotiko-hedge fired no hedge")
        err = 0.0
        for name, leaf in card.params.items():
            a, b = leaf.cpu().numpy(), cpu.params[name].numpy()
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{strategy}: {name}")
            err = max(err, float(np.max(np.abs(a - b))))
        acc_card = [l.accuracy for l in card.history]
        acc_cpu = [l.accuracy for l in cpu.history]
        out[strategy] = {"params_max_abs_err": err, "acc_card": acc_card,
                         "acc_cpu": acc_cpu, "rounds": len(card.history),
                         "engine": m_card["engine"],
                         "n_hedges": m_card["n_hedges"],
                         "card_launches": dict(zip(path_kernels(strategy),
                                                   card_launches))}

    # the poll loop against the Scheduler, both on the card
    cfg = FLConfig(**base, strategy="apodotiko")
    engines = []
    for cls in (Controller, Scheduler):
        eng = cls(cfg, ProxyCNN(10), data, list(paper_fleet(10)), device=dev,
                  init_params=params_from_numpy(init, dev))
        eng.trainer.batch_indices = NumpyBatchIndices(7, 5)
        eng.run()
        engines.append(eng)
    if host_trace(engines[0]) != host_trace(engines[1]):
        raise AssertionError("Controller and Scheduler traces differ")
    out["controller_vs_scheduler"] = {
        "identical_host_trace": True,
        "params_max_abs_diff": max(
            float((a - engines[1].params[n]).abs().max())
            for n, a in engines[0].params.items())}
    emit("reference", rtol=PARAM_RTOL, atol=PARAM_ATOL, **out)


def profile_round(data, dev, unprofiled_wall_s: float) -> None:
    """One more fedavg round of the main-path setup under torch.profiler
    (device activity only, to keep the host-side overhead small): device
    busy time as the union of kernel intervals, the idle share, and kernel
    time by name. The idle share is also given against the unprofiled
    wall time of the main path's fedavg round."""
    from torch.profiler import ProfilerActivity, profile

    ctl = paper_engine("fedavg", 1, data, dev)
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


# ----------------------------------------------------------------- compress
COMPRESS_ROUNDS = 3
COMPRESS_RTOL, COMPRESS_ATOL = 1e-6, 1e-7


def mnist_update(engine, dev) -> dict:
    """The run's update: its final global MnistCNN params minus the initial
    ones (the engine's seeded init, made again)."""
    from repro_torch.models.paper_models import MnistCNN
    init = MnistCNN().init(torch.Generator().manual_seed(SEED))
    return {k: v - init[k].to(dev, torch.float32)
            for k, v in engine.params.items()}


COMPRESS_LAUNCHES = {"compress_q8": COMPRESS_ROUNDS, "quantize_q8": 0,
                     "dequantize_q8": 1}


def compress_phase(update: dict, run: str) -> dict:
    """Three ``compress_update`` calls with the error feedback carried,
    then ``decompress_update``: on the card (counts zeroed just before, read
    just after), then on a CPU copy. Each card round's codes, scales and
    error must equal the plain version ``ref.compress_q8`` run on the card
    on the same inputs to the bit; codes and scales must equal the CPU
    copy's to the bit, the error and the decompressed update be allclose
    to it; the launches exactly one fused ``compress_q8`` a compress and one
    ``dequantize_q8`` for the decompress (``COMPRESS_LAUNCHES``). Returns
    the phase record."""
    from repro_torch.kernels import ops, ref

    def rounds(upd):
        err, out = None, []
        for _ in range(COMPRESS_ROUNDS):
            (q, s, spec), err = ops.compress_update(upd, err)
            out.append((q, s, err))
        return out, ops.decompress_update(q, s, spec), spec

    zero_counts()
    t0 = time.perf_counter()
    card, card_back, spec = rounds(update)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counts()
    cpu, cpu_back, _ = rounds({k: v.cpu() for k, v in update.items()})
    if read_counts() != launches:
        raise AssertionError("the CPU copy launched a kernel")
    n, n_pad = spec.n_params, card[0][0].shape[0]
    flat, ef = spec.ravel(update), None
    for r, (q, s, err) in enumerate(card):
        want = ref.compress_q8(flat, ef, n_pad)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   if a.dtype == torch.float32 else torch.equal(a, b)
                   for a, b in zip((q, s, err), want)):
            raise AssertionError(f"round {r}: compress differs from its "
                                 "plain version on the card")
        ef = err
    per_round = []
    for r, ((q, s, err), (q_c, s_c, err_c)) in enumerate(zip(card, cpu)):
        if not torch.equal(q.cpu(), q_c):
            raise AssertionError(f"round {r}: int8 codes differ card vs CPU")
        if not torch.equal(s.cpu().view(torch.int32), s_c.view(torch.int32)):
            raise AssertionError(f"round {r}: scales differ card vs CPU")
        torch.testing.assert_close(err.cpu(), err_c, rtol=COMPRESS_RTOL,
                                   atol=COMPRESS_ATOL)
        # quantization error within half a step of each block's scale
        step = s.repeat_interleave(256)[:n]
        per_round.append({
            "err_max_abs": float(err.abs().max()),
            "err_over_half_scale": float((err.abs() / (0.5 * step)).max()),
            "err_diff_vs_cpu": float((err.cpu() - err_c).abs().max())})
        if per_round[-1]["err_over_half_scale"] > 1.0 + 1e-5:
            raise AssertionError(f"round {r}: error above half a scale step")
    back_diff = 0.0
    for name, leaf in card_back.items():
        if tuple(leaf.shape) != tuple(update[name].shape) or \
                not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{name}: decompressed leaf malformed")
        torch.testing.assert_close(leaf.cpu(), cpu_back[name],
                                   rtol=COMPRESS_RTOL, atol=COMPRESS_ATOL)
        back_diff = max(back_diff,
                        float((leaf.cpu() - cpu_back[name]).abs().max()))
    got = {k: launches[k] for k in COMPRESS_LAUNCHES}
    record = {"update_of": run, "n_params": n, "codes": n_pad,
              "scales": card[0][1].shape[0], "rounds": COMPRESS_ROUNDS,
              "launches": got, "card_s": card_s,
              "equal_to_plain_on_card": True,
              "codes_and_scales_equal": True, "per_round": per_round,
              "decompressed_diff_vs_cpu": back_diff,
              "update_max_abs": float(flat.abs().max()),
              "rtol": COMPRESS_RTOL, "atol": COMPRESS_ATOL}
    emit("compress", **record)
    if got != COMPRESS_LAUNCHES or any(
            launches[k] for k in launches if k not in COMPRESS_LAUNCHES):
        raise AssertionError(f"compress launches {launches}, want "
                             f"{COMPRESS_LAUNCHES}")
    if n_pad % 2048 or n_pad - n >= 2048:
        raise AssertionError(f"{n} params padded to {n_pad} codes")
    return record


# ---------------------------------------------------------------- attention
ATTN_HEADS, ATTN_DIM = 16, 128        # qwen3-1.7b: 16 query heads of 128
ATTN_SHORT, ATTN_LONG = 4096, 32768   # train_4k and prefill_32k lengths
ATTN_ROWS = 128                       # query rows per block of the check
ATTN_CHUNK = 1024                     # rows per plain computation, long run
ATTN_PAD_SEQ, ATTN_PAD_DIM = 1024, 96  # a head dim the kernels run padded
# Kernel vs plain, one block of ATTN_ROWS query rows at a time:
# |got - want| <= tol * (rms(want over the block) + |want|). A causal row's
# output shrinks as 1/sqrt(its prefix), so a fixed atol would be as wide as
# the values of a long run's later rows; scaled by the block's rms it stays
# a fraction of what it compares. Both sides sum in fp32, so a bf16 output
# is off by at most one bf16 ulp, 2^-7 of the value (fp16: 2^-10, held to
# the same 1e-2).
ATTN_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 2e-4}


def attention_inputs(dev, seq: int, heads: int = ATTN_HEADS,
                     dim: int = ATTN_DIM) -> tuple:
    """Seeded q, k, v [1, heads, seq, dim] in fp32 on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return tuple(torch.randn(1, heads, seq, dim, device=dev, generator=gen)
                 for _ in range(3))


def plain_rows(q, k, v, start: int, rows: int) -> torch.Tensor:
    """Query rows ``[start, start + rows)`` of causal attention over the
    keys they see, computed plainly (the formulas of
    ``ref.flash_attention`` with the mask shifted to those rows)."""
    from repro_torch.kernels.ref import NEG_INF
    end = start + rows
    s = torch.einsum("bhsd,bhtd->bhst", q[:, :, start:end].float(),
                     k[:, :, :end].float()) * q.shape[-1] ** -0.5
    pos = torch.arange(start, end, device=q.device)[:, None]
    s = torch.where(pos >= torch.arange(end, device=q.device)[None], s,
                    NEG_INF)
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1),
                        v[:, :, :end].float()).to(q.dtype)


def attention_check(name: str, got, want, row0: int = 0) -> dict:
    """``got`` against ``want`` block by block of ATTN_ROWS rows, at
    ATTN_TOL scaled by each block's rms (see above); raises where a value
    is outside. ``tol_ratio`` <= 1 passes."""
    tol = ATTN_TOL[want.dtype]
    got, want = got.float(), want.float()
    max_abs, ratio, worst = 0.0, 0.0, row0
    for r in range(0, want.shape[2], ATTN_ROWS):
        w, g = want[:, :, r:r + ATTN_ROWS], got[:, :, r:r + ATTN_ROWS]
        diff = (g - w).abs()
        r_ratio = float((diff / (tol * (w.pow(2).mean().sqrt() + w.abs())))
                        .max())
        max_abs = max(max_abs, float(diff.max()))
        if r_ratio > ratio:
            ratio, worst = r_ratio, row0 + r
    if ratio > 1.0:
        raise AssertionError(f"{name}: rows {worst}..{worst + ATTN_ROWS - 1}"
                             f" off the plain version by {ratio} x the "
                             "tolerance")
    return {"max_abs_err": max_abs,
            "max_rel_err": max_abs / float(want.abs().max()),
            "want_max_abs": float(want.abs().max()), "tol_ratio": ratio,
            "worst_rows_from": worst, "rows": want.shape[2], "tol": tol}


def long_rows_check(out, q, k, v) -> dict:
    """Every query row of a causal run against ``plain_rows``, ATTN_CHUNK
    rows at a time: the plain version of a run whose whole score matrix
    would not fit."""
    parts = [attention_check(f"flash_attention long, rows {r}+",
                             out[:, :, r:r + ATTN_CHUNK],
                             plain_rows(q, k, v, r, ATTN_CHUNK), row0=r)
             for r in range(0, q.shape[2], ATTN_CHUNK)]
    worst = max(parts, key=lambda c: c["tol_ratio"])
    max_abs = max(c["max_abs_err"] for c in parts)
    want_max = max(c["want_max_abs"] for c in parts)
    return {"max_abs_err": max_abs, "max_rel_err": max_abs / want_max,
            "want_max_abs": want_max, "tol_ratio": worst["tol_ratio"],
            "worst_rows_from": worst["worst_rows_from"],
            "rows": sum(c["rows"] for c in parts), "tol": worst["tol"]}


def attention_phase(dev) -> tuple[dict, dict]:
    """Causal ``ops.flash_attention`` at ``[1, 16, 4096, 128]`` in bf16,
    fp32 and fp16 against the plain version; at ``[1, 16, 1024, 96]`` in
    bf16 and fp32 (a head dim the kernels run padded to 128); and at
    ``[1, 16, 32768, 128]`` in bf16: the first 4,096 rows equal the short
    run to the bit (a causal row sees only its prefix; the inputs are the
    long ones' prefix), and every row matches a plain computation of
    ATTN_CHUNK rows at a time. Counts are zeroed before the first call and
    before the long one, and read around every call: each is one launch.
    Returns (record, inputs)."""
    from repro_torch.kernels import ops, ref

    short, long = ATTN_SHORT, ATTN_LONG
    full32 = attention_inputs(dev, long)
    long_bf = tuple(t.to(torch.bfloat16) for t in full32)
    short_in = {"bf16": tuple(t[:, :, :short].contiguous() for t in long_bf),
                "fp32": tuple(t[:, :, :short].contiguous() for t in full32),
                "fp16": tuple(t[:, :, :short].to(torch.float16)
                              for t in full32)}
    del full32
    padded_in = {name: tuple(t.to(dtype) for t in attention_inputs(
                     dev, ATTN_PAD_SEQ, dim=ATTN_PAD_DIM))
                 for name, dtype in (("bf16", torch.bfloat16),
                                     ("fp32", torch.float32))}
    runs = {**short_in, **{f"d{ATTN_PAD_DIM}_{n}": qkv
                           for n, qkv in padded_in.items()}}
    zero_counts()
    outs, launches = {}, {}
    for name, qkv in runs.items():
        before = read_counts()["flash_attention"]
        outs[name] = ops.flash_attention(*qkv)
        torch.cuda.synchronize()
        launches[name] = read_counts()["flash_attention"] - before
    n_short = read_counts()["flash_attention"]
    zero_counts()
    t0 = time.perf_counter()
    outs["long"] = ops.flash_attention(*long_bf)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    n_long = read_counts()["flash_attention"]
    runs["long"] = long_bf
    for name, out in outs.items():
        if out.shape != runs[name][0].shape \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"attention {name}: malformed output")
    out_long = outs.pop("long")
    t0 = time.perf_counter()
    long_rows = long_rows_check(out_long, *long_bf)
    check_s = time.perf_counter() - t0
    record = {
        "shape_short": list(short_in["bf16"][0].shape),
        "shape_long": list(long_bf[0].shape), "causal": True,
        "launches_short": n_short, "launches_long": n_long,
        **{f"launches_short_{n}": launches[n] for n in short_in},
        **{f"short_{n}": attention_check(f"flash_attention {n}", outs[n],
                                         ref.flash_attention(*qkv))
           for n, qkv in short_in.items()},
        "shape_padded": list(padded_in["bf16"][0].shape),
        "padded": {n: dict(attention_check(
                       f"flash_attention d{ATTN_PAD_DIM} {n}",
                       outs[f"d{ATTN_PAD_DIM}_{n}"],
                       ref.flash_attention(*qkv)),
                       launches=launches[f"d{ATTN_PAD_DIM}_{n}"])
                   for n, qkv in padded_in.items()},
        "long_prefix_rows_equal": bool(torch.equal(out_long[:, :, :short],
                                                   outs["bf16"])),
        "long_rows": long_rows, "long_check_s": check_s,
        "long_first_call_s": long_s,
        "long_plain": (f"ref.flash_attention not run whole: its fp32 score "
                       f"matrix would take {ATTN_HEADS * long**2 * 4 / 2**30:.0f}"
                       f" GiB; every row checked against plain_rows, "
                       f"{ATTN_CHUNK} rows at a time"),
        "tolerance": ("|got - want| <= tol * (rms of want over each block of "
                      f"{ATTN_ROWS} rows + |want|)"),
        "tol": {"bf16": ATTN_TOL[torch.bfloat16],
                "fp16": ATTN_TOL[torch.float16],
                "fp32": ATTN_TOL[torch.float32]}}
    emit("attention", **record)
    if not record["long_prefix_rows_equal"]:
        raise AssertionError("the long run's first rows differ from the "
                             "short run")
    if set(launches.values()) != {1} or (n_short, n_long) != (len(outs), 1):
        raise AssertionError(f"flash_attention launched {launches} and "
                             f"{n_long} times, want 1 a call")
    return record, {**{f"short_{n}": qkv for n, qkv in short_in.items()},
                    "long": long_bf}


# ------------------------------------------------------------------ kernels
def check(name: str, got, want, rtol: float = KERNEL_RTOL,
          atol: float = KERNEL_ATOL) -> dict:
    """Kernel output vs plain output: the max abs error, the max abs error
    over the largest magnitude, and the allclose criterion as a ratio
    (``tol_ratio`` <= 1 passes)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    tol_ratio = float((diff / (atol + rtol * want.abs())).max())
    if tol_ratio > 1.0:
        raise AssertionError(f"{name}: kernel vs plain max abs {max_abs}, "
                             f"{tol_ratio} x the tolerance")
    return {"max_abs_err": max_abs,
            "max_rel_err": max_abs / float(want.abs().max()),
            "tol_ratio": tol_ratio}


def main_run(record: dict) -> str:
    """Names the main-path run whose launch counts an entry reports."""
    return f"main path: {record['strategy']}, {len(record['rounds'])} rounds"


def agg_kernel_entry(name: str, record: dict, dev, rows_form: bool) -> dict:
    """``staleness_agg`` at the shapes of the main path's last aggregate:
    the sweep form (weights scattered over the whole [C, W] buffer) or the
    rows form (only the K referenced rows). Timed warm, calls back to
    back with the L2 holding what the last one left (``ms``, and the
    kernel's own ``device_ms``), and with the L2 flushed before each call
    (``flushed_ms``, ``flushed_device_ms``), as the main path finds it
    once a round; ``bound_share`` is the bound over the flushed device
    time. ``shape`` has the kernel's column split on this card."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import SUBLANE
    from repro_torch.kernels.staleness_agg import plan, staleness_agg

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
    split = plan(W, torch.cuda.get_device_properties(dev).multi_processor_count)
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/staleness_agg.cu",
             "replaces": "src/repro/kernels/staleness_agg.py:38",
             "launches": record["launches"]["staleness_agg"],
             "launches_run": main_run(record),
             "shape": {"C": C, "W": W, "K": k, "K_padded": kp,
                       "rows_form": rows_form, "ctas": len(split),
                       "pieces_per_cta": max(map(len, split)),
                       "piece_bytes_max": 4 * max(b - a for p in split
                                                  for a, b in p)},
             **check(name, got, ref.staleness_agg(*args))}
    again = staleness_agg(*args)
    torch.cuda.synchronize()
    if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
        raise AssertionError(f"{name}: two calls differ")
    entry["library_max_abs_diff"] = float((library() - got).abs().max())
    call = lambda: staleness_agg(*args)
    flush = l2_flush(dev)
    entry["ms"] = time_ms(call)
    entry["flushed_ms"] = time_ms(call, before=flush)
    # one profiler session each: the two share the kernel's name
    warm, flushed = (device_ms({"staleness_agg": fn})["staleness_agg"]
                     for fn in (call, lambda: (flush(), call())))
    put_device_ms(entry, "device_ms", warm)
    put_device_ms(entry, "flushed_device_ms", flushed)
    entry["plain_ms"] = time_ms(lambda: ref.staleness_agg(*args))
    entry["library_ms"] = time_ms(library)
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops)
    entry["bound_share"] = entry["bound_ms"] / flushed if flushed else None
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
             "launches_run": main_run(record),
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


def topk_scores(m: int, dev) -> torch.Tensor:
    """Scores shaped like the selection's: about half -inf (busy or
    unregistered slots), a few +inf (never invoked), and planted ties
    across blocks."""
    gen = torch.Generator(device=dev).manual_seed(SEED + m)
    s = torch.rand(m, device=dev, generator=gen) * 50.0
    s[torch.rand(m, device=dev, generator=gen) < 0.5] = float("-inf")
    s[torch.randperm(m, device=dev, generator=gen)[:8]] = float("inf")
    tie = float(s[torch.isfinite(s)].max())
    s[torch.randperm(m, device=dev, generator=gen)[:64]] = tie
    return s


def max_abs_finite(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference over the entries where ``want`` is finite (equal
    infinities and NaNs were already checked bit for bit)."""
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max()) if finite.any() \
        else 0.0


def topk_kernel_entry(name: str, m: int, k: int, launches: int,
                      launches_run: str, dev) -> dict:
    """The selection's top-k (``ops.masked_topk``, one launch) and the
    per-block candidates (``block_topk``) at ``[m]``, against their plain
    versions (stable descending sorts) exactly: values to the bit and
    indices. ``torch.topk`` computes the same values and is the library
    yardstick; how many of its indices differ is recorded (its tie order
    is not ``lax.top_k``'s). ``launches`` were counted in the run that
    ``launches_run`` names. The bound is the function's: read the scores
    once and write the top k, with about one comparison per score."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.topk import BLOCK_TOPK, block_topk

    s = topk_scores(m, dev)
    cand_v, cand_i = block_topk(s, k)
    before = block_topk.launches
    vals, idx = ops.masked_topk(s, k)
    torch.cuda.synchronize()
    calls = block_topk.launches - before      # 1 on the card, 0 on the CPU
    want_cv, want_ci = ref.block_topk(s, k, BLOCK_TOPK)
    want_v, want_i = ref.masked_topk(s, k)
    if not (torch.equal(cand_i, want_ci) and torch.equal(idx, want_i)):
        raise AssertionError(f"{name}: indices differ from the plain version")
    if not (torch.equal(cand_v.view(torch.int32), want_cv.view(torch.int32))
            and torch.equal(vals.view(torch.int32),
                            want_v.view(torch.int32))):
        raise AssertionError(f"{name}: values differ from the plain version")
    if calls != (1 if s.is_cuda else 0):
        raise AssertionError(f"{name}: masked_topk took {calls} launches, "
                             "not one")
    lib_v, lib_i = torch.topk(s, k)
    if not torch.equal(lib_v, vals):
        raise AssertionError(f"{name}: torch.topk values differ")
    nbytes = m * 4 + k * (4 + 8)          # read the scores, write the top k
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/topk.cu",
             "replaces": "src/repro/kernels/topk.py:61",
             "launches": launches, "launches_run": launches_run,
             "shape": {"M": m, "k": k, "passes": max(calls - 1, 0),
                       "finite": int(torch.isfinite(s).sum())},
             "max_abs_err": max_abs_finite(vals, want_v), "exact": True,
             "library_idx_differ": int((lib_i != idx).sum()),
             "timed": "ops.masked_topk on seeded scores shaped like the "
                      "selection's; the paths select through "
                      "ops.scored_topk (the scored_topk entries)"}
    entry["ms"] = time_ms(lambda: ops.masked_topk(s, k))
    put_device_ms(entry, "device_ms", device_ms(
        {"topk_select_kernel": lambda: ops.masked_topk(s, k)}
    )["topk_select_kernel"])
    entry["candidates_ms"] = time_ms(lambda: block_topk(s, k))
    entry["plain_ms"] = time_ms(lambda: ref.masked_topk(s, k))
    entry["library_ms"] = time_ms(lambda: torch.topk(s, k))
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, m)
    entry["bytes"] = nbytes
    return entry


def composed_scored_topk(num, den, booster, eligible, ever, beta, k):
    """The selection step as separate torch passes with ``torch.topk`` for
    the top-k: the yardstick of the fused kernel (no one PyTorch call
    computes the step; ``torch.topk``'s tie order is not ``lax.top_k``'s)."""
    score = booster * (num / torch.clamp_min(den, 1e-12))
    score = torch.where(ever, score, float("inf"))
    score = torch.where(eligible, score, float("-inf"))
    vals, idx = torch.topk(score, k)
    valid = vals > float("-inf")
    chosen = torch.zeros_like(eligible)
    chosen[idx] = valid
    boost = torch.where(chosen, 1.0,
                        torch.where(eligible, booster * beta, booster))
    return idx, valid, boost


def scored_topk_entry(name: str, state, k: int, beta: float, launches: int,
                      launches_run: str) -> dict:
    """The fused selection step (``ops.scored_topk``: score, masks, top-k
    and booster update in one launch) on ``state``, a ``FleetStore``'s
    device score state, at ``k`` and ``beta`` as its path calls it, held
    to the plain composition ``ref.scored_topk`` on the same tensors
    exactly: idx, valid and the new booster to the bit. The bound is the
    step's bytes: num, den, booster (fp32) and eligible, ever (bool) read
    once, the new booster written once, 18 B a slot, and the k picks and
    flags."""
    from repro_torch.kernels import ops, ref

    args = (state.num, state.den, state.booster, state.eligible, state.ever,
            beta, k)
    m = state.booster.shape[0]
    got = ops.scored_topk(*args)
    torch.cuda.synchronize()
    want = ref.scored_topk(*args)
    for what, a, b in zip(("idx", "valid", "booster"), got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs from the "
                                 "plain version")
    nbytes = 18 * m + k * (8 + 1)
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/topk.cu",
             "replaces": "src/repro/kernels/topk.py:61",
             "replaces_also": "src/repro/kernels/ops.py:308 scored_topk",
             "launches": launches, "launches_run": launches_run,
             "shape": {"M": m, "k": k, "beta": beta,
                       "eligible": int(state.eligible.sum()),
                       "valid": int(got[1].sum())},
             "max_abs_err": max_abs_finite(got[2], want[2]), "exact": True,
             "library_ms": None,
             "library_note": "no single PyTorch call computes the step; "
                             "composed_ms is the stepwise torch composition "
                             "with torch.topk"}
    entry["ms"] = time_ms(lambda: ops.scored_topk(*args))
    put_device_ms(entry, "device_ms", device_ms(
        {"topk_select_kernel": lambda: ops.scored_topk(*args)}
    )["topk_select_kernel"])
    entry["plain_ms"] = time_ms(lambda: ref.scored_topk(*args))
    entry["composed_ms"] = time_ms(lambda: composed_scored_topk(*args))
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, m)
    entry["bytes"] = nbytes
    return entry


def main_path_selection(engine) -> tuple:
    """The main path's selection state after its run: the store's device
    score state with the pending dirty slots flushed, as the next
    ``select_topk`` would see it, and the k and beta it is called with."""
    from repro_torch.core.scoring import promotion_rate

    engine.db.fleet._flush_device()
    return (engine.db.fleet._dev, engine.cfg.clients_per_round,
            promotion_rate(engine.cfg.adjustment_rate))


def compress_kernel_entry(update: dict, launches: int, run: str) -> dict:
    """``compress_q8`` at the compress phase's steady state: the update
    raveled, with its first round's error feedback carried (what the
    second and third ``compress_update`` calls hand the kernel), held to
    its plain version ``ref.compress_q8`` and to the stepwise path it
    replaces to the bit (codes, scales, error). ``composed_ms`` and
    ``composed_device_ms`` time that stepwise path (add, pad,
    ``quantize_q8``, ``dequantize_q8``, slice, subtract). The bound is the
    fused call's bytes: flat and the error feedback read (4N each), the
    codes, the scales and the error written (n_pad + 4 n_pad / 256 + 4N).
    No single PyTorch call computes the step."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant8 import (QBLOCK, ROWS, compress_q8,
                                            dequantize_q8, quantize_q8)

    flat = ops.RavelSpec(update).ravel(update)
    n = flat.shape[0]
    n_pad = n + (-n) % (ROWS * QBLOCK)
    ef = compress_q8(flat, None, n_pad)[2]          # the first round's error

    def composed():
        v = flat + ef
        q, s = quantize_q8(torch.nn.functional.pad(v, (0, n_pad - n)))
        return q, s, v - dequantize_q8(q, s)[:n]

    got = compress_q8(flat, ef, n_pad)
    torch.cuda.synchronize()
    want = ref.compress_q8(flat, ef, n_pad)
    for what, other in (("plain version", want),
                        ("stepwise path", composed())):
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   if a.dtype == torch.float32 else torch.equal(a, b)
                   for a, b in zip(got, other)):
            raise AssertionError(f"compress_q8: kernel differs from the "
                                 f"{what}")
    nbytes = 3 * 4 * n + n_pad + 4 * (n_pad // QBLOCK)
    entry = {"name": "compress_q8", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/quant8.cu",
             "replaces": "src/repro/kernels/quant8.py:58",
             "replaces_also": "src/repro/kernels/quant8.py:89, both as "
                              "src/repro/kernels/ops.py:357 compress_update "
                              "composes them",
             "launches": launches, "launches_run": run,
             "shape": {"N": n, "N_padded": n_pad, "blocks": n_pad // QBLOCK,
                       "error_feedback": True},
             "max_abs_err": float((got[2] - want[2]).abs().max()),
             "exact": True, "bytes": nbytes, "library_ms": None,
             "library_note": "no single PyTorch call computes block-scaled "
                             "int8 codes with error feedback; composed_ms "
                             "is the stepwise path the kernel replaces"}
    entry["ms"] = time_ms(lambda: compress_q8(flat, ef, n_pad))
    put_device_ms(entry, "device_ms", device_ms(
        {"compress_q8_kernel": lambda: compress_q8(flat, ef, n_pad)}
    )["compress_q8_kernel"])
    entry["plain_ms"] = time_ms(lambda: ref.compress_q8(flat, ef, n_pad))
    entry["composed_ms"] = time_ms(composed)
    put_device_ms(entry, "composed_device_ms", device_total_ms(composed))
    # add, abs, max, divide, round, clip, multiply, subtract a value
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, 8 * n_pad)
    return entry


def quant8_kernel_entries(update: dict, launches: dict, run: str) -> list:
    """``quantize_q8`` and ``dequantize_q8`` at the compress phase's shape:
    the update raveled and zero-padded to a multiple of 2048, as
    ``compress_update`` hands it to the kernels. Both are held to their
    plain versions exactly (codes, scales and values to the bit).
    ``dequantize_q8``'s library call is one ``torch.mul`` of the codes as
    [blocks, 256] by the scales as [blocks, 1] (int8 x fp32 promotes to
    fp32), also held to the bit; no single PyTorch call computes
    ``quantize_q8``'s block-scaled int8 codes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant8 import QBLOCK, dequantize_q8, quantize_q8

    flat = ops.RavelSpec(update).ravel(update)
    x = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % 2048))
    n, nb = x.shape[0], x.shape[0] // QBLOCK
    q, s = quantize_q8(x)
    got = dequantize_q8(q, s)
    library = lambda: torch.mul(q.view(-1, QBLOCK), s.view(-1, 1))
    lib = library()
    torch.cuda.synchronize()
    want_q, want_s = ref.quantize_q8(x)
    want = ref.dequantize_q8(q, s)
    if not (torch.equal(q, want_q) and torch.equal(s.view(torch.int32),
                                                   want_s.view(torch.int32))):
        raise AssertionError("quantize_q8: kernel differs from the plain "
                             "version")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("dequantize_q8: kernel differs from the plain "
                             "version")
    if not (lib.dtype == torch.float32 and torch.equal(
            lib.reshape(-1).view(torch.int32), got.view(torch.int32))):
        raise AssertionError("dequantize_q8: torch.mul differs from the "
                             "kernel")
    nbytes = n * 4 + n + nb * 4          # fp32 values, int8 codes, scales
    common = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/quant8.cu",
              "launches_run": run, "shape": {"N": n, "blocks": nb},
              "exact": True, "bytes": nbytes}
    entries = []
    # (quantize_q8 launches the fused compress kernel without error feedback)
    for name, line, kernel, fn, plain, lib_fn, flops, err in (
            ("quantize_q8", 58, "compress_q8_kernel", lambda: quantize_q8(x),
             lambda: ref.quantize_q8(x), None,
             5 * n,                              # abs, max, div, round, clip
             (s - want_s).abs().max()),
            ("dequantize_q8", 89, "dequantize_q8_kernel",
             lambda: dequantize_q8(q, s), lambda: ref.dequantize_q8(q, s),
             library, n, (got - want).abs().max())):   # one multiply
        e = {"name": name, "replaces": f"src/repro/kernels/quant8.py:{line}",
             "launches": launches[name], "max_abs_err": float(err), **common}
        if name == "quantize_q8":
            e["launches_note"] = ("compress_update runs the fused "
                                  "compress_q8; no path calls quantize_q8 "
                                  "alone, the reference's entry point")
        e["ms"] = time_ms(fn)
        e["plain_ms"] = time_ms(plain)
        calls = {kernel: fn}
        if lib_fn is None:
            e["library_ms"] = None
            e["library_note"] = ("no single PyTorch call computes "
                                 "block-scaled int8 codes")
        else:
            e["library_ms"] = time_ms(lib_fn)
            e["library"] = ("torch.mul(q.view(-1, 256), s.view(-1, 1)), "
                            "bit-equal to the kernel")
            calls["elementwise"] = lib_fn
        dev_ms = device_ms(calls)
        put_device_ms(e, "device_ms", dev_ms[kernel])
        if lib_fn is not None:
            put_device_ms(e, "library_device_ms", dev_ms["elementwise"])
        e["bound_ms"], e["bound_by"] = bound(nbytes, flops)
        entries.append(e)
    return entries


def attention_work(B: int, H: int, S: int, D: int, elt: int
                   ) -> tuple[int, int]:
    """Causal attention forward's least work: two products over the lower
    triangle (4*B*H*D*S(S+1)/2 flops) and q, k, v read and the output
    written once (4*B*H*S*D elements)."""
    return 4 * B * H * D * S * (S + 1) // 2, 4 * B * H * S * D * elt


def attention_kernel_entry(name: str, qkv: tuple, launches: int, run: str,
                           checked: dict, reps: int = 20) -> dict:
    """``flash_attention`` (causal) on ``qkv``, timed beside
    ``F.scaled_dot_product_attention(is_causal=True)``, the library call
    for the same function, and beside the plain version; ``checked`` is the
    attention phase's check of the same output against it. Where the whole
    plain version does not fit (``S`` past ATTN_SHORT), the plain time is
    of ``plain_rows`` over every row, ATTN_CHUNK rows at a time. The bound
    is the function's: causal flops 4*B*H*D*S(S+1)/2 at the 16-bit tensor
    rate for bf16 and fp16; for fp32, which the kernel computes as three
    TF32 products a product, three times those flops at the TF32 tensor
    rate (``fp32_fma_bound_ms`` keeps the flops at the 67 TFLOP/s of fp32
    FMA, the bound before this design); bytes q, k, v read and the output
    written once. ``design`` names the kernel the input type takes (bf16
    and fp16: wgmma fed by a TMA ring; fp32: three TF32 mma.sync products);
    ``tflops`` and ``device_tflops`` are the achieved rates, the function's
    flops over ``ms`` and over ``device_ms``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = qkv
    B, H, S, D = q.shape
    got = flash_attention(q, k, v)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    lib = library()
    torch.cuda.synchronize()
    fp32 = q.dtype == torch.float32
    entry = {"name": name, "route": "cuda",
             "design": "cuda-mma-3xtf32" if fp32 else "cuda-wgmma-tma",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:82",
             "launches": launches, "launches_run": run,
             "shape": {"B": B, "H": H, "S": S, "D": D,
                       "dtype": str(q.dtype), "causal": True},
             "library_max_abs_diff": float((lib.float() - got.float())
                                           .abs().max()),
             **checked}
    if S <= ATTN_SHORT:
        plain = lambda: ref.flash_attention(q, k, v)
    else:
        plain = lambda: [plain_rows(q, k, v, r, ATTN_CHUNK)
                         for r in range(0, S, ATTN_CHUNK)]
        entry["plain_note"] = (
            f"plain_ms is of plain_rows over every row, {ATTN_CHUNK} rows at "
            f"a time: ref.flash_attention whole would need a "
            f"{B * H * S * S * 4 / 2**30:.0f} GiB fp32 score matrix")
    warmup = 1 if reps < 20 else 3
    entry["ms"] = time_ms(lambda: flash_attention(q, k, v), reps=reps,
                          warmup=warmup)
    put_device_ms(entry, "device_ms", device_ms(
        {"flash_fwd_kernel": lambda: flash_attention(q, k, v)},
        reps=min(reps, 10))["flash_fwd_kernel"])
    entry["plain_ms"] = time_ms(plain, reps=min(reps, 5), warmup=1)
    entry["library_ms"] = time_ms(library, reps=reps, warmup=warmup)
    flops, nbytes = attention_work(B, H, S, D, q.element_size())
    if fp32:
        entry["bound_ms"], entry["bound_by"] = bound(
            nbytes, TF32_PRODUCTS * flops, TF32_FLOP_PER_S)
        entry["fp32_fma_bound_ms"] = bound(nbytes, flops)[0]
    else:
        entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops,
                                                     BF16_FLOP_PER_S)
    entry["flops"], entry["bytes"] = flops, nbytes
    entry["tflops"] = flops / entry["ms"] / 1e9 if entry["ms"] else None
    entry["device_tflops"] = (flops / entry["device_ms"] / 1e9
                              if entry["device_ms"] else None)
    return entry


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "launches_run", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


# kept in the kernel list where an entry has them: the kernel's own time
# (profiler), for the fused selection step and the fused compress step the
# stepwise composition's (for compress also its device time), for fp32
# attention the bound at the fp32 FMA rate, and for staleness_agg the event
# and device times with the L2 flushed before each call and the bound over
# the flushed device time
EXTRA_KEYS = ("device_ms", "composed_ms", "composed_device_ms",
              "fp32_fma_bound_ms", "flushed_ms", "flushed_device_ms",
              "bound_share")


def report_lines(kernels: list, kind: str, count: int) -> list:
    """The last two lines of the output: the kernel list, then the result
    line. Every line the script prints on stdout is one JSON object."""
    return [json.dumps({"kernels": [
                {k: e[k] for k in KERNEL_KEYS + EXTRA_KEYS if k in e}
                for e in kernels]}),
            json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": kind, "count": count}})]


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
         ptxas={k: [l.strip() for l in v.splitlines()
                    if any(w in l for w in ("registers", "spill", "C75"))]
                for k, v in logs.items()})

    from repro_torch.data.synthetic import make_federated_dataset
    t0 = time.perf_counter()
    data = make_federated_dataset("mnist", n_clients=200, scale=1.0, seed=SEED,
                                  fidelity="paper")
    emit("data", seconds=time.perf_counter() - t0, X=list(data.X.shape),
         eval_n=len(data.eval_y))
    apo_engine, apo = run_main_path("apodotiko", 3, data, dev)
    _, avg = run_main_path("fedavg", 1, data, dev)
    topk_engine, top = run_main_path("apodotiko-topk", 3, data, dev)
    main_m = topk_engine.db.fleet.capacity
    main_selection = main_path_selection(topk_engine)
    fleet, fleet_state = fleet_phase(dev)
    topk_sort_route_phase(fleet_state, dev)
    reference_phase(dev)
    profile_round(data, dev, avg["rounds"][0]["wall_s"])
    update = mnist_update(apo_engine, dev)
    compress = compress_phase(update, main_run(apo))
    attention, attn_inputs = attention_phase(dev)

    n_topk = top["launches"]["block_topk"]
    fleet_run = f"fleet phase: {FLEET_ROUNDS} select_topk calls at M = 1e6"
    kernels = [agg_kernel_entry("staleness_agg", avg, dev, rows_form=False),
               agg_kernel_entry("staleness_agg[rows]", apo, dev,
                                rows_form=True),
               adam_kernel_entry(apo, dev),
               topk_kernel_entry("block_topk", main_m, 100, n_topk,
                                 main_run(top), dev),
               scored_topk_entry("scored_topk", *main_selection, n_topk,
                                 main_run(top)),
               topk_kernel_entry("block_topk[fleet]", FLEET_CAPACITY, FLEET_K,
                                 sum(fleet["launches_per_call"]), fleet_run,
                                 dev),
               scored_topk_entry("scored_topk[fleet]", fleet_state, FLEET_K,
                                 FLEET_BETA, sum(fleet["launches_per_call"]),
                                 fleet_run)]
    compress_run = (f"compress phase: {COMPRESS_ROUNDS} compress_update "
                    "calls and one decompress_update")
    kernels.append(compress_kernel_entry(
        update, compress["launches"]["compress_q8"], compress_run))
    kernels += quant8_kernel_entries(update, compress["launches"],
                                     compress_run)
    kernels += [
        attention_kernel_entry(
            "flash_attention" + ("" if n == "bf16" else f"[{n}]"),
            attn_inputs[f"short_{n}"], attention[f"launches_short_{n}"],
            f"attention phase: causal [1,16,4096,128] in {n}",
            attention[f"short_{n}"])
        for n in ("bf16", "fp32", "fp16")] + [
        attention_kernel_entry(
            "flash_attention[prefill_32k]", attn_inputs["long"],
            attention["launches_long"],
            "attention phase: causal [1,16,32768,128] in bf16",
            attention["long_rows"], reps=5)]
    for e in kernels:
        emit("kernel", **e)
    for line in report_lines(kernels, kind, torch.cuda.device_count()):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
