"""The card's operations and idle gaps of a traced window on the host's
clock, where the program's spans are, and the idle time named by the span
the host was in.

The profiler stamps an operation's start on the card and the call that
launched it on the host. Moved by the one shift that ``DeviceTrace.reduce``
takes (the profiler's clock less ``time.perf_counter_ns``), the host
stamps agree with the program's spans, but the card stamps wander against
them by up to tens of milliseconds within a run. An operation cannot start
before its launch call, so its launch call less its card stamp is a lower
bound of the card stamps' offset, and an operation launched into an idle
card (it starts a few µs after its call) meets it. The offset at an
operation is taken as the largest such bound within ``WINDOW_NS`` of it on
the card's clock: no operation is then placed before its launch call, and
one launched into an idle card nearby pins the rest to within the drift
over the window. Every idle gap keeps its length on the card's clock and
moves by the offset at the operation that ends it (the window's last gap
by the last operation's), so the gaps sum to the window less the card's
busy time, as ``DeviceTrace.reduce`` counts them.

``clock_check`` reads the placement against the host: placed kernels
against the spans that launched them, and the operations the host waited
on (launched inside a ``*.wait`` span) against the span's end.
"""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

WINDOW_NS = 5_000_000
_BIN_NS = 1_000_000


class Ops(NamedTuple):
    """The window's device operations by start, as arrays: ``start`` and
    ``end`` the card stamps on ``perf_counter_ns``, ``launch`` the start of
    the launch call (-1 where the profiler has none), ``name`` an index
    into ``names``."""
    start: np.ndarray
    end: np.ndarray
    launch: np.ndarray
    name: np.ndarray
    names: list


def shift(dtrace) -> int:
    """The profiler's clock less ``time.perf_counter_ns``, as
    ``DeviceTrace.reduce`` takes it."""
    perf0, mono0, wall0 = dtrace.clocks
    start = dtrace.prof.profiler.kineto_results.trace_start_ns()
    return (mono0 if abs(start - mono0) < abs(start - wall0)
            else wall0) - perf0


def device_ops(dtrace, t0_ns: int, t1_ns: int) -> Ops:
    """The card's operations (kernels, copies, memsets) that overlap
    ``[t0_ns, t1_ns]``, with their launch calls (the host events that
    share their correlation ids), moved by ``shift``."""
    results, d = dtrace.prof.profiler.kineto_results, shift(dtrace)
    cuda = torch.autograd.DeviceType.CUDA
    rows, calls, names = [], {}, {}
    for ev in results.events():
        if ev.device_type() == cuda:
            s, e = ev.start_ns() - d, ev.end_ns() - d
            if e > t0_ns and s < t1_ns:
                rows.append((s, e, ev.correlation_id(),
                             names.setdefault(ev.name(), len(names))))
        else:
            calls[ev.correlation_id()] = ev.start_ns() - d
    rows.sort()
    a = np.array(rows, np.int64).reshape(-1, 4)
    launch = np.array([calls.get(c, -1) for c in a[:, 2].tolist()], np.int64)
    return Ops(a[:, 0], a[:, 1], launch, a[:, 3], list(names))


def offsets(ops: Ops) -> np.ndarray:
    """The card stamps' offset at each operation (the module's
    docstring), in 1 ms bins of the card's clock."""
    if not len(ops.start):
        return np.zeros(0, np.int64)
    low = np.iinfo(np.int64).min
    bound = np.where(ops.launch >= 0, ops.launch - ops.start, low)
    b = (ops.start - ops.start[0]) // _BIN_NS
    per = np.full(int(b[-1]) + 1, low, np.int64)
    np.maximum.at(per, b, bound)
    near = per.copy()
    for k in range(1, WINDOW_NS // _BIN_NS + 1):
        near[k:] = np.maximum(near[k:], per[:-k])
        near[:-k] = np.maximum(near[:-k], per[k:])
    near[near == low] = 0             # no launch call within the window
    return near[b]


def place(ops: Ops, t0_ns: int, t1_ns: int) -> tuple:
    """Each operation's offset, and the window's idle gaps on the host
    clock as ``(start, end)`` by start."""
    off = offsets(ops)
    if not len(off):
        return off, [(t0_ns, t1_ns)]
    s = np.maximum(ops.start, t0_ns)
    reach = np.maximum.accumulate(np.minimum(ops.end, t1_ns))
    before = np.concatenate([[t0_ns], reach[:-1]])
    i = np.nonzero(s > before)[0]     # the operations that end a gap
    gaps = list(zip((before[i] + off[i]).tolist(), (s[i] + off[i]).tolist()))
    if t1_ns > reach[-1]:
        gaps.append((int(reach[-1] + off[-1]), int(t1_ns + off[-1])))
    return off, sorted(gaps)


def segment_names(spans: list, bounds: list) -> list:
    """The innermost (shortest) of ``spans`` (``(name, start_ns,
    end_ns)``) over ``[bounds[i], bounds[i + 1])``, ``engine`` where none
    holds it (the last segment is unbounded)."""
    by_start = sorted(spans, key=lambda s: s[1])
    names, active, j = [], [], 0
    for lo in bounds:
        while j < len(by_start) and by_start[j][1] <= lo:
            active.append(by_start[j])
            j += 1
        active = [s for s in active if s[2] > lo]
        names.append(min(active, key=lambda s: s[2] - s[1])[0]
                     if active else "engine")
    return names


def idle_by_span(idle: list, spans: list) -> dict:
    """Idle seconds by the innermost span holding each instant, ``engine``
    where none does; the values sum to the gaps' length. ``idle``:
    ``(start, end)`` by start."""
    bounds = sorted({a for _, a, _ in spans} | {b for _, _, b in spans})
    names = segment_names(spans, bounds)
    out, k = defaultdict(int), 0
    for a, b in idle:
        while k < len(bounds) and bounds[k] <= a:
            k += 1
        m = k - 1                     # [a, b) starts in segment m
        while a < b:
            hi = min(b, bounds[m + 1]) if m + 1 < len(bounds) else b
            out[names[m] if m >= 0 else "engine"] += hi - a
            a, m = hi, m + 1
    return {n: ns / 1e9 for n, ns in sorted(out.items(), key=lambda kv: -kv[1])}


def longest_gaps(idle: list, spans: list, n: int = 10) -> list:
    """The ``n`` longest gaps as ``[name, seconds]``, each named by the
    innermost span holding its midpoint."""
    bounds = sorted({a for _, a, _ in spans} | {b for _, _, b in spans})
    names = segment_names(spans, bounds)
    out = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:n]:
        m = int(np.searchsorted(bounds, (a + b) // 2, side="right")) - 1
        out.append([names[m] if m >= 0 else "engine", (b - a) / 1e9])
    return out


def clock_check(spans: list, ops: Ops, off: np.ndarray) -> dict:
    """The placement read against the host, in µs. ``us``: the i-th
    ``step.opt`` span against the i-th placed ``fused_adam_kernel``, the
    largest lead of the kernel's start over the span's; ``launch_us``: of
    its launch call over the span (the profiler's host stamps against the
    program's clock); ``card_us``: of its own card stamp over its launch
    call (the skew placement takes out); ``lag_us``: the largest by which
    an operation launched inside a ``*.wait`` span (the host waits there
    for the card) ends, placed, after the span ends. Sound placement keeps
    ``us`` and ``lag_us`` at most a few µs above 0."""
    opt = sorted(s.start_ns for s in spans if s.name == "step.opt")
    adam = np.nonzero(np.isin(ops.name, [
        i for i, n in enumerate(ops.names) if "fused_adam_kernel" in n]))[0]
    adam = adam[:len(opt)]
    t = np.array(opt[:len(adam)], np.int64)
    has = ops.launch[adam] >= 0

    def most(x):
        return float(x.max()) / 1e3 if len(x) else None
    waits = sorted((s.start_ns, s.end_ns) for s in spans
                   if s.name.endswith(".wait"))
    lag = []
    if waits and len(ops.launch):
        order = np.argsort(ops.launch)
        ls = ops.launch[order]
        for a, b in waits:
            i = order[np.searchsorted(ls, a):np.searchsorted(ls, b)]
            if len(i):
                lag.append(int((ops.end[i] + off[i]).max()) - b)
    return {"us": most(t - ops.start[adam] - off[adam]),
            "launch_us": most((t - ops.launch[adam])[has]),
            "card_us": most((ops.launch[adam] - ops.start[adam])[has]),
            "lag_us": most(np.array(lag)), "step_opt": len(opt),
            "fused_adam": len(adam)}


def launched_in(ops: Ops, spans: list, name: str) -> dict:
    """The operations whose launch call lies inside each span called
    ``name``, by the span's index in ``spans``."""
    ls = np.sort(ops.launch[ops.launch >= 0])
    return {i: int(np.searchsorted(ls, s.end_ns) - np.searchsorted(ls, s.start_ns))
            for i, s in enumerate(spans) if s.name == name}
