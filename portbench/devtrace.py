"""The device trace of a traced window: one ``torch.profiler`` session over
the card's kernels and copies, reduced to busy time, the heaviest device
operations and the longest idle gaps.

Host spans are taken on ``time.perf_counter_ns``; the profiler stamps its
events on its own clock. ``DeviceTrace.start`` reads both the monotonic
and the wall clock beside the profiler's start, and ``reduce`` moves the
spans onto whichever of the two the profiler's start time lies nearest.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


def merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.clocks = None

    def start(self) -> None:
        self.clocks = (time.perf_counter_ns(), time.monotonic_ns(),
                       time.time_ns())
        self.prof.start()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.stop()

    def reduce(self, t0_ns: int, t1_ns: int, spans: list) -> dict:
        """Busy seconds, kernel counts by name, the top device operations
        and idle gaps over the window ``[t0_ns, t1_ns]`` (perf_counter
        ns). ``spans``: ``(name, start_ns, end_ns)`` host spans, which
        name the gaps."""
        results = self.prof.profiler.kineto_results
        perf0, mono0, wall0 = self.clocks
        start = results.trace_start_ns()
        base = mono0 if abs(start - mono0) < abs(start - wall0) else wall0
        shift = base - perf0
        w0, w1 = t0_ns + shift, t1_ns + shift
        cuda = torch.autograd.DeviceType.CUDA
        busy, by_name, counts = [], defaultdict(int), defaultdict(int)
        for ev in results.events():
            if ev.device_type() != cuda:
                continue
            s, e = max(ev.start_ns(), w0), min(ev.end_ns(), w1)
            if e <= s:
                continue
            busy.append((s, e))
            by_name[ev.name()] += e - s
            counts[ev.name()] += 1
        merged = merge(busy)
        busy_ns = sum(e - s for s, e in merged)
        gaps, prev = [], w0
        for s, e in merged + [[w1, w1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        host = sorted(((a + shift, b + shift, n) for n, a, b in spans),
                      key=lambda t: t[1] - t[0])

        def name_of(mid):
            for a, b, n in host:          # the innermost span holding it
                if a <= mid <= b:
                    return n
            return "engine"               # the scheduler's own host code

        gaps.sort(key=lambda g: g[0] - g[1])
        return {
            "busy_s": busy_ns / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "counts": dict(counts),
            "device_ops": [[n, t / 1e9] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[name_of((a + b) // 2), (b - a) / 1e9]
                          for a, b in gaps[:10]],
        }
