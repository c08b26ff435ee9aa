"""Traffic schedule compiler: arrival processes -> vectorized segments
(twin of ``repro.traffic.schedule``).

The naive open-loop simulation emits one Python ``ClientJoined`` /
``ClientLeft`` per arrival — untenable at M=1e6. Instead the whole
arrival process is compiled *once*, ahead of the run, into a short list
of :class:`TrafficSegment` windows: ``(start, end, joins, leaves)`` with
the member deltas as int64 id arrays. The runtime applies each segment
in bulk (one columnar ``FleetStore.add_batch`` + one ``remove_batch``)
when the clock crosses its start, and the megastep treats segment
boundaries exactly like PR 7's outage windows — fuse up to the next
boundary, re-engage after it.

Compilation contract (the replay anchor, property-tested):

* One ``np.random.default_rng(seed)`` generator; sources consume draws
  in declaration order with a fixed draw count per source, so the same
  (spec, seed, capacity) compiles bit-identically forever.
* Poisson arrivals via order statistics (N ~ Poisson(rate*horizon),
  then N sorted uniforms); diurnal via thinning at the peak rate.
* Event times quantize UP to the spec's window; window-0 events fold
  into the initial membership.
* Ids are the *smallest free* ids in [0, capacity): arrivals beyond
  capacity are dropped and counted (``n_dropped``); ids freed by a leave
  are reused. Within a window: leaves first (dwell expiries, then trace
  removals of the earliest-joined), then joins — the i-th earliest
  arrival in the window takes the i-th smallest free id.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.traffic.model import (DiurnalTraffic, FlashCrowd, PoissonTraffic,
                                 TraceTraffic, TrafficSpec, parse_traffic,
                                 TRAFFIC_PROFILES)

__all__ = ["TrafficSegment", "TrafficSchedule", "compile_traffic_schedule",
           "build_traffic_schedule"]


@dataclass(frozen=True, eq=False)
class TrafficSegment:
    """One schedule window: at ``start``, remove ``leaves`` then register
    ``joins`` (both sorted int64 id arrays); membership then holds until
    ``end`` (the next segment's start)."""
    start: float
    end: float
    joins: np.ndarray
    leaves: np.ndarray


@dataclass(frozen=True, eq=False)
class TrafficSchedule:
    """A compiled, replayable availability schedule over a fixed id
    universe [0, capacity)."""
    spec: TrafficSpec
    seed: int
    capacity: int
    horizon: float
    initial: np.ndarray                      # sorted ids present at t=0
    segments: Tuple[TrafficSegment, ...]
    n_dropped: int = 0                       # arrivals beyond capacity

    @property
    def stochastic(self) -> bool:
        return self.spec.stochastic

    def presence_at(self, t: float) -> np.ndarray:
        """Availability mask after every segment with start <= t."""
        present = np.zeros(self.capacity, bool)
        present[self.initial] = True
        for seg in self.segments:
            if seg.start > t:
                break
            present[seg.leaves] = False
            present[seg.joins] = True
        return present

    def events(self) -> Iterator[Tuple[float, str, int]]:
        """Per-client event stream — the slow oracle the bulk path is
        tested against: (t, "leave"|"join", client_id) in apply order."""
        for seg in self.segments:
            for cid in seg.leaves:
                yield seg.start, "leave", int(cid)
            for cid in seg.joins:
                yield seg.start, "join", int(cid)


def _quantize_up(t: float, window: float) -> float:
    if t <= 0.0:
        return 0.0
    return window * math.ceil(t / window - 1e-9)


def compile_traffic_schedule(spec: TrafficSpec, capacity: int, seed: int,
                             horizon_cap: Optional[float] = None
                             ) -> TrafficSchedule:
    """Draw every source once and fold the event stream into windowed
    bulk segments (see module docstring for the contract)."""
    horizon = spec.horizon
    if horizon_cap is not None:
        horizon = min(horizon, float(horizon_cap))
    window = spec.window
    rng = np.random.default_rng(seed)

    # ---- draw arrivals (t, dwell) per source, in declaration order
    ts_parts, dwell_parts = [], []
    trace_leaves: dict[float, int] = {}      # boundary -> count
    for src in spec.sources:
        if isinstance(src, PoissonTraffic):
            n = int(rng.poisson(src.rate * horizon))
            ts = np.sort(rng.uniform(0.0, horizon, n))
            dw = (rng.exponential(src.dwell, n) if src.dwell > 0
                  else np.full(n, np.inf))
        elif isinstance(src, DiurnalTraffic):
            lam_max = src.rate * (1.0 + src.depth)
            n = int(rng.poisson(lam_max * horizon))
            ts = np.sort(rng.uniform(0.0, horizon, n))
            u = rng.uniform(0.0, lam_max, n)
            lam_t = src.rate * (1.0 + src.depth
                                * np.sin(2.0 * np.pi * ts / src.period))
            ts = ts[u < lam_t]
            dw = (rng.exponential(src.dwell, len(ts)) if src.dwell > 0
                  else np.full(len(ts), np.inf))
        elif isinstance(src, FlashCrowd):
            ts = np.full(src.n, float(src.t))
            dw = np.full(src.n, src.dwell if src.dwell > 0 else np.inf)
        elif isinstance(src, TraceTraffic):
            joins = [t for t, d in src.events for _ in range(max(d, 0))]
            ts = np.asarray(joins, float)
            dw = np.full(len(joins), np.inf)
            for t, d in src.events:
                if d < 0:
                    b = _quantize_up(t, window)
                    trace_leaves[b] = trace_leaves.get(b, 0) - d
        else:
            raise TypeError(f"unknown traffic source {src!r}")
        ts_parts.append(ts)
        dwell_parts.append(dw)

    ts_all = (np.concatenate(ts_parts) if ts_parts
              else np.empty(0, float))
    dw_all = (np.concatenate(dwell_parts) if dwell_parts
              else np.empty(0, float))
    order = np.argsort(ts_all, kind="stable")
    ts_all, dw_all = ts_all[order], dw_all[order]

    bounds = np.array([_quantize_up(t, window) for t in ts_all])
    keep = bounds <= horizon
    ts_all, dw_all, bounds = ts_all[keep], dw_all[keep], bounds[keep]
    # leave boundary per arrival: strictly after its join window
    leave_bounds = np.array(
        [max(_quantize_up(t + d, window), b + window)
         if np.isfinite(d) else np.inf
         for t, d, b in zip(ts_all, dw_all, bounds)])

    # group arrivals by (sorted, nondecreasing) boundary
    arrivals: dict[float, np.ndarray] = {}   # boundary -> arrival indices
    if len(bounds):
        uniq, starts = np.unique(bounds, return_index=True)
        splits = np.split(np.arange(len(bounds)), starts[1:])
        arrivals = {float(b): idx for b, idx in zip(uniq, splits)}

    boundaries = sorted(set(arrivals)
                        | set(trace_leaves)
                        | {float(lb) for lb in leave_bounds
                           if np.isfinite(lb) and lb <= horizon})

    # ---- replay boundaries, allocating smallest-free ids
    M = int(capacity)
    present = np.zeros(M, bool)
    join_seq = np.full(M, -1, np.int64)      # join-instance token per id
    seq = 0
    n_dropped = 0
    # leave boundary -> list of (ids, seqs); a token mismatch means the
    # id left earlier (trace removal) and was reassigned — skip it
    dwell_bucket: dict[float, list] = {}

    k0 = min(M, int(round(spec.init_frac * M)))
    present[:k0] = True
    join_seq[:k0] = np.arange(k0)
    seq = k0

    def _process(b: float):
        nonlocal seq, n_dropped
        leave_ids = []
        for ids, seqs in dwell_bucket.pop(b, ()):
            ok = present[ids] & (join_seq[ids] == seqs)
            leave_ids.append(ids[ok])
        n_trace = trace_leaves.get(b, 0)
        if n_trace:
            for part in leave_ids:           # dwell departures leave first,
                present[part] = False        # so they can't be trace victims
            live = np.flatnonzero(present)
            victims = live[np.argsort(join_seq[live],
                                      kind="stable")[:n_trace]]
            leave_ids.append(victims)
        leaves = (np.sort(np.concatenate(leave_ids)).astype(np.int64)
                  if leave_ids else np.empty(0, np.int64))
        present[leaves] = False

        idx = arrivals.get(b)
        if idx is None:
            joins = np.empty(0, np.int64)
        else:
            k = len(idx)
            free = np.flatnonzero(~present)[:k]
            n_dropped += k - len(free)
            present[free] = True
            join_seq[free] = seq + np.arange(len(free))
            seq += len(free)
            lbs = leave_bounds[idx[:len(free)]]
            fin = np.isfinite(lbs) & (lbs <= horizon)
            for lb in np.unique(lbs[fin]):
                m = fin & (lbs == lb)
                dwell_bucket.setdefault(float(lb), []).append(
                    (free[m], join_seq[free[m]]))
            joins = free.astype(np.int64)
        return leaves, joins

    if 0.0 in arrivals or 0.0 in trace_leaves:
        _process(0.0)                        # fold window-0 into initial
    initial = np.flatnonzero(present).astype(np.int64)

    raw_segments = []
    for b in boundaries:
        if b <= 0.0:
            continue
        leaves, joins = _process(b)
        if len(leaves) or len(joins):
            raw_segments.append((b, joins, leaves))

    segments = []
    for i, (b, joins, leaves) in enumerate(raw_segments):
        end = (raw_segments[i + 1][0] if i + 1 < len(raw_segments)
               else max(horizon, b))
        segments.append(TrafficSegment(start=b, end=end, joins=joins,
                                       leaves=leaves))
    return TrafficSchedule(spec=spec, seed=seed, capacity=M,
                           horizon=horizon, initial=initial,
                           segments=tuple(segments), n_dropped=n_dropped)


def build_traffic_schedule(profile: str, capacity: int, seed: int,
                           horizon_cap: Optional[float] = None
                           ) -> Optional[TrafficSchedule]:
    """Profile-or-spec string -> compiled schedule, or None when traffic
    is off (the off path allocates nothing and draws no RNG)."""
    spec = parse_traffic(TRAFFIC_PROFILES.get(profile, profile))
    if not spec.active:
        return None
    return compile_traffic_schedule(spec, capacity, seed,
                                    horizon_cap=horizon_cap)
