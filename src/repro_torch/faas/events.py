"""Discrete-event engine for the serverless simulation.

Simulated wall-clock is fully decoupled from real compute: client training
runs eagerly in JAX while durations come from the hardware model, so the
event loop reproduces the paper's timing behaviour (cold starts, stragglers,
round timeouts) deterministically and fast.

Cancellation is tombstone-based (``cancel`` just flags the entry), but the
heap compacts itself lazily: once more than half the entries are dead —
the steady state under heavy hedging/cancellation (DESIGN.md §7) — the
live entries are re-heapified in one O(n) pass, so the heap stays bounded
by the live event count and ``pending`` is O(1).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    callback: Callable[[], None] = field(compare=False)
    cancelled: bool = field(compare=False, default=False)
    popped: bool = field(compare=False, default=False)


class EventLoop:
    def __init__(self):
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self._n_cancelled = 0       # tombstones currently in the heap
        self.now: float = 0.0

    def schedule(self, delay: float, callback: Callable[[], None]) -> _Event:
        assert delay >= 0, delay
        ev = _Event(self.now + delay, next(self._seq), callback)
        heapq.heappush(self._heap, ev)
        return ev

    def cancel(self, ev: _Event) -> None:
        if ev.cancelled or ev.popped:
            return  # idempotent; popped events are no longer in the heap
        ev.cancelled = True
        self._n_cancelled += 1
        if self._n_cancelled * 2 > len(self._heap):
            self._compact()

    def _compact(self) -> None:
        """Drop every tombstone in one pass (O(live) re-heapify)."""
        self._heap = [e for e in self._heap if not e.cancelled]
        heapq.heapify(self._heap)
        self._n_cancelled = 0

    def _pop_live(self) -> Optional[_Event]:
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                self._n_cancelled -= 1
                continue
            return ev
        return None

    def peek(self) -> Optional[float]:
        """Time of the next live event, without running it (None if empty)."""
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
            self._n_cancelled -= 1
        return self._heap[0].time if self._heap else None

    def step(self) -> bool:
        """Pop and run exactly one live event (the scheduler's pump).
        Returns False if the heap is empty."""
        ev = self._pop_live()
        if ev is None:
            return False
        ev.popped = True
        self.now = ev.time
        ev.callback()
        return True

    def run_until(self, predicate: Callable[[], bool],
                  max_time: float = float("inf")) -> bool:
        """Pop events until predicate() holds. Returns False if the loop
        drained or max_time passed first."""
        while not predicate():
            ev = self._pop_live()
            if ev is None:
                return False
            if ev.time > max_time:
                heapq.heappush(self._heap, ev)  # put back; caller hit deadline
                self.now = max_time
                return False
            ev.popped = True
            self.now = ev.time
            ev.callback()
        return True

    def run_all(self, max_time: float = float("inf")) -> None:
        self.run_until(lambda: False, max_time)

    @property
    def pending(self) -> int:
        return len(self._heap) - self._n_cancelled
