"""Host-clock spans of the program: where the host was when the card idled.

Off by default. ``start()`` clears the recorder and begins recording,
``stop()`` ends it and returns the spans. While it is on,

  * ``span(name)`` is a context manager around a block,
  * ``begin(name)`` / ``end(token)`` bracket a span that does not nest
    lexically (the scheduler's round). Where a counter already keeps
    seconds (a snapshot's ``snapshot_s``, the mesh's ``collective_s``),
    its clock reads go to them (``at=``), so the counter and the span are
    one measurement.

A span is ``Span(name, start_ns, end_ns, parent, round)``: times on
``time.perf_counter_ns()`` (the clock ``portbench``'s spans and its device
trace's anchor read), ``parent`` the index in the same list of the span
open around it when it began (-1 for none), ``round`` the FL round of the
nearest enclosing ``round`` span (None outside one). Spans are listed in
the order they began; a span still open at ``stop()`` ends there. They stay in memory until ``stop()``: there is no
exporter and no file.

Off, ``span()`` returns one shared no-op context and ``begin`` returns
None, so a call site costs one call and allocates nothing. On or off, no
span synchronizes the card, reads a tensor or changes a value; the
program's own waits on the card (a cohort's losses to the host, the
evaluation's count, aggregation's finiteness guard) have spans of their
own (``*.wait``), so the time the host waits shows as a span.

The process has one recorder: spans from every engine and thread of the
process land in the same list (the program runs one thread).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

_clock = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    round: Optional[int]


class _Recorder:
    """The spans of one session: ``[name, start, end, parent, round]``
    lists, and the indices of those still open, innermost last."""

    __slots__ = ("spans", "open")

    def __init__(self):
        self.spans: list[list] = []
        self.open: list[int] = []


_rec: Optional[_Recorder] = None


class _Off:
    """The context ``span()`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.token = begin(self.name)
        return None

    def __exit__(self, *exc):
        end(self.token)
        return False


def start() -> None:
    """Clear the recorder and begin recording."""
    global _rec
    _rec = _Recorder()


def stop() -> list[Span]:
    """End recording; the session's spans, those still open ending now."""
    global _rec
    rec, _rec = _rec, None
    if rec is None:
        return []
    now = _clock()
    return [Span(n, t0, now if t1 is None else t1, p, r)
            for n, t0, t1, p, r in rec.spans]


def span(name: str):
    """A context manager recording ``name`` around its block while
    tracing is on; the shared no-op context while it is off."""
    return _OFF if _rec is None else _On(name)


def begin(name: str, *, round: Optional[int] = None,
          at: Optional[int] = None):
    """Open ``name`` (at ``at`` ns, default now) and return the token that
    ``end`` takes; None while tracing is off. ``round`` sets the span's FL
    round (spans opened inside it inherit it)."""
    rec = _rec
    if rec is None:
        return None
    parent = rec.open[-1] if rec.open else -1
    if round is None and parent >= 0:
        round = rec.spans[parent][4]
    rec.spans.append([name, _clock() if at is None else at, None, parent,
                      round])
    rec.open.append(len(rec.spans) - 1)
    return rec, rec.open[-1]


def end(token, *, at: Optional[int] = None) -> None:
    """Close the span ``begin`` returned ``token`` for (at ``at`` ns,
    default now). A token of a session since stopped, or None, is
    ignored."""
    if token is None:
        return
    rec, i = token
    if rec is not _rec:
        return
    rec.spans[i][2] = _clock() if at is None else at
    if rec.open and rec.open[-1] == i:
        rec.open.pop()
    elif i in rec.open:
        rec.open.remove(i)

