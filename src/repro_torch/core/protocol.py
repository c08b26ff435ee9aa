"""Typed event -> action protocol between the scheduler and reactive policies.

The poll-based ``Controller.run`` loop asked a passive ``Strategy`` three
questions (``select`` / ``results_needed`` / ``usable``) and blocked in
``EventLoop.run_until`` — a shape that cannot express mid-round reactions
(straggler hedging, adaptive CR, per-tier timeouts). This module is the new
boundary (DESIGN.md §7): the ``Scheduler`` translates every simulation
occurrence into a typed :class:`Event`, hands it to a
:class:`ReactivePolicy` together with a read-only :class:`DatabaseView`,
and executes the returned :class:`Action` list against the FaaS platform,
update store, and aggregation service.

Events (what happened)            Actions (what the policy wants)
--------------------------------  -------------------------------------
``RoundStarted``                  ``Invoke`` — run clients this round
``ResultLanded``                  ``Aggregate`` — close the round now
``InvocationFailed``              ``SetTimer`` — wake me at now+delay
``InvocationTimedOut``            ``CancelInvocation`` — kill in-flight
``TimerFired``                    ``Hedge`` — re-invoke outstanding
``ClientJoined`` / ``ClientLeft`` ``Retry`` — re-invoke after a delay
``LoopDrained``                   ``Quarantine`` — bench a repeat offender
                                  ``EndRun`` — terminate the run

Policies must treat the view as read-only; the one sanctioned exception is
``DatabaseView.db``, the mutable database handle the legacy strategies'
``select`` needs for Algorithm 3 booster bookkeeping.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import MappingProxyType
from typing import TYPE_CHECKING, Mapping, Optional, Sequence, Tuple

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.database import ClientRecord, Database, ResultRecord
    from repro_torch.core.strategies.base import Strategy


# ---------------------------------------------------------------------- events


@dataclass(frozen=True)
class Event:
    """Base simulation event; ``t`` is the simulated time it occurred."""

    t: float


@dataclass(frozen=True)
class RoundStarted(Event):
    """A new scheduling round opened (``round`` is its index)."""

    round: int


@dataclass(frozen=True)
class ResultLanded(Event):
    """A client update landed in the database. ``round`` is the round the
    client *trained against* (may trail the current round for stragglers);
    ``result`` is the database record, including its update handle."""

    round: int
    result: "ResultRecord"


@dataclass(frozen=True)
class InvocationFailed(Event):
    """An invocation crashed (or was preempted) and will never produce a
    result. Hedge siblings, if any, keep racing."""

    round: int
    client_id: int


@dataclass(frozen=True)
class InvocationTimedOut(Event):
    """The scheduler's per-invocation timeout (``FLConfig.
    invocation_timeout``, distinct from the sync round deadline) killed an
    in-flight invocation: the container was cancelled, the payload
    released, and the failure counted. Only emitted when the recovery
    layer is enabled (DESIGN.md §12)."""

    round: int
    client_id: int


@dataclass(frozen=True)
class TimerFired(Event):
    """A ``SetTimer`` armed in round ``round`` elapsed. Timers armed in
    earlier rounds are dropped by the scheduler, never dispatched."""

    round: int
    tag: str


@dataclass(frozen=True)
class ClientJoined(Event):
    client_id: int


@dataclass(frozen=True)
class ClientLeft(Event):
    client_id: int


@dataclass(frozen=True)
class ClientsJoined(Event):
    """A traffic segment registered ``client_ids`` in bulk — one event
    per windowed segment, not per client (the open-loop arrival path,
    DESIGN.md §13). Policies that don't care may ignore it."""

    client_ids: Tuple[int, ...]


@dataclass(frozen=True)
class ClientsLeft(Event):
    """Bulk counterpart of ``ClientLeft`` for traffic segments; the
    runtime has already cancelled the departees' in-flight work."""

    client_ids: Tuple[int, ...]


@dataclass(frozen=True)
class LoopDrained(Event):
    """No future events exist (and, for policies with
    ``fire_timers_on_drain=False``, pending timers will not fire). The
    policy must either make progress (``Aggregate`` / ``Invoke``) or
    ``EndRun``; if its answer schedules nothing, the run ends — this is
    the last event such a policy receives."""


# --------------------------------------------------------------------- actions


@dataclass(frozen=True)
class Action:
    pass


@dataclass(frozen=True)
class Invoke(Action):
    """Invoke ``clients`` (in order) for the current round: train the
    cohort against the current global model and start their simulated
    FaaS invocations."""

    clients: Tuple[int, ...]


@dataclass(frozen=True)
class Aggregate(Action):
    """Close the current round: aggregate every usable pending result
    (weights from the underlying strategy), evaluate, log, advance the
    round, and — unless the run is over — dispatch the next
    ``RoundStarted``. Put this last in an action list: actions after it
    execute in the next round's context."""


@dataclass(frozen=True)
class SetTimer(Action):
    """Wake the policy with ``TimerFired(tag)`` at ``now + delay``. The
    timer is tagged with the current round and silently dropped once the
    round closes. A negative delay fires immediately with the simulated
    clock set to the target time (the legacy budget-barrier semantics of
    ``run_until(max_time=...)``); native policies should arm only future
    timers."""

    delay: float
    tag: str


@dataclass(frozen=True)
class CancelInvocation(Action):
    """Cancel every in-flight invocation of ``client_id``: the completion
    event is dropped, the update row/blob is released, and the client
    returns to ``idle``."""

    client_id: int


@dataclass(frozen=True)
class Hedge(Action):
    """Speculatively re-invoke the outstanding invocations of ``clients``
    on their (still-warm) containers. The hedge shares the original's
    trained update and races it: the first completion lands the result and
    cancels the sibling; a failed original leaves the hedge racing."""

    clients: Tuple[int, ...]


@dataclass(frozen=True)
class Retry(Action):
    """Re-invoke ``client_id`` after ``delay`` sim-seconds (the recovery
    layer's backoff step). The scheduler arms a runtime timer scoped to
    the current round: it is dropped if the round closes first, skipped
    if the client left, was quarantined, or is busy again when it fires;
    otherwise the client is re-trained against the *current* global model
    and re-invoked without resetting the sync gating set."""

    client_id: int
    delay: float


@dataclass(frozen=True)
class Quarantine(Action):
    """Circuit-break ``client_id``: mark it quarantined until round
    ``until_round`` (exclusive). Quarantined clients are dropped from the
    idle pool and every strategy's selection mask until the round counter
    passes ``until_round``."""

    client_id: int
    until_round: int


@dataclass(frozen=True)
class EndRun(Action):
    """Terminate the run (the legacy loop's ``break``)."""


# ----------------------------------------------------------------------- views


@dataclass(frozen=True)
class InflightView:
    """Read-only snapshot of one outstanding invocation."""

    client_id: int
    round: int
    t_invoked: float
    is_hedge: bool     # this invocation is itself a speculative re-invoke
    hedged: bool       # a live hedge sibling is racing this invocation


class DatabaseView:
    """Read-only window onto the scheduler's state for policies.

    Everything here is a cheap view over live state — no copies beyond the
    tuples handed out — valid only for the duration of one ``on_event``
    call. ``db`` is the legacy escape hatch (see module docstring).
    """

    def __init__(self, runtime):
        self._rt = runtime

    # -- time & round ------------------------------------------------------
    @property
    def now(self) -> float:
        return self._rt.loop.now

    @property
    def round(self) -> int:
        return self._rt.current_round

    @property
    def round_start(self) -> float:
        """Simulated time the current round opened."""
        return self._rt.round_start

    @property
    def max_sim_time(self) -> float:
        return self._rt.cfg.max_sim_time

    # -- database ----------------------------------------------------------
    @property
    def db(self) -> "Database":
        """Mutable database handle — sanctioned ONLY for legacy
        ``Strategy.select`` calls (booster bookkeeping)."""
        return self._rt.db

    @property
    def clients(self) -> Mapping[int, "ClientRecord"]:
        """Record view — O(fleet) materialization on the columnar plane;
        policies should prefer the plane-agnostic accessors below."""
        return MappingProxyType(self._rt.db.clients)

    @property
    def control_plane(self) -> str:
        return self._rt.db.control_plane

    @property
    def n_clients(self) -> int:
        return self._rt.db.n_clients

    def has_client(self, client_id: int) -> bool:
        return self._rt.db.has_client(client_id)

    def any_idle(self) -> bool:
        """Any registered client currently idle (both planes, O(columns))."""
        return self._rt.db.any_idle()

    def recent_durations(self, client_id: int, k: int):
        """The client's last <=k training durations, oldest first (empty
        list for unknown clients) — the hedge-ranking accessor."""
        return self._rt.db.recent_durations(client_id, k)

    @property
    def results(self) -> Tuple["ResultRecord", ...]:
        return tuple(self._rt.db.results)

    def pending_results(self, max_staleness: Optional[int] = None,
                        round_: Optional[int] = None):
        """Un-aggregated results inside the staleness window (defaults:
        the configured cap, the current round)."""
        if max_staleness is None:
            max_staleness = self._rt.cfg.max_staleness
        if round_ is None:
            round_ = self._rt.current_round
        return self._rt.db.pending_results(max_staleness, round_)

    @property
    def completed_this_round(self) -> frozenset:
        """Client ids whose invocations completed since this round's first
        ``Invoke`` (the sync gating set)."""
        return frozenset(self._rt._completed_this_round)

    # -- in-flight invocations --------------------------------------------
    def outstanding(self, round_: Optional[int] = None
                    ) -> Tuple[InflightView, ...]:
        """Live (not completed, not cancelled) invocations, optionally
        restricted to one round."""
        out = []
        for invs in self._rt.inflight.values():
            for inv in invs:
                if inv.done or (round_ is not None and inv.round != round_):
                    continue
                out.append(InflightView(
                    client_id=inv.client_id, round=inv.round,
                    t_invoked=inv.t_invoked, is_hedge=inv.is_hedge,
                    hedged=inv.payload.refs > 1))
        return tuple(out)


# ---------------------------------------------------------------------- policy


class ReactivePolicy:
    """Event-driven strategy: ``on_event(event, view) -> [Action, ...]``.

    ``strategy`` is the underlying :class:`Strategy` whose aggregation
    contract (``usable`` / ``result_weight`` / ``prox_mu`` /
    ``needs_scaffold``) the runtime services keep consulting — reactive
    policies redesign the *scheduling*, not the paper's weighting math.

    ``fire_timers_on_drain``: whether armed timers still fire once the
    platform has no future events. The legacy adapter sets this False to
    reproduce the poll loop's drain semantics (a drained ``run_until``
    returns at the last event's time, never advancing to its deadline).
    """

    name: str = "reactive"
    fire_timers_on_drain: bool = True
    strategy: "Strategy"

    def on_event(self, event: Event, view: DatabaseView) -> Sequence[Action]:
        raise NotImplementedError

    def metrics(self) -> dict:
        """Policy-specific numbers merged into ``Scheduler.metrics()``."""
        return {}

    # -- durability (coordinated snapshots, DESIGN.md §14) -------------
    def state_dict(self) -> dict:
        """Mutable policy state for a durable resume. The base captures
        the wrapped strategy; stateful policies extend this."""
        return {"strategy": self.strategy.state_dict()}

    def load_state(self, state: dict) -> None:
        self.strategy.load_state(state["strategy"])
