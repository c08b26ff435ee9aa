"""Reactive policies for the event-driven scheduler (DESIGN.md §7).

``LegacyStrategyAdapter`` translates the old poll-loop query contract
(``select`` / ``results_needed`` / ``usable`` + the sync round timeout)
into the typed event->action protocol, reproducing the legacy
``Controller.run`` loop *bit-exactly* — selections, aggregation round
boundaries, simulated timestamps, accuracies (tests/test_golden_trace.py).
Its state machine mirrors the loop's four waits:

  phase "selecting"        <- run_until(any client idle)        [W1]
  phase "gated" (async)    <- run_until(pending >= CR gate)     [W2]
  phase "gated" (sync)     <- run_until(all completed, deadline) [W3]
  phase "awaiting_usable"  <- run_until(any usable result)      [W4]

with the loop's ``max_time`` barriers expressed as timers ("deadline",
"budget") and its drained-heap fallthroughs handled on ``LoopDrained``.

The two native policies prove the protocol buys capability the poll loop
could not express:

* ``apodotiko-hedge`` — Apodotiko's CR-gated rounds, plus straggler
  hedging: the moment the CR fraction lands, the slowest outstanding
  invocations are speculatively re-invoked on their still-warm containers
  (no cold start, a fresh performance draw), racing the originals. This
  attacks exactly the cold-start + straggler tail the paper measures.
* ``apodotiko-adaptive`` — adjusts CR between rounds from the observed
  result-arrival dispersion: a wide landing window (stragglers dominate)
  lowers CR so rounds stop waiting; a tight window raises it so each
  aggregation uses more results.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.core.protocol import (Action, Aggregate, ClientJoined, ClientLeft,
                                 DatabaseView, EndRun, Event, Hedge, Invoke,
                                 InvocationFailed, LoopDrained, ReactivePolicy,
                                 ResultLanded, RoundStarted, SetTimer,
                                 TimerFired)
from repro_torch.core.strategies.base import (STRATEGIES, Strategy, StrategyConfig,
                                        build_strategy)


class LegacyStrategyAdapter(ReactivePolicy):
    """Adapts a passive ``Strategy`` to the reactive protocol (see module
    docstring for the phase <-> poll-loop wait correspondence)."""

    fire_timers_on_drain = False  # a drained run_until never reached its
    #                               deadline; reproduce that exactly

    def __init__(self, strategy: Strategy, name: Optional[str] = None):
        self.strategy = strategy
        self.name = name or strategy.name
        self._phase = "idle"
        self._selection: set[int] = set()

    # -- durability (coordinated snapshots, DESIGN.md §14) ----------------
    def state_dict(self) -> dict:
        s = super().state_dict()
        s["phase"] = self._phase
        s["selection"] = sorted(self._selection)
        return s

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self._phase = state["phase"]
        self._selection = set(int(c) for c in state["selection"])

    # ------------------------------------------------------------- helpers
    def _gate_satisfied(self, view: DatabaseView) -> bool:
        s = self.strategy
        if s.is_async:
            return len(view.pending_results()) >= s.results_needed()
        q = getattr(s.cfg, "quorum_fraction", 1.0)
        if q >= 1.0:
            # the legacy full-cohort gate, kept verbatim for bit-identity
            return self._selection <= view.completed_this_round
        # graceful degradation (DESIGN.md §12): close once a quorum of
        # the selected cohort has landed; the stragglers' results arrive
        # too late and are simply unusable (sync usable() wants round == T)
        need = max(int(np.ceil(q * len(self._selection))), 1)
        return len(self._selection & view.completed_this_round) >= need

    def _open(self, view: DatabaseView) -> list[Action]:
        """Round start (or re-select once a client went idle)."""
        s = self.strategy
        with tracing.span("selection"):
            selection = s.select(view.db, view.round)
        if not selection:
            self._phase = "selecting"
            return []
        self._selection = set(selection)
        self._phase = "gated"
        acts: list[Action] = [Invoke(tuple(selection))]
        if s.is_async:
            # the sim-budget barrier of run_until(max_time=max_sim_time)
            acts.append(SetTimer(view.max_sim_time - view.now, "budget"))
            if self._gate_satisfied(view):
                # stale pending results already satisfy the CR gate:
                # aggregate immediately (legacy checks before any pop)
                self._phase = "closing"
                acts.append(Aggregate())
        else:
            acts.append(SetTimer(s.cfg.round_timeout, "deadline"))
        return acts

    def _close(self) -> list[Action]:
        self._phase = "closing"
        return [Aggregate()]

    def _budget_or_drain(self, view: DatabaseView,
                         drained: bool) -> list[Action]:
        """The loop's run_until returned False: either the heap drained or
        a max_time barrier (deadline/budget) was hit."""
        if self._phase == "selecting":
            # W1 has no barrier; only a drain ends the run
            return [EndRun()] if drained else []
        if self._phase == "gated" and self.strategy.is_async:
            # W2: aggregate whatever is pending; nothing at all -> stop
            return self._close() if view.pending_results() else [EndRun()]
        if self._phase in ("gated", "awaiting_usable"):
            # W3/W4: close the round with whatever is usable (possibly
            # nothing — a zero-aggregation round advances the counter)
            return self._close()
        return []

    # ------------------------------------------------------------ dispatch
    def on_event(self, ev: Event, view: DatabaseView) -> Sequence[Action]:
        s = self.strategy
        if isinstance(ev, RoundStarted):
            return self._open(view)
        if isinstance(ev, (ResultLanded, InvocationFailed)):
            if self._phase == "selecting":
                if view.any_idle():
                    return self._open(view)
                return []
            if self._phase == "gated":
                if isinstance(ev, ResultLanded) and self._gate_satisfied(view):
                    return self._close()
                return []
            if self._phase == "awaiting_usable":
                if isinstance(ev, ResultLanded) and s.usable(ev.result,
                                                             view.round):
                    return self._close()
                return []
            return []
        if isinstance(ev, TimerFired):
            if ev.round != view.round:
                return []           # stale timer from a closed round
            if ev.tag == "deadline" and self._phase == "gated":
                # sync deadline: aggregate if anything is usable, else wait
                # for the first usable result under the sim budget
                if any(s.usable(r, view.round)
                       for r in view.pending_results()):
                    return self._close()
                self._phase = "awaiting_usable"
                return [SetTimer(view.max_sim_time - view.now, "budget")]
            if ev.tag == "budget":
                return self._budget_or_drain(view, drained=False)
            return []
        if isinstance(ev, LoopDrained):
            return self._budget_or_drain(view, drained=True)
        if isinstance(ev, (ClientJoined, ClientLeft)):
            return []
        return []


class ApodotikoHedge(LegacyStrategyAdapter):
    """Apodotiko + straggler hedging at the CR gate (module docstring).

    Hedge targets are the un-hedged outstanding invocations (any round in
    the staleness window), slowest-expected first — ranked by the client's
    recent mean duration, unknown clients first (they are the likeliest
    cold stragglers) — capped at ``ceil(hedge_fraction x outstanding)``.
    """

    def __init__(self, cfg: StrategyConfig):
        super().__init__(build_strategy("apodotiko", cfg),
                         name="apodotiko-hedge")
        self.hedge_fraction = cfg.hedge_fraction

    def on_event(self, ev: Event, view: DatabaseView) -> Sequence[Action]:
        acts = list(super().on_event(ev, view))
        if any(isinstance(a, Aggregate) for a in acts):
            hedges = self._pick_hedges(view)
            if hedges:
                # hedge before the aggregate closes the round, so the
                # re-invocations are recorded against the round they rescue
                acts.insert(len(acts) - 1, Hedge(tuple(hedges)))
        return acts

    def _pick_hedges(self, view: DatabaseView) -> list[int]:
        cands = [iv for iv in view.outstanding()
                 if not iv.hedged and not iv.is_hedge]
        if not cands:
            return []
        k = max(1, int(np.ceil(self.hedge_fraction * len(cands))))

        def expected_slowness(iv):
            hist = view.recent_durations(iv.client_id, 5)
            expected = float(np.mean(hist)) if hist else float("inf")
            return (expected, view.now - iv.t_invoked)

        cands.sort(key=expected_slowness, reverse=True)
        return [iv.client_id for iv in cands[:k]]


class ApodotikoAdaptive(LegacyStrategyAdapter):
    """Apodotiko + between-round CR adaptation from result-arrival
    dispersion (module docstring). The adjusted CR feeds straight into the
    underlying strategy's ``results_needed`` for the next round."""

    CR_MIN, CR_MAX = 0.1, 0.9
    STEP = 0.2          # multiplicative CR adjustment per triggered round
    HIGH, LOW = 1.5, 0.6  # dispersion thresholds (landing-window / median)

    def __init__(self, cfg: StrategyConfig):
        super().__init__(build_strategy("apodotiko", cfg),
                         name="apodotiko-adaptive")
        self.cr_history: list[float] = [cfg.concurrency_ratio]

    def state_dict(self) -> dict:
        s = super().state_dict()
        s["cr_history"] = list(self.cr_history)
        return s

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        self.cr_history = list(state["cr_history"])

    def on_event(self, ev: Event, view: DatabaseView) -> Sequence[Action]:
        acts = super().on_event(ev, view)
        if any(isinstance(a, Aggregate) for a in acts):
            arrivals = sorted(r.t_available - view.round_start
                              for r in view.pending_results()
                              if r.round == view.round)
            self.strategy.cfg.concurrency_ratio = self.next_cr(arrivals)
        return acts

    def next_cr(self, arrivals: Sequence[float]) -> float:
        """Pure adjustment rule: dispersion = (last - first arrival) /
        median arrival of the results that filled this round's gate."""
        cr = self.strategy.cfg.concurrency_ratio
        if len(arrivals) >= 2:
            med = max(arrivals[len(arrivals) // 2], 1e-9)
            spread = (arrivals[-1] - arrivals[0]) / med
            if spread > self.HIGH:
                cr *= 1.0 - self.STEP   # stragglers dominate: wait for fewer
            elif spread < self.LOW:
                cr *= 1.0 + self.STEP   # tight landing: afford more results
        cr = float(min(self.CR_MAX, max(self.CR_MIN, cr)))
        self.cr_history.append(cr)
        return cr

    def metrics(self) -> dict:
        return {"cr_history": [round(c, 4) for c in self.cr_history]}


REACTIVE_POLICIES: dict[str, type] = {
    "apodotiko-hedge": ApodotikoHedge,
    "apodotiko-adaptive": ApodotikoAdaptive,
}


def is_reactive(name: str) -> bool:
    """True for natively-reactive policy names (scheduler-only)."""
    return name in REACTIVE_POLICIES


def make_policy(name: str, cfg: StrategyConfig) -> ReactivePolicy:
    """Build the reactive policy for a strategy name: native policies
    directly, legacy strategy names through the adapter."""
    if name in REACTIVE_POLICIES:
        return REACTIVE_POLICIES[name](cfg)
    if name in STRATEGIES:
        return LegacyStrategyAdapter(build_strategy(name, cfg))
    raise KeyError(
        f"unknown strategy {name!r}; legacy: {', '.join(sorted(STRATEGIES))}; "
        f"reactive: {', '.join(sorted(REACTIVE_POLICIES))}")
