"""Event-driven round scheduler (twin of ``repro.core.scheduler``): the
reactive replacement for the poll-based ``Controller.run`` loop, and the
port's default engine.

The ``Scheduler`` owns the same :class:`~repro_torch.core.services.FLRuntime`
substrate as the poll-loop controller but drives it reactively: every
simulation occurrence — an invocation completing or failing, a timer
elapsing, the platform quiescing — is dispatched as a typed protocol event
to a :class:`~repro_torch.core.protocol.ReactivePolicy`, and the returned
actions (``Invoke``/``Aggregate``/``SetTimer``/``CancelInvocation``/
``Hedge``/``Retry``/``Quarantine``/``EndRun``) are executed against the
runtime services. The legacy strategies run through
``LegacyStrategyAdapter`` with round traces identical to the poll loop's;
the natively reactive policies (``apodotiko-hedge``,
``apodotiko-adaptive``) express mid-round behaviour the poll loop could
not.

Timers live in a separate min-heap, not the platform event heap, so a
policy's armed-but-unreached deadlines never perturb simulated time: they
are dropped when their round closes, and — for legacy-compat policies
(``fire_timers_on_drain=False``) — never fire once the platform has no
future events, exactly like a drained ``run_until`` that never reached its
``max_time``.

Before every round the Scheduler tries the fused-round megastep
(``core.megastep``; ``megastep="fused"``, the default, as in the
reference): a run of provably quiescent rounds runs as one fused loop, and
``megastep_fallback_reason`` says why a round did not. Open-loop traffic
(``FLConfig.traffic_profile``) shifts membership only at fresh-round open,
as in the poll loop, and a run stalled for lack of clients jumps to the
next arrival boundary. With ``durability="journal"`` every dispatched event
is journaled before its actions run (``_dispatch``), each round close
writes its marker and, on cadence, a coordinated snapshot, and ``run``
ends the journal with ``run_end`` (``repro_torch.durability``); a durable
run refuses the megastep, whose fused rounds dispatch no events.

Entry points::

    sched = Scheduler(cfg, model, data, fleet)      # cfg.strategy names a
    metrics = sched.run()                           # legacy strategy or a
                                                    # reactive policy

    eng = build_engine(cfg, model, data, fleet)     # engine-aware factory
                                                    # (cfg.engine)

Both take ``device=None`` (the CUDA card) or ``device="cpu"``.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch import tracing
from repro_torch.core.controller import Controller
from repro_torch.core.database import Database
from repro_torch.core.megastep import try_megastep
from repro_torch.core.protocol import (Action, Aggregate, CancelInvocation,
                                       DatabaseView, EndRun, Event, Hedge,
                                       Invoke, LoopDrained, Quarantine,
                                       ReactivePolicy, Retry, RoundStarted,
                                       SetTimer, TimerFired)
from repro_torch.core.recovery import RecoveryPolicy, recovery_enabled
from repro_torch.core.services import (FLConfig, FLRuntime, Inflight,
                                       RoundLog, resolve_engine,
                                       resolve_megastep, strategy_config)
from repro_torch.core.strategies.reactive import is_reactive, make_policy

#: timer-heap round key for runtime timers (invocation timeouts). The huge
#: sentinel keeps ``_peek_timer``'s round-closed purge from ever dropping a
#: timeout whose invocation outlives its round.
_RUNTIME_ROUND = 1 << 62


@dataclass
class _RetryTag:
    """Timer payload for a pending backoff re-invocation."""

    client_id: int
    t_failed: float     # when the failure fired (retry-latency metric)


class Scheduler(FLRuntime):
    """Reactive round driver: dispatches protocol events to a policy and
    executes its actions (see module docstring)."""

    engine_name = "scheduler"

    def __init__(self, cfg: FLConfig, model, data, fleet, *,
                 policy: Optional[ReactivePolicy] = None,
                 db: Optional[Database] = None, init_params=None,
                 device=None):
        if policy is None:
            policy = make_policy(cfg.strategy, strategy_config(cfg))
        if recovery_enabled(cfg) and not isinstance(policy, RecoveryPolicy):
            policy = RecoveryPolicy(policy, cfg)
        self.policy = policy
        super().__init__(cfg, model, data, fleet, db=db,
                         init_params=init_params, strategy=policy.strategy,
                         device=device)
        self.view = DatabaseView(self)
        self._timers: list[tuple] = []   # (time, seq, round, tag)
        self._timer_seq = itertools.count()
        self._t0 = self.loop.now
        self._done = False
        self._invoked_this_round = False
        self._progress: Optional[Callable[[RoundLog], None]] = None
        self._round_span = None         # tracing's token for the open round
        self.n_events = 0               # protocol events dispatched
        self.n_coalesced = 0            # actions merged into batched dispatches
        # fused-round megastep (core.megastep): runs of quiescent rounds
        # lowered into one fused loop
        self.megastep = resolve_megastep(cfg.megastep)
        self.megastep_rounds = 0        # rounds executed inside fused loops
        self.megastep_scans = 0         # fused loops entered
        self.megastep_fallback_reason = "unattempted"

    # -------------------------------------------------------------------- run
    def run(self, progress: Optional[Callable[[RoundLog], None]] = None):
        cfg = self.cfg
        self._progress = progress
        self._done = False
        # NOTE: self._acc is NOT reset here — it carries the last
        # evaluated accuracy across a durable resume (eval_every > 1)
        if self.db.round >= cfg.rounds or self.loop.now >= cfg.max_sim_time:
            if self.durability is not None:
                self.durability.finish()
            return self.metrics()
        self._open_round()
        drained = 0
        while not self._done:
            if self._pump_one():
                drained = 0
                continue
            if (not self._invoked_this_round and not self.inflight
                    and not self.db.any_idle()
                    and self._traffic_fast_forward()):
                # stalled for lack of clients (not policy inaction): under
                # open-loop traffic the clock jumps to the next arrival
                # boundary and the round re-opens against the new fleet,
                # the poll loop's drained re-poll, not an EndRun
                self._t0 = self.loop.now
                self._dispatch(RoundStarted(t=self.loop.now,
                                            round=self.db.round))
                drained = 0
                continue
            drained += 1
            if drained > 1:
                break               # policy made no progress on drain
            self._dispatch(LoopDrained(t=self.loop.now))
        if self.durability is not None:
            self.durability.finish()
        return self.metrics()

    # ------------------------------------------------------------------- pump
    def _peek_timer(self) -> Optional[float]:
        while self._timers:
            t, _, round_, tag = self._timers[0]
            if round_ < self.db.round:
                heapq.heappop(self._timers)     # stale: its round closed
            elif isinstance(tag, Inflight) and tag.done:
                heapq.heappop(self._timers)     # invocation already settled
            else:
                return t
        return None

    def _pump_one(self) -> bool:
        """Advance simulated time by one occurrence — the earliest of the
        next platform event and the next timer (events win ties, matching
        the poll loop's pop-then-check-deadline order: a result landing at
        exactly the timeout instant counts as completed). Returns False
        when quiescent."""
        t_ev = self.loop.peek()
        t_tm = self._peek_timer()
        # runtime timers (timeouts/retries — non-str tags) are scheduler
        # machinery, not policy deadlines: they fire on a drained loop
        # regardless of the policy's legacy-compat fire_timers_on_drain
        runtime_head = bool(self._timers
                            and not isinstance(self._timers[0][3], str))
        fire_timer = t_tm is not None and (
            (t_ev is None and (self.policy.fire_timers_on_drain
                               or runtime_head))
            or (t_ev is not None and t_tm < t_ev))
        if fire_timer:
            t, _, round_, tag = heapq.heappop(self._timers)
            if isinstance(tag, Inflight):
                # never move the clock backward for runtime timers (a
                # budget barrier may already have pushed now past t)
                self.loop.now = max(self.loop.now, t)
                self.timeout_invocation(tag)
                return True
            if isinstance(tag, _RetryTag):
                self.loop.now = max(self.loop.now, t)
                self._fire_retry(tag)
                return True
            # the clock may move backward here: a "budget" barrier armed
            # past max_sim_time replays run_until's ``now = max_time``
            self.loop.now = t
            self._dispatch(TimerFired(t=t, round=round_, tag=tag))
            return True
        if t_ev is None:
            return False
        return self.loop.step()     # completion callbacks _emit protocol events

    # ----------------------------------------------------------- recovery
    def _launch(self, cid: int, round_: int, steps: float, payload,
                n_samples: int, loss: float, *, is_hedge: bool = False
                ) -> Inflight:
        inv = super()._launch(cid, round_, steps, payload, n_samples, loss,
                              is_hedge=is_hedge)
        if self.cfg.invocation_timeout > 0:
            heapq.heappush(self._timers,
                           (self.loop.now + self.cfg.invocation_timeout,
                            next(self._timer_seq), _RUNTIME_ROUND, inv))
        return inv

    def _fire_retry(self, tag: _RetryTag) -> None:
        """A backoff timer elapsed: re-invoke the client against the
        *current* global model — unless it left the fleet, got quarantined
        meanwhile, or is already busy (a hedge or manual re-invoke won the
        race)."""
        cid = tag.client_id
        if (not self.db.has_client(cid) or self.db.is_quarantined(cid)
                or any(not i.done for i in self.inflight.get(cid, ()))):
            return
        self.n_retries += 1
        self.retry_latency_s += self.loop.now - tag.t_failed
        self.invoke_round(self.db.round, [cid], reset_completed=False)

    # --------------------------------------------------------------- dispatch
    def _emit(self, event: Event) -> None:
        self._dispatch(event)

    def _dispatch(self, event: Event) -> None:
        # write-ahead: the journal records the occurrence before any of
        # its actions execute (repro_torch.durability)
        if self.durability is not None:
            self.durability.record_event(event)
        self.n_events += 1
        actions = self.policy.on_event(event, self.view)
        for action in self._coalesce(actions or ()):
            self._execute(action)

    def _coalesce(self, actions) -> list[Action]:
        """Merge same-instant cohort work: all ``Invoke`` actions a policy
        emits in one dispatch pump collapse into a single batched cohort
        dispatch, and likewise all ``Hedge`` actions.
        ``Aggregate``/``EndRun``/``CancelInvocation`` are barriers: they
        change what a later ``Invoke`` would mean (a new global model, a
        cancelled client), so merging never crosses them. ``Invoke`` and
        ``Hedge`` are also barriers for *each other*: merging a ``Hedge``
        backward across an ``Invoke`` (or vice versa) would reorder a
        hedge relative to the invocation it targets, so interleaved
        sequences keep their relative order and only same-kind runs
        separated by neutral actions (e.g. ``SetTimer``) merge. Duplicate
        client ids keep their first occurrence."""
        out: list[Action] = []
        inv_at: Optional[int] = None
        hedge_at: Optional[int] = None
        for a in actions:
            if isinstance(a, Invoke):
                hedge_at = None
                if inv_at is None:
                    inv_at = len(out)
                    out.append(a)
                else:
                    prev = out[inv_at]
                    extra = tuple(c for c in a.clients
                                  if c not in prev.clients)
                    out[inv_at] = Invoke(prev.clients + extra)
                    self.n_coalesced += 1
            elif isinstance(a, Hedge):
                inv_at = None
                if hedge_at is None:
                    hedge_at = len(out)
                    out.append(a)
                else:
                    prev = out[hedge_at]
                    extra = tuple(c for c in a.clients
                                  if c not in prev.clients)
                    out[hedge_at] = Hedge(prev.clients + extra)
                    self.n_coalesced += 1
            else:
                out.append(a)
                if isinstance(a, (Aggregate, EndRun, CancelInvocation)):
                    inv_at = hedge_at = None
        return out

    def _execute(self, action: Action) -> None:
        if isinstance(action, Invoke):
            selection = [c for c in action.clients if self.db.has_client(c)]
            if selection:
                self.invoke_round(self.db.round, selection,
                                  reset_completed=not self._invoked_this_round)
                self._invoked_this_round = True
        elif isinstance(action, Hedge):
            self.hedge_invocations(list(action.clients))
        elif isinstance(action, CancelInvocation):
            self.cancel_client(action.client_id)
        elif isinstance(action, SetTimer):
            heapq.heappush(self._timers,
                           (self.loop.now + action.delay,
                            next(self._timer_seq), self.db.round, action.tag))
        elif isinstance(action, Retry):
            # round-scoped (pushed with db.round): a pending retry is
            # abandoned when its round closes
            heapq.heappush(self._timers,
                           (self.loop.now + action.delay,
                            next(self._timer_seq), self.db.round,
                            _RetryTag(action.client_id, self.loop.now)))
        elif isinstance(action, Quarantine):
            self.db.quarantine(action.client_id, action.until_round)
            self.n_quarantined += 1
        elif isinstance(action, Aggregate):
            self._close_round()
        elif isinstance(action, EndRun):
            self._done = True
        else:
            raise TypeError(f"unknown action {action!r}")

    # ------------------------------------------------------------- round flow
    def _open_round(self) -> None:
        # Fused fast path: before handing the round to the policy, try to
        # run a stretch of provably quiescent rounds as one fused loop
        # (core.megastep). The loop re-checks after each run because the
        # completions it replays extend keep-warm windows, which can make
        # further rounds eligible. Any ineligibility falls through to the
        # event-driven engine — the bit-exact oracle — for this round.
        # Fresh-round open is the only point where traffic shifts
        # membership (the poll loop mirrors this at its loop top), so
        # mid-round adapter re-selects see a stable fleet on both engines.
        self._apply_due_traffic()
        if self.megastep == "fused":
            while try_megastep(self):
                if (self.db.round >= self.cfg.rounds
                        or self.loop.now >= self.cfg.max_sim_time):
                    self._done = True
                    return
                # the fused horizon may have crossed segment boundaries
                # (it stops short of the next unapplied one: megastep._plan)
                self._apply_due_traffic()
        self._t0 = self.loop.now
        self._invoked_this_round = False
        self._round_span = tracing.begin("round", round=self.db.round)
        self._dispatch(RoundStarted(t=self.loop.now, round=self.db.round))

    def _close_round(self) -> None:
        """Execute ``Aggregate``: aggregate, evaluate, log, advance the
        round, and either terminate or dispatch the next ``RoundStarted``
        (the poll loop's tail, round for round). The ``round`` span, open
        since ``RoundStarted``, ends here before the next round opens."""
        cfg = self.cfg
        round_ = self.db.round
        n_agg, n_stale, _ = self.aggregate_round(round_)
        if n_agg:
            if cfg.eval_every and round_ % cfg.eval_every == 0:
                self._acc = self.evaluate()
            log = RoundLog(round=round_, t_start=self._t0,
                           t_end=self.loop.now, accuracy=self._acc,
                           n_aggregated=n_agg, n_stale=n_stale,
                           mean_loss=0.0)
            self.history.append(log)
            if self._progress:
                self._progress(log)
        self.db.round = round_ + 1
        self._durability_round_closed()
        reached = False
        if n_agg:
            if cfg.checkpoint_every and self.db.round % cfg.checkpoint_every == 0:
                self.checkpoint()
            reached = bool(cfg.target_accuracy
                           and self._acc >= cfg.target_accuracy)
        tracing.end(self._round_span)
        if (reached or self.db.round >= cfg.rounds
                or self.loop.now >= cfg.max_sim_time):
            self._done = True
            return
        self._open_round()

    # ---------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        m = super().metrics()
        m["strategy"] = self.policy.name
        m["n_events"] = self.n_events
        m["n_coalesced"] = self.n_coalesced
        m["megastep"] = self.megastep
        m["megastep_rounds"] = self.megastep_rounds
        m["megastep_scans"] = self.megastep_scans
        m["megastep_fallback_reason"] = self.megastep_fallback_reason
        m.update(self.policy.metrics())
        return m


def build_engine(cfg: FLConfig, model, data, fleet, **kwargs):
    """Engine-aware factory: ``cfg.engine`` ('auto' = 'scheduler') picks
    the round driver. Reactive strategy names require the scheduler;
    everything else runs on either."""
    engine = resolve_engine(cfg.engine)
    if engine == "legacy":
        if is_reactive(cfg.strategy):
            raise ValueError(
                f"strategy {cfg.strategy!r} is a reactive policy; the "
                f"legacy poll loop cannot drive it — use engine='scheduler'")
        return Controller(cfg, model, data, fleet, **kwargs)
    return Scheduler(cfg, model, data, fleet, **kwargs)
