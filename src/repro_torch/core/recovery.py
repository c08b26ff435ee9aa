"""Retry/backoff + circuit-breaker recovery layer (DESIGN.md §12).

``RecoveryPolicy`` wraps any ``ReactivePolicy`` and intercepts failure
events before the inner policy sees them:

* ``InvocationTimedOut`` (emitted by ``FLRuntime.timeout_invocation``
  when an invocation outlives ``FLConfig.invocation_timeout``) is
  translated into a plain ``InvocationFailed`` for the inner policy —
  strategies never need to learn the new event type.
* Repeat offenders trip the circuit breaker: once a client's
  consecutive-failure streak (``FleetStore.consec_failures``, healed by
  any landed result) reaches ``quarantine_threshold``, a ``Quarantine``
  action removes it from the selection mask for ``quarantine_rounds``
  rounds via the ``quarantined_until`` column.
* Otherwise, while the per-round ``retry_budget`` lasts, the failure is
  answered with a ``Retry`` action: exponential backoff
  (``retry_base_delay * retry_backoff**(attempt-1)``) with multiplicative
  jitter drawn from the policy's own seeded RNG — deterministic and
  replayable, and isolated from every other RNG stream in the run.

The wrapper is only installed when ``recovery_enabled(cfg)`` — with all
three knobs at their zero defaults the scheduler runs the inner policy
directly and stays bit-identical to the legacy engine.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.protocol import (Action, DatabaseView, Event,
                                 InvocationFailed, InvocationTimedOut,
                                 Quarantine, ReactivePolicy, Retry,
                                 RoundStarted)

# RNG-stream offset so recovery jitter never collides with the selection
# RNG (cfg.seed) or the platform RNG (also cfg.seed, separate Generator)
_JITTER_SALT = 0x5EC0


def recovery_enabled(cfg) -> bool:
    """True when any recovery knob is on (FLConfig or StrategyConfig-like
    object with the three fields)."""
    return bool(getattr(cfg, "invocation_timeout", 0.0) > 0
                or getattr(cfg, "retry_budget", 0) > 0
                or getattr(cfg, "quarantine_threshold", 0) > 0)


class RecoveryPolicy(ReactivePolicy):
    """Failure-handling decorator around an inner reactive policy."""

    def __init__(self, inner: ReactivePolicy, cfg):
        self.inner = inner
        self.cfg = cfg
        self.strategy = getattr(inner, "strategy", None)
        self.name = getattr(inner, "name", "recovery")
        self._rng = np.random.default_rng(cfg.seed + _JITTER_SALT)
        self._attempts: dict[int, int] = {}   # client -> retries this round
        self._budget = cfg.retry_budget

    @property
    def fire_timers_on_drain(self) -> bool:
        return self.inner.fire_timers_on_drain

    # -- durability (coordinated snapshots, DESIGN.md §14) -------------
    def state_dict(self) -> dict:
        return {"rng": self._rng.bit_generator.state,
                "attempts": [[cid, n] for cid, n in self._attempts.items()],
                "budget": self._budget,
                "inner": self.inner.state_dict()}

    def load_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]
        self._attempts = {int(c): int(n) for c, n in state["attempts"]}
        self._budget = int(state["budget"])
        self.inner.load_state(state["inner"])

    def on_event(self, ev: Event, view: DatabaseView) -> Sequence[Action]:
        if isinstance(ev, RoundStarted):
            self._attempts.clear()
            self._budget = self.cfg.retry_budget
            return self.inner.on_event(ev, view)
        if isinstance(ev, (InvocationFailed, InvocationTimedOut)):
            pre = self._recover(ev, view)
            if isinstance(ev, InvocationTimedOut):
                ev = InvocationFailed(t=ev.t, round=ev.round,
                                      client_id=ev.client_id)
            return list(pre) + list(self.inner.on_event(ev, view))
        return self.inner.on_event(ev, view)

    def _recover(self, ev, view: DatabaseView) -> list[Action]:
        cfg, cid = self.cfg, ev.client_id
        if (cfg.quarantine_threshold
                and view.db.consecutive_failures(cid)
                >= cfg.quarantine_threshold):
            if view.db.is_quarantined(cid):
                return []           # breaker already open
            return [Quarantine(client_id=cid,
                               until_round=view.round + cfg.quarantine_rounds)]
        if cfg.retry_budget > 0 and self._budget > 0 and ev.round == view.round:
            attempt = self._attempts.get(cid, 0) + 1
            self._attempts[cid] = attempt
            self._budget -= 1
            delay = (cfg.retry_base_delay
                     * cfg.retry_backoff ** (attempt - 1)
                     * (1.0 + cfg.retry_jitter * float(self._rng.random())))
            return [Retry(client_id=cid, delay=delay)]
        return []

    def metrics(self) -> dict:
        m = getattr(self.inner, "metrics", None)
        return m() if m is not None else {}
