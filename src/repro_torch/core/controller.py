"""The poll-loop driver (FedLess controller, Algorithm 1), twin of
``repro.core.controller``. The default engine is the event-driven
``Scheduler`` (``core/scheduler.py``, ``build_engine``); this loop is kept
as its equivalence oracle (``FLConfig(engine="legacy")``).

Train_Global_Model loop:
  1. ``Select_Clients`` via the active strategy (Algorithm 3 for Apodotiko).
  2. Invoke the selected client functions on the (simulated) FaaS platform;
     the cohort trains on the card and its models land as update-store rows.
  3. Poll the database until the strategy's gating condition holds — all
     current-round results or timeout (sync), or ``ceil(CR x
     clientsPerRound)`` un-aggregated results from the current or up to
     five previous rounds (async, Algorithm 1 line 9).
  4. Aggregate with cardinality x staleness weights (Eq. 2), evaluate, and
     start the next round immediately.

The loop is passive: failed invocations (the Bernoulli ``failure_rate``
coin or any seeded ``fault_profile`` schedule, ``faas/faults.py``) simply
never produce results, and the recovery layer (timeouts, retries,
quarantine) is Scheduler-only, so recovery knobs stay off for
cross-engine runs. Open-loop traffic is applied once a round, at its
first poll, as the Scheduler applies it at round open. The controller
checkpoints {global model, client records, scores, boosters, round, live
update rows} every ``checkpoint_every`` rounds and resumes from the
database (``Controller.resume``); with ``durability="journal"`` its events
are journaled through ``_emit``, with a ``round_open`` marker at each
fresh round, a round-close marker (and on cadence a snapshot) at each
close, and ``run_end`` when the loop ends.

Usage: ``Controller(cfg, model, data, fleet, device=None).run()``; the
device defaults to the CUDA card.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch import tracing
from repro_torch.core.services import FLConfig, FLRuntime, RoundLog  # noqa: F401


class Controller(FLRuntime):
    """Poll-based round driver: blocks in ``EventLoop.run_until`` on the
    strategy's gating predicate (see module docstring)."""

    engine_name = "controller"

    def run(self, progress: Optional[Callable[[RoundLog], None]] = None):
        cfg, strat = self.cfg, self.strategy
        round_ = self.db.round
        traffic_round = -1
        while round_ < cfg.rounds and self.loop.now < cfg.max_sim_time:
            t0 = self.loop.now
            self._t0 = t0
            if round_ != traffic_round:
                # fresh-round open only: mid-round re-polls must not shift
                # membership, mirroring the Scheduler (which applies
                # traffic in _open_round, never on adapter re-selects)
                self._apply_due_traffic()
                traffic_round = round_
                if self.durability is not None:
                    # the poll loop has no RoundStarted event; the marker
                    # gives its journal the same open boundary
                    self.durability.record_marker("round_open", round_)
            with tracing.span("selection"):
                selection = strat.select(self.db, round_)
            if not selection:
                # every client busy: advance until something completes, or,
                # when the fleet is empty under open-loop traffic, jump to
                # the next arrival boundary
                if not self.loop.run_until(self.db.any_idle):
                    if not self._traffic_fast_forward():
                        break
                continue
            self.invoke_round(round_, selection)

            if strat.is_async:
                need = strat.results_needed()
                ok = self.loop.run_until(
                    lambda: len(self.db.pending_results(cfg.max_staleness, round_))
                    >= need, max_time=cfg.max_sim_time)
                if not ok and not self.db.pending_results(cfg.max_staleness, round_):
                    break
            else:
                deadline = t0 + cfg.round_timeout
                self.loop.run_until(
                    lambda: self._completed_this_round >= set(selection),
                    max_time=deadline)
                # guarantee progress: at least one usable result
                self.loop.run_until(
                    lambda: any(strat.usable(r, round_) for r in
                                self.db.pending_results(cfg.max_staleness, round_)),
                    max_time=cfg.max_sim_time)

            n_agg, n_stale, _ = self.aggregate_round(round_)
            if n_agg == 0:
                round_ += 1
                self.db.round = round_
                self._durability_round_closed()
                continue
            if cfg.eval_every and round_ % cfg.eval_every == 0:
                self._acc = self.evaluate()
            log = RoundLog(round=round_, t_start=t0, t_end=self.loop.now,
                           accuracy=self._acc, n_aggregated=n_agg,
                           n_stale=n_stale, mean_loss=0.0)
            self.history.append(log)
            if progress:
                progress(log)
            round_ += 1
            self.db.round = round_
            self._durability_round_closed()
            if cfg.checkpoint_every and round_ % cfg.checkpoint_every == 0:
                self.checkpoint()
            if cfg.target_accuracy and self._acc >= cfg.target_accuracy:
                break
        if self.durability is not None:
            self.durability.finish()
        return self.metrics()
