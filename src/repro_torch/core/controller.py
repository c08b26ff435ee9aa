"""The poll-loop driver (FedLess controller, Algorithm 1), twin of
``repro.core.controller``; the entry point of this slice of the port.

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

Usage: ``Controller(cfg, model, data, fleet, device=None).run()``; the
device defaults to the CUDA card.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.services import FLConfig, FLRuntime, RoundLog  # noqa: F401


class Controller(FLRuntime):
    """Poll-based round driver: blocks in ``EventLoop.run_until`` on the
    strategy's gating predicate (see module docstring)."""

    engine_name = "controller"

    def run(self, progress: Optional[Callable[[RoundLog], None]] = None):
        cfg, strat = self.cfg, self.strategy
        round_ = self.db.round
        while round_ < cfg.rounds and self.loop.now < cfg.max_sim_time:
            t0 = self.loop.now
            selection = strat.select(self.db, round_)
            if not selection:
                # every client busy: advance until something completes
                if not self.loop.run_until(self.db.any_idle):
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
            if cfg.target_accuracy and self._acc >= cfg.target_accuracy:
                break
        return self.metrics()
