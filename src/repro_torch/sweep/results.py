"""Sweep result tables (the paper's Tables IV-VI shapes).

``ResultTable.from_runs`` pairs each grid cell with its metrics dict and
derives the paper's comparison columns within each ``RunSpec.group``
(dataset x scenario x seed):

  * ``target_acc`` — the time-to-accuracy target. The paper fixes absolute
    targets per dataset; proxy tasks plateau at strategy-dependent ceilings,
    so the table uses time-to-COMMON-accuracy: 95% of the weakest
    strategy's best accuracy in the group (every strategy reaches it).
  * ``speedup_vs_fedavg`` — Table IV's headline column (2.75x avg for
    Apodotiko): FedAvg's time-to-target / this strategy's.
  * ``cold_starts`` / ``cold_start_reduction_vs_fedavg`` — Table VI
    (the paper's 4x average reduction).
  * ``cost_usd`` / ``cost_vs_fedavg`` — Table V (FaaS $ cost model).

Rows keep grid order (deterministic regardless of execution concurrency);
failed cells keep their row with an ``error`` and null-valued metrics, so a
partial sweep still renders.
"""
from __future__ import annotations

import io
from typing import Optional, Sequence

from repro_torch.sweep.grid import RunSpec

SCHEMA = (
    "sweep", "dataset", "scenario", "strategy", "seed", "concurrency_ratio",
    "staleness_fn", "data_plane", "fault_profile", "traffic_profile",
    "rounds", "target_acc",
    "time_to_target_s", "speedup_vs_fedavg", "final_acc", "best_acc",
    "sim_time_s", "cold_starts", "cold_start_ratio",
    "cold_start_reduction_vs_fedavg", "cost_usd", "cost_vs_fedavg",
    "p50_round_latency_s", "p99_round_latency_s", "cost_per_round_usd",
    "n_invocations", "n_failures", "n_retries", "n_quarantined", "error",
)

BASELINE = "fedavg"


def _best_acc(metrics: dict) -> float:
    return max((a for _, _, a in metrics.get("history", ())), default=0.0)


def _time_to(metrics: dict, target: float) -> Optional[float]:
    for t, _, acc in metrics.get("history", ()):
        if acc >= target:
            return t
    return None


def _ratio(num, den) -> Optional[float]:
    if num is None or den is None or not den:
        return None
    return round(num / den, 3)


class ResultTable:
    """Ordered rows (dicts over SCHEMA) with render/export helpers."""

    columns = SCHEMA

    def __init__(self, rows: list[dict]):
        self.rows = rows

    # ------------------------------------------------------- construction
    @classmethod
    def from_runs(cls, sweep_name: str, runs: Sequence[RunSpec],
                  metrics_list: Sequence[Optional[dict]],
                  target_quantile: float = 0.95) -> "ResultTable":
        assert len(runs) == len(metrics_list)
        ok = {i: m for i, m in enumerate(metrics_list)
              if m is not None and "error" not in m}
        # per-group common-accuracy target and FedAvg baselines
        groups: dict[tuple, list[int]] = {}
        for i, run in enumerate(runs):
            groups.setdefault(run.group, []).append(i)
        target: dict[tuple, float] = {}
        base: dict[tuple, dict] = {}
        for g, idxs in groups.items():
            # runs that never completed an eval (empty history — e.g. the
            # first round blew the sim budget) carry no accuracy signal;
            # letting their best=0 into min() would drag the common target
            # to 0 and make every time_to_target a first-eval timestamp
            bests = [_best_acc(ok[i]) for i in idxs
                     if i in ok and ok[i].get("history")]
            target[g] = round(target_quantile * min(bests), 4) if bests else 0.0
            for i in idxs:
                if i in ok and runs[i].strategy == BASELINE:
                    base[g] = ok[i]

        rows = []
        for i, run in enumerate(runs):
            row = dict.fromkeys(SCHEMA)
            row.update(sweep=sweep_name, dataset=run.dataset,
                       scenario=run.scenario, strategy=run.strategy,
                       seed=run.seed, concurrency_ratio=run.concurrency_ratio,
                       staleness_fn=run.staleness_fn,
                       data_plane=run.data_plane,
                       fault_profile=run.fault_profile,
                       traffic_profile=run.traffic_profile)
            m = metrics_list[i]
            if m is None or "error" in m:
                row["error"] = (m or {}).get("error", "missing")
                rows.append(row)
                continue
            g = run.group
            tgt = target[g]
            t = _time_to(m, tgt)
            bm = base.get(g)
            bt = _time_to(bm, tgt) if bm else None
            n_inv = m.get("n_invocations", 0)
            cs_ratio = m.get("cold_start_ratio")
            cs = (None if cs_ratio is None
                  else int(round(cs_ratio * n_inv)))
            b_cs = (None if bm is None else
                    int(round(bm.get("cold_start_ratio", 0.0)
                              * bm.get("n_invocations", 0))))
            row.update(
                rounds=m.get("rounds"),
                target_acc=tgt,
                time_to_target_s=None if t is None else round(t, 1),
                speedup_vs_fedavg=_ratio(bt, t),
                final_acc=round(m.get("final_accuracy", 0.0), 4),
                best_acc=round(_best_acc(m), 4),
                sim_time_s=round(m.get("total_time", 0.0), 1),
                cold_starts=cs,
                cold_start_ratio=(None if cs_ratio is None
                                  else round(cs_ratio, 4)),
                cold_start_reduction_vs_fedavg=_ratio(b_cs, cs),
                cost_usd=round(m.get("total_cost_usd", 0.0), 4),
                cost_vs_fedavg=_ratio(m.get("total_cost_usd"),
                                      bm.get("total_cost_usd") if bm else None),
                n_invocations=n_inv,
                n_failures=m.get("n_failures"),
                n_retries=m.get("n_retries"),
                n_quarantined=m.get("n_quarantined"),
                # SLO layer (DESIGN.md §13): tail latency + unit economics
                p50_round_latency_s=(
                    None if m.get("p50_round_latency_s") is None
                    else round(m["p50_round_latency_s"], 1)),
                p99_round_latency_s=(
                    None if m.get("p99_round_latency_s") is None
                    else round(m["p99_round_latency_s"], 1)),
                cost_per_round_usd=(
                    None if m.get("cost_per_round_usd") is None
                    else round(m["cost_per_round_usd"], 5)))
            rows.append(row)
        return cls(rows)

    # ------------------------------------------------------------ queries
    def select(self, **match) -> "ResultTable":
        return ResultTable([r for r in self.rows
                            if all(r.get(k) == v for k, v in match.items())])

    def mean_speedup(self, strategy: str) -> Optional[float]:
        vals = [r["speedup_vs_fedavg"] for r in self.rows
                if r["strategy"] == strategy
                and r["speedup_vs_fedavg"] is not None]
        return round(sum(vals) / len(vals), 3) if vals else None

    # ----------------------------------------------------------- renderers
    def to_markdown(self, columns: Optional[Sequence[str]] = None) -> str:
        cols = list(columns or (c for c in SCHEMA if c != "error"))
        cells = [[_fmt(r.get(c)) for c in cols] for r in self.rows]
        widths = [max(len(c), *(len(row[j]) for row in cells)) if cells
                  else len(c) for j, c in enumerate(cols)]
        out = io.StringIO()
        out.write("| " + " | ".join(c.ljust(w) for c, w in zip(cols, widths))
                  + " |\n")
        out.write("|" + "|".join("-" * (w + 2) for w in widths) + "|\n")
        for row in cells:
            out.write("| " + " | ".join(v.ljust(w)
                                        for v, w in zip(row, widths)) + " |\n")
        return out.getvalue()

    def to_csv(self, columns: Optional[Sequence[str]] = None) -> str:
        cols = list(columns or SCHEMA)
        lines = [",".join(cols)]
        for r in self.rows:
            lines.append(",".join(_fmt(r.get(c)) for c in cols))
        return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)
