"""FaaS platform simulation: function instances, cold starts, scale-to-zero.

Models the serverless client lifecycle the paper measures (IV-A5):
  - a client function instance is *warm* if it served an invocation within
    ``keep_warm`` seconds (paper: instances scale down after 10 idle minutes);
  - a cold invocation pays ``cold_start_s`` (container pull + runtime boot +
    model/dataset load is accounted separately by the duration model);
  - the platform records every invocation for the cold-start-ratio metric.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.faas.hardware import HardwareProfile

# ``faults`` takes a fault model (``faas/faults.py`` of the reference); the
# port has none yet, so the runtime always passes None (fault injection off).


@dataclass
class InvocationRecord:
    client_id: int
    round: int
    t_invoked: float
    cold: bool
    duration: float = 0.0
    t_completed: float = 0.0
    failed: bool = False
    cancelled: bool = False    # killed mid-flight (hedge loser / explicit
    #                            cancel); duration is truncated at the kill
    failed_phase: str = ""     # fault attribution: startup | train | upload
    #                            | oom | outage | loss | timeout ("" = ok)
    lost: bool = False         # zombie: ran to completion, result never
    #                            landed (container survives — stays warm)
    timed_out: bool = False    # killed by the scheduler's per-invocation
    #                            timeout (recovery layer)


@dataclass
class _Instance:
    warm_until: float = -1.0
    busy_until: float = -1.0


class FaaSPlatform:
    def __init__(self, *, keep_warm: float = 600.0, cold_start_s: float = 8.0,
                 model_load_s: float = 2.0, upload_s: float = 1.0,
                 seed: int = 0, failure_rate: float = 0.0,
                 faults: Optional["FaultModel"] = None):
        self.keep_warm = keep_warm
        self.cold_start_s = cold_start_s
        self.model_load_s = model_load_s
        self.upload_s = upload_s
        self.failure_rate = failure_rate
        self.faults = faults
        self._instances: dict[int, _Instance] = {}
        self._rng = np.random.default_rng(seed)
        self.invocations: list[InvocationRecord] = []

    # ------------------------------------------------------------------ API
    def invoke(self, client_id: int, round_: int, now: float,
               train_steps: float, hw: HardwareProfile,
               base_step_time: float) -> InvocationRecord:
        """Returns the invocation record with ``duration`` filled in
        (invocation latency + load + train + upload)."""
        inst = self._instances.setdefault(client_id, _Instance())
        cold = now > inst.warm_until
        startup = self.cold_start_s * self._rng.uniform(0.8, 1.3) if cold else 0.15
        speed = hw.speed * float(np.exp(self._rng.normal(0.0, hw.variability)))
        train_time = train_steps * base_step_time / speed
        failed = bool(self._rng.random() < self.failure_rate)
        duration = startup + self.model_load_s + train_time + self.upload_s
        if failed:
            # fail partway through (crash / preemption)
            duration = startup + self.model_load_s + train_time * self._rng.uniform(0.1, 0.9)
        phase = "train" if failed else ""
        lost = False
        # fault injection rides on TOP of the legacy draws above (which are
        # consumed verbatim, keeping pre-existing traces bit-identical);
        # the FaultModel owns a separate RNG stream and draws a fixed
        # number of values per invocation — nothing when faults are off
        if self.faults is not None and self.faults.active and not failed:
            out = self.faults.evaluate(client_id, now, hw)
            if out.slowdown != 1.0:
                train_time *= out.slowdown
                duration = (startup + self.model_load_s + train_time
                            + self.upload_s)
            if out.failed_phase:
                failed = True
                phase = out.failed_phase
                if phase in ("startup", "outage"):
                    duration = startup * out.frac
                elif phase in ("train", "oom"):
                    duration = (startup + self.model_load_s
                                + train_time * out.frac)
                elif phase == "upload":
                    duration = (startup + self.model_load_s + train_time
                                + self.upload_s * out.frac)
                elif phase == "loss":
                    # zombie: full duration, the result just never lands
                    lost = True
            elif out.late_by:
                duration += out.late_by
        rec = InvocationRecord(client_id, round_, now, cold,
                               duration=duration, t_completed=now + duration,
                               failed=failed, failed_phase=phase, lost=lost)
        inst.busy_until = rec.t_completed
        if failed and not lost:
            # a crashed container is gone — the platform reclaims it, so
            # the next invocation pays a cold start (a keep-warm window
            # here undercounted cold starts); zombies survive their loss
            inst.warm_until = rec.t_completed
        else:
            inst.warm_until = rec.t_completed + self.keep_warm
        self.invocations.append(rec)
        return rec

    def cancel(self, rec: InvocationRecord, now: float,
               live_until: Optional[float] = None) -> None:
        """Kill an in-flight invocation at sim-time ``now``: the record is
        billed only for its elapsed fraction, and the instance's busy /
        keep-warm clocks stop at the cancellation — or at ``live_until``,
        the completion time of a sibling invocation (a hedge race winner)
        still running on the instance."""
        if rec.t_completed <= now:
            return  # already finished; nothing to roll back
        rec.duration = max(0.0, now - rec.t_invoked)
        rec.t_completed = now
        rec.cancelled = True
        inst = self._instances.get(rec.client_id)
        if inst is not None:
            horizon = max(now, live_until if live_until is not None else now)
            inst.busy_until = min(inst.busy_until, horizon)
            inst.warm_until = min(inst.warm_until, horizon + self.keep_warm)

    def scale_down(self, client_ids) -> None:
        """Reclaim the function instances of departed clients. Without
        this, a client that leaves and later re-joins under the same id
        would inherit the dead instance's keep-warm horizon and dodge its
        cold start — undercounting the cold-start-rate SLO (traffic
        plane, DESIGN.md §13)."""
        for cid in client_ids:
            self._instances.pop(int(cid), None)

    # ---------------------------------------------------------- durability
    def state_dict(self) -> dict:
        """JSON-serializable platform state for coordinated snapshots
        (repro_torch.durability): instance clocks in insertion order, the
        legacy-noise PCG64 position, the fault model's RNG, and the full
        invocation log (records round-trip through ``asdict``)."""
        from dataclasses import asdict
        s = {
            "instances": [[cid, inst.warm_until, inst.busy_until]
                          for cid, inst in self._instances.items()],
            "rng": self._rng.bit_generator.state,
            "invocations": [asdict(r) for r in self.invocations],
        }
        if self.faults is not None:
            s["faults_rng"] = self.faults._rng.bit_generator.state
        return s

    def load_state(self, s: dict) -> None:
        self._instances = {int(c): _Instance(w, b)
                           for c, w, b in s["instances"]}
        self._rng.bit_generator.state = s["rng"]
        self.invocations = [InvocationRecord(**r) for r in s["invocations"]]
        if self.faults is not None and "faults_rng" in s:
            self.faults._rng.bit_generator.state = s["faults_rng"]

    # -------------------------------------------------------------- metrics
    def cold_start_ratio(self) -> float:
        if not self.invocations:
            return 0.0
        return sum(r.cold for r in self.invocations) / len(self.invocations)

    def invocation_counts(self) -> dict[int, int]:
        counts: dict[int, int] = {}
        for r in self.invocations:
            counts[r.client_id] = counts.get(r.client_id, 0) + 1
        return counts
