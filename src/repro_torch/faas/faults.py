"""Typed fault injection for the FaaS platform (twin of
``repro.faas.faults``; DESIGN.md §12).

The paper targets real serverless platforms where invocations crash, get
preempted, OOM, return late, or disappear into provider outages — failure
modes a single Bernoulli ``failure_rate`` cannot express (and whose
failures the legacy path silently absorbed). This module is the
composable replacement:

* :class:`FaultSchedule` — a declarative, *seeded* description of what
  goes wrong: phase-attributed crashes (startup / train / upload),
  transient slowdowns, result loss with zombie or late landings,
  per-hardware-tier OOM, and correlated outage windows that take whole
  client groups down. Schedules are plain frozen data, so chaos runs are
  replayable bit-for-bit and comparable across engines.
* :class:`FaultModel` — the runtime evaluator the platform consults once
  per invocation. It owns its **own** RNG stream (never the platform's
  duration/failure stream) and draws a *fixed* number of values per
  invocation regardless of what triggers, so enabling a schedule never
  perturbs the legacy draw order and an empty schedule draws nothing —
  the bit-identity anchor for the pre-existing golden traces.

Phase attribution (``InvocationRecord.failed_phase``):

    ``startup``  crash during container boot (duration = partial startup)
    ``train``    crash mid-training (the legacy Bernoulli failure's phase)
    ``upload``   crash while uploading the update
    ``oom``      memory kill during training on a low-memory tier
    ``outage``   correlated platform outage at invocation time
    ``loss``     zombie: the invocation runs to completion but the result
                 never lands (the container stays warm — it did not crash)
    ``timeout``  killed by the scheduler's per-invocation timeout
                 (stamped by ``FLRuntime.timeout_invocation``, not here)

Compact spec strings (comma-separated, parsed by :func:`parse_faults`)::

    crash:<phase>:<rate>               crash:train:0.2
    slow:<factor>:<rate>               slow:2.5:0.2
    loss:<rate>[:<late_rate>[:<late_s>]]   loss:0.15:0.2:45
    oom:<mem_gib>:<rate>               oom:2.0:0.3   (tiers with mem <= 2)
    outage:<start>-<end>[:mod<m>=<r>]  outage:150-400:mod3=0

``resolve_fault_profile`` accepts either a named profile from
:data:`FAULT_PROFILES` or a raw spec string; unlike the reference, an
``"auto"`` profile resolves to off without reading any environment
variable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from repro_torch.faas.hardware import HardwareProfile

#: crash phases a fault spec may name (observability adds oom/outage/loss)
PHASES = ("startup", "train", "upload")


@dataclass(frozen=True)
class FaultOutcome:
    """What the fault model decided for one invocation."""

    failed_phase: str = ""   # "" = no crash ("loss" = zombie, see module doc)
    slowdown: float = 1.0    # multiplier on train time (transient stragglers)
    lost: bool = False       # ran to completion, result never lands
    late_by: float = 0.0     # extra seconds before the result lands
    frac: float = 1.0        # fraction of the failed phase elapsed at crash


@dataclass(frozen=True)
class CrashFault:
    """Bernoulli crash attributed to one lifecycle phase."""

    phase: str               # "startup" | "train" | "upload"
    rate: float

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown crash phase {self.phase!r}")


@dataclass(frozen=True)
class SlowdownFault:
    """Transient slowdown: train time multiplied by ``factor``."""

    rate: float
    factor: float = 2.0


@dataclass(frozen=True)
class ResultLossFault:
    """Result loss: the invocation runs its full duration but the update
    never lands (a zombie — the container survives). With probability
    ``late_rate`` the result instead lands ``late_s`` seconds late."""

    rate: float
    late_rate: float = 0.0
    late_s: float = 60.0


@dataclass(frozen=True)
class OOMFault:
    """Memory kill during training, hitting only hardware tiers with
    ``mem_gib <= mem_below_gib`` (keyed on :class:`HardwareProfile`)."""

    rate: float
    mem_below_gib: float = 2.0


@dataclass(frozen=True)
class OutageWindow:
    """Correlated outage: every invocation *launched* inside
    ``[start, end)`` by an affected client fails at startup. Affected
    clients are ``client_id % group_mod == group_rem`` (the default
    ``mod 1 == 0`` takes the whole fleet down), or the explicit
    ``clients`` tuple when non-empty. Purely deterministic: no RNG."""

    start: float
    end: float
    group_mod: int = 1
    group_rem: int = 0
    clients: Tuple[int, ...] = ()

    def hits(self, client_id: int, t: float) -> bool:
        if not (self.start <= t < self.end):
            return False
        if self.clients:
            return client_id in self.clients
        return client_id % self.group_mod == self.group_rem


@dataclass(frozen=True)
class FaultSchedule:
    """Seeded, declarative fault plan — the replayability unit."""

    seed: int = 0
    faults: Tuple = ()

    @property
    def active(self) -> bool:
        return bool(self.faults)

    @property
    def stochastic(self) -> Tuple:
        """The RNG-consuming specs, in declaration order (the fixed
        per-invocation draw order of :class:`FaultModel`)."""
        return tuple(f for f in self.faults
                     if not isinstance(f, OutageWindow))

    @property
    def outages(self) -> Tuple[OutageWindow, ...]:
        return tuple(f for f in self.faults if isinstance(f, OutageWindow))


def parse_faults(spec: str) -> Tuple:
    """Parse a compact comma-separated fault spec string (module doc)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        kind = fields[0]
        if kind == "crash":
            out.append(CrashFault(phase=fields[1], rate=float(fields[2])))
        elif kind == "slow":
            out.append(SlowdownFault(factor=float(fields[1]),
                                     rate=float(fields[2])))
        elif kind == "loss":
            out.append(ResultLossFault(
                rate=float(fields[1]),
                late_rate=float(fields[2]) if len(fields) > 2 else 0.0,
                late_s=float(fields[3]) if len(fields) > 3 else 60.0))
        elif kind == "oom":
            out.append(OOMFault(mem_below_gib=float(fields[1]),
                                rate=float(fields[2])))
        elif kind == "outage":
            lo, hi = fields[1].split("-")
            mod, rem = 1, 0
            clients: Tuple[int, ...] = ()
            if len(fields) > 2:
                g = fields[2]
                if g.startswith("mod"):
                    m, r = g[3:].split("=")
                    mod, rem = int(m), int(r)
                else:
                    clients = tuple(int(c) for c in g.split("+"))
            out.append(OutageWindow(start=float(lo), end=float(hi),
                                    group_mod=mod, group_rem=rem,
                                    clients=clients))
        else:
            raise ValueError(f"unknown fault spec {part!r}")
    return tuple(out)


#: named chaos profiles (the sweep's ``fault_profile`` axis values)
FAULT_PROFILES: dict[str, str] = {
    # crashes dominate, spread across all three phases
    "crash-heavy": "crash:train:0.25,crash:startup:0.05,crash:upload:0.05",
    # two correlated outages, each taking a third of the fleet down
    "outage-window": "outage:150-400:mod3=0,outage:700-1000:mod3=1",
    # results vanish or land late; transient stragglers
    "lossy-network": "loss:0.15:0.2:45,slow:2.5:0.2",
}


def resolve_fault_profile(mode: str) -> str:
    """The normalized profile string: "" means no fault injection (the
    default, and what "auto", "none" and "off" resolve to: the platform
    draws nothing extra and every pre-existing trace is bit-identical);
    otherwise a :data:`FAULT_PROFILES` name or a raw :func:`parse_faults`
    spec string."""
    if mode in (None, "", "auto", "none", "off"):
        mode = ""
    if mode and mode not in FAULT_PROFILES:
        parse_faults(mode)      # raise early on a malformed spec
    return mode


def build_fault_schedule(profile: str, seed: int = 0
                         ) -> Optional[FaultSchedule]:
    """Profile name (or raw spec) -> schedule; None when faults are off."""
    if not profile:
        return None
    spec = FAULT_PROFILES.get(profile, profile)
    return FaultSchedule(seed=seed, faults=parse_faults(spec))


def build_fault_model(profile: str, seed: int = 0) -> Optional["FaultModel"]:
    sched = build_fault_schedule(profile, seed)
    return FaultModel(sched) if sched is not None else None


class FaultModel:
    """Runtime fault evaluator (one call per invocation).

    Determinism contract: per ``evaluate`` call the model draws exactly
    ``len(schedule.stochastic) + 1`` values from its private RNG — one
    Bernoulli per stochastic spec in declaration order plus one crash
    fraction — whether or not anything triggers. Outage windows are pure
    predicates (no draws). Identical schedules therefore produce identical
    outcome sequences on every engine/plane, which is what the chaos
    harness's cross-engine bit-identity rests on."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._rng = np.random.default_rng(schedule.seed)
        self._stoch = schedule.stochastic
        self._outages = schedule.outages

    @property
    def active(self) -> bool:
        return self.schedule.active

    @property
    def stochastic(self) -> Tuple:
        return self._stoch

    def outage_windows(self) -> Tuple[OutageWindow, ...]:
        return self._outages

    def evaluate(self, client_id: int, now: float,
                 hw: HardwareProfile) -> FaultOutcome:
        # fixed unconditional draw block (see class docstring)
        draws = [float(self._rng.random()) for _ in self._stoch]
        frac = float(self._rng.uniform(0.1, 0.9))

        # deterministic correlated outages take precedence over everything
        for w in self._outages:
            if w.hits(client_id, now):
                return FaultOutcome(failed_phase="outage", frac=frac)

        crash: str = ""
        slowdown = 1.0
        lost = False
        late_by = 0.0
        for spec, u in zip(self._stoch, draws):
            triggered = u < spec.rate
            if not triggered:
                continue
            if isinstance(spec, OOMFault):
                if hw.mem_gib <= spec.mem_below_gib:
                    crash = _worse(crash, "oom")
            elif isinstance(spec, CrashFault):
                crash = _worse(crash, spec.phase)
            elif isinstance(spec, ResultLossFault):
                if u < spec.rate * spec.late_rate:
                    late_by = max(late_by, spec.late_s)
                else:
                    lost = True
            elif isinstance(spec, SlowdownFault):
                slowdown = max(slowdown, spec.factor)
        if crash:
            return FaultOutcome(failed_phase=crash, slowdown=slowdown,
                                frac=frac)
        if lost:
            return FaultOutcome(failed_phase="loss", slowdown=slowdown,
                                lost=True, frac=frac)
        return FaultOutcome(slowdown=slowdown, late_by=late_by, frac=frac)


#: crash precedence, earliest-killing first (an OOM or startup crash
#: preempts anything later in the lifecycle)
_SEVERITY = {"oom": 0, "startup": 1, "train": 2, "upload": 3}


def _worse(a: str, b: str) -> str:
    if not a:
        return b
    return a if _SEVERITY[a] <= _SEVERITY[b] else b
