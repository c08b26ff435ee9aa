"""Open-loop traffic model: arrival-process specs and profiles (twin of
``repro.traffic.model``).

Closed-loop scenarios pull rounds from a fixed fleet; the serverless
setting the paper targets is open-loop — clients arrive, disappear, and
surge on their own clock. This module defines the *declarative* side of
the traffic plane (DESIGN.md §13): compact spec strings describing
arrival sources, mirrored on `faas/faults.py`:

    FLConfig(traffic_profile="init:0.5,poisson:0.02:600")
    FLConfig(traffic_profile="diurnal")        # a canned profile name

Spec grammar (comma-separated clauses, colon-separated fields):

    init:<frac>                 fraction of the id universe present at t=0
                                (ids 0..k-1; default 1.0)
    window:<s>                  schedule quantum: every join/leave lands on
                                a multiple of this (default 30 s)
    horizon:<s>                 compiled schedule length (default 20000 s,
                                capped at the run's sim budget)
    poisson:<rate>[:<dwell>]    Poisson arrivals at `rate` clients/s; each
                                stays Exp(dwell) seconds (0 = forever)
    diurnal:<rate>:<depth>:<period>[:<dwell>]
                                sinusoid-modulated Poisson: instantaneous
                                rate = rate*(1 + depth*sin(2*pi*t/period)),
                                realized by thinning at rate*(1+depth)
    flash:<t>:<n>[:<dwell>]     flash crowd: n simultaneous arrivals at t
    trace:<t>=<+n|-n>[;...]     replayed membership deltas (`;`-separated
                                since `,` splits clauses); +n joins n
                                clients, -n removes the n earliest-joined

""/"auto"/"none"/"off" mean no traffic (unlike the reference, no
environment variable is read), and the off path constructs nothing and
draws no RNG, so every pre-existing trace is bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["PoissonTraffic", "DiurnalTraffic", "FlashCrowd", "TraceTraffic",
           "TrafficSpec", "parse_traffic", "resolve_traffic_profile",
           "TRAFFIC_PROFILES"]


@dataclass(frozen=True)
class PoissonTraffic:
    """Homogeneous Poisson arrivals; dwell 0 means clients never leave."""
    rate: float                 # arrivals per second
    dwell: float = 0.0          # mean Exp dwell time, seconds


@dataclass(frozen=True)
class DiurnalTraffic:
    """Sinusoid-modulated Poisson arrivals (diurnal load)."""
    rate: float                 # mean arrivals per second
    depth: float                # modulation depth in [0, 1]
    period: float               # seconds per cycle
    dwell: float = 0.0


@dataclass(frozen=True)
class FlashCrowd:
    """`n` simultaneous arrivals at time `t` (a surge)."""
    t: float
    n: int
    dwell: float = 0.0


@dataclass(frozen=True)
class TraceTraffic:
    """Replayed membership deltas: (time, +joins / -leaves) pairs."""
    events: Tuple[Tuple[float, int], ...]


@dataclass(frozen=True)
class TrafficSpec:
    """A parsed traffic spec string (declarative; compile with
    `repro_torch.traffic.schedule.compile_traffic_schedule`)."""
    sources: Tuple = field(default_factory=tuple)
    init_frac: float = 1.0
    window: float = 30.0
    horizon: float = 20_000.0

    @property
    def active(self) -> bool:
        # "init:1.0" alone is the closed-loop default: not traffic
        return bool(self.sources) or self.init_frac != 1.0

    @property
    def stochastic(self) -> bool:
        """True when compiling consumes RNG (Poisson/diurnal sources) —
        the megastep refuses fusion under these by name."""
        return any(isinstance(s, (PoissonTraffic, DiurnalTraffic))
                   for s in self.sources)


def _floats(fields: list, n_req: int, n_opt: int, clause: str) -> list:
    if not (1 + n_req <= len(fields) <= 1 + n_req + n_opt):
        raise ValueError(f"traffic clause {clause!r}: expected "
                         f"{n_req}-{n_req + n_opt} fields")
    try:
        return [float(f) for f in fields[1:]]
    except ValueError:
        raise ValueError(f"traffic clause {clause!r}: non-numeric field") \
            from None


def parse_traffic(spec: str) -> TrafficSpec:
    """Parse a compact traffic spec string (see module docstring)."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("none", "off"):
        return TrafficSpec()
    sources: list = []
    init_frac, window, horizon = 1.0, 30.0, 20_000.0
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        fields = clause.split(":")
        kind = fields[0].lower()
        if kind == "init":
            (init_frac,) = _floats(fields, 1, 0, clause)
            if not 0.0 <= init_frac <= 1.0:
                raise ValueError(f"traffic init fraction {init_frac} "
                                 f"outside [0, 1]")
        elif kind == "window":
            (window,) = _floats(fields, 1, 0, clause)
            if window <= 0:
                raise ValueError("traffic window must be > 0")
        elif kind == "horizon":
            (horizon,) = _floats(fields, 1, 0, clause)
            if horizon <= 0:
                raise ValueError("traffic horizon must be > 0")
        elif kind == "poisson":
            vals = _floats(fields, 1, 1, clause)
            rate, dwell = vals[0], (vals[1] if len(vals) > 1 else 0.0)
            if rate < 0 or dwell < 0:
                raise ValueError(f"traffic clause {clause!r}: negative field")
            sources.append(PoissonTraffic(rate=rate, dwell=dwell))
        elif kind == "diurnal":
            vals = _floats(fields, 3, 1, clause)
            rate, depth, period = vals[0], vals[1], vals[2]
            dwell = vals[3] if len(vals) > 3 else 0.0
            if rate < 0 or dwell < 0 or period <= 0 or not 0 <= depth <= 1:
                raise ValueError(f"traffic clause {clause!r}: bad field "
                                 f"(need rate,dwell>=0, period>0, "
                                 f"depth in [0,1])")
            sources.append(DiurnalTraffic(rate=rate, depth=depth,
                                          period=period, dwell=dwell))
        elif kind == "flash":
            vals = _floats(fields, 2, 1, clause)
            t, n = vals[0], int(vals[1])
            dwell = vals[2] if len(vals) > 2 else 0.0
            if t < 0 or n < 0 or dwell < 0:
                raise ValueError(f"traffic clause {clause!r}: negative field")
            sources.append(FlashCrowd(t=t, n=n, dwell=dwell))
        elif kind == "trace":
            body = clause.split(":", 1)[1] if ":" in clause else ""
            events = []
            for ev in body.split(";"):
                ev = ev.strip()
                if not ev:
                    continue
                try:
                    t_s, delta_s = ev.split("=")
                    t, delta = float(t_s), int(delta_s)
                except ValueError:
                    raise ValueError(f"traffic trace event {ev!r}: expected "
                                     f"<t>=<+n|-n>") from None
                if t < 0:
                    raise ValueError(f"traffic trace event {ev!r}: t < 0")
                events.append((t, delta))
            if not events:
                raise ValueError(f"traffic clause {clause!r}: empty trace")
            sources.append(TraceTraffic(events=tuple(events)))
        else:
            raise ValueError(f"unknown traffic clause {clause!r} (want "
                             f"init/window/horizon/poisson/diurnal/flash/"
                             f"trace)")
    return TrafficSpec(sources=tuple(sources), init_frac=init_frac,
                       window=window, horizon=horizon)


# Canned profiles, sized so they bite at sweep scale (M~8-256, sim
# budgets of hundreds of seconds) and stress the bulk path at bench
# scale. Raw spec strings work anywhere a profile name does.
TRAFFIC_PROFILES = {
    # half the fleet at t=0, slow Poisson trickle with ~10-minute dwells
    "steady-churn": "init:0.5,window:30,poisson:0.02:600",
    # sinusoidal day/night load over a 10-minute "day"
    "diurnal": "init:0.5,window:30,diurnal:0.05:0.9:600:300",
    # a quarter-fleet baseline hit by a 1000-client surge at t=60
    # (arrivals beyond capacity are dropped and counted)
    "flash-crowd": "init:0.25,window:30,flash:60:1000:300",
    # deterministic replayed deltas (megastep-fusable)
    "trace-demo": "init:0.5,window:30,trace:90=+2;210=-2;300=+3",
}


def resolve_traffic_profile(mode) -> str:
    """The profile string ("" = traffic off, also for "auto", "none" and
    "off"; no environment variable is read); raises on an unparseable
    spec."""
    if mode in (None, "", "auto"):
        return ""
    if not isinstance(mode, str):
        raise ValueError(f"traffic profile must be a string, got {mode!r}")
    if mode.lower() in ("none", "off"):
        return ""
    if mode:
        parse_traffic(TRAFFIC_PROFILES.get(mode, mode))    # validate early
    return mode
