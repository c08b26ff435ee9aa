"""Open-loop traffic plane (twin of ``repro.traffic``; DESIGN.md §13):
seeded arrival processes compiled into vectorized availability schedules
(``model``, ``schedule``), applied to the ``FleetStore`` in bulk windowed
segments, plus the SLO metrics layer (``slo``): p50/p99 round latency,
cold-start rate and cost per round. ``FLConfig.traffic_profile`` selects a
canned profile or a raw spec string; off (the default, also for "auto")
is bit-identical to every closed-loop trace.
"""
from repro_torch.traffic.model import (DiurnalTraffic, FlashCrowd,  # noqa: F401
                                       PoissonTraffic, TraceTraffic,
                                       TRAFFIC_PROFILES, TrafficSpec,
                                       parse_traffic, resolve_traffic_profile)
from repro_torch.traffic.schedule import (TrafficSchedule,  # noqa: F401
                                          TrafficSegment,
                                          build_traffic_schedule,
                                          compile_traffic_schedule)
from repro_torch.traffic.slo import round_latencies, slo_summary  # noqa: F401
