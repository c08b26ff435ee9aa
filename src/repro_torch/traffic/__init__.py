"""The SLO metrics layer of the open-loop traffic plane (twin of
``repro.traffic``; DESIGN.md §13): p50/p99 round latency, cold-start rate
and cost per round, pure functions over a run's round history that every
run's ``metrics()`` and the sweep's result tables report. The arrival
processes and their schedules (``model``, ``schedule``) come with a later
slice of the port; until then ``FLConfig.traffic_profile`` stays off.
"""
from repro_torch.traffic.slo import round_latencies, slo_summary  # noqa: F401
