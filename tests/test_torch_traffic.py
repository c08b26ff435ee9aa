"""The port's open-loop traffic plane (``repro_torch.traffic``) against the
reference's (``repro.traffic``), and within the port.

Against the reference: the spec grammar (what parses and what raises), the
canned profiles, and every compiled schedule (initial membership, segment
times, join and leave ids, dropped arrivals) for each profile, seed and
capacity; and full ``Scheduler`` runs under each canned profile and two
early-boundary specs, with the host trace, the traffic counters and the
accuracies equal from the reference's params with its draws replayed
(``JaxBatchIndices``), params within rtol 1e-4 / atol 1e-5.

Within the port: bulk application through the ``Database`` equals the
per-event oracle; the ``Controller`` and the ``Scheduler`` are
bit-identical under every profile shape (the twin of
``tests/test_traffic.py``'s cross-engine suite); and ``trace-demo``, the
deterministic profile, runs fused rounds up to each segment boundary,
bit-identical to ``megastep="stepwise"``."""
import numpy as np
import pytest

import repro.traffic as jtraffic
from repro_torch.core.database import ClientRecord, Database
from repro_torch.core.fleet_store import FleetStore
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.services import FLConfig
from repro_torch.models.proxy_models import ProxyCNN
from repro_torch import traffic
from test_torch_client_store import one_torch_thread  # noqa: F401
from test_torch_faults import (_fused_and_stepwise, datasets,  # noqa: F401
                               det_fleet, jmodel, megastep_cfg,
                               run_against_reference, run_engine_pair)
from trace_harness import N_CLIENTS, base_cfg_kw

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_traffic.py's specs: its property specs (one overflows M = 64)
# and its early-boundary variants of the canned profiles, sized so joins
# and leaves fire inside a 3-round run at this size
PROPERTY_SPECS = [
    "init:0.5,window:10,horizon:400,poisson:0.2:60",
    "init:0.25,window:15,horizon:600,diurnal:0.3:0.9:200:50",
    "init:0.5,window:10,horizon:300,flash:45:30:80,poisson:0.1",
    "init:0.0,window:5,horizon:200,poisson:0.5:40",
    "init:0.75,window:10,horizon:300,trace:20=+5;60=-3;90=+2",
    "init:0.5,window:10,horizon:300,flash:50:200:60",
]
ENGINE_SPECS = [
    "init:0.5,window:10,poisson:0.15:80",
    "init:0.5,window:10,diurnal:0.2:0.9:120:60",
    "init:0.25,window:10,flash:20:4:40",
    "init:0.5,window:5,trace:8=+2;25=-1;40=+1",
    "init:0.0,window:10,poisson:0.2:80",
]
BAD_SPECS = [
    "bogus:1", "init:1.5", "init:-0.1", "window:0", "horizon:-5",
    "poisson", "poisson:abc", "poisson:-1", "diurnal:1:2:600",
    "diurnal:1:0.5:0", "flash:10", "flash:-1:5", "trace:", "trace:10",
    "trace:x=+1", "trace:-5=+1",
]


def _plain(spec):
    return (tuple((type(s).__name__, vars(s)) for s in spec.sources),
            spec.init_frac, spec.window, spec.horizon, spec.active,
            spec.stochastic)


# ---------------------------------------------------------------- grammar
@pytest.mark.parametrize("spec", list(traffic.TRAFFIC_PROFILES.values())
                         + PROPERTY_SPECS + ENGINE_SPECS + ["", "off",
                                                            "init:1.0"])
def test_parse_equals_the_references(spec):
    assert _plain(traffic.parse_traffic(spec)) == \
        _plain(jtraffic.parse_traffic(spec))


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_bad_specs_raise_in_both(bad):
    with pytest.raises(ValueError):
        traffic.parse_traffic(bad)
    with pytest.raises(ValueError):
        jtraffic.parse_traffic(bad)


def test_profiles_and_resolve_read_no_environment(monkeypatch):
    monkeypatch.setenv("REPRO_TRAFFIC", "diurnal")
    assert traffic.TRAFFIC_PROFILES == jtraffic.TRAFFIC_PROFILES
    for off in ("auto", "", None, "none", "off", "OFF"):
        assert traffic.resolve_traffic_profile(off) == ""
    assert traffic.resolve_traffic_profile("steady-churn") == "steady-churn"
    assert traffic.resolve_traffic_profile("init:0.5") == "init:0.5"
    with pytest.raises(ValueError):
        traffic.resolve_traffic_profile("bogus:1")
    with pytest.raises(ValueError):
        traffic.resolve_traffic_profile(7)
    assert traffic.build_traffic_schedule("", 100, seed=0) is None
    assert traffic.build_traffic_schedule("init:1.0", 100, seed=0) is None


# ----------------------------------------------------------------- schedule
def assert_schedules_equal(a, b):
    assert np.array_equal(a.initial, b.initial)
    assert (a.n_dropped, a.capacity, a.horizon, a.seed, a.stochastic) == \
        (b.n_dropped, b.capacity, b.horizon, b.seed, b.stochastic)
    assert len(a.segments) == len(b.segments)
    for sa, sb in zip(a.segments, b.segments):
        assert (sa.start, sa.end) == (sb.start, sb.end)
        assert np.array_equal(sa.joins, sb.joins)
        assert np.array_equal(sa.leaves, sb.leaves)
        assert sa.joins.dtype == sb.joins.dtype == np.int64


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("spec", sorted(traffic.TRAFFIC_PROFILES)
                         + PROPERTY_SPECS)
def test_schedule_equals_the_references(spec, seed):
    for capacity in (10, 64, 200):
        for cap in (None, 300.0):
            mine = traffic.build_traffic_schedule(spec, capacity, seed=seed,
                                                  horizon_cap=cap)
            ref = jtraffic.build_traffic_schedule(spec, capacity, seed=seed,
                                                  horizon_cap=cap)
            assert_schedules_equal(mine, ref)
            assert_schedules_equal(mine, traffic.build_traffic_schedule(
                spec, capacity, seed=seed, horizon_cap=cap))


def test_flash_crowd_drops_and_counts_as_the_reference():
    mine = traffic.build_traffic_schedule("flash-crowd", 200, seed=0)
    ref = jtraffic.build_traffic_schedule("flash-crowd", 200, seed=0)
    assert mine.n_dropped == ref.n_dropped == 1000 - 150
    assert traffic.build_traffic_schedule(
        "init:0.5,window:10,horizon:100,flash:20:100:0", 64,
        seed=0).n_dropped == 68


@pytest.mark.parametrize("spec", PROPERTY_SPECS)
def test_presence_matches_the_event_stream(spec):
    sched = traffic.build_traffic_schedule(spec, 64, seed=7)
    present = set(sched.initial.tolist())
    for seg in sched.segments:
        for cid in seg.leaves.tolist():
            assert cid in present
            present.discard(cid)
        for cid in seg.joins.tolist():
            assert cid not in present
            present.add(cid)
        assert set(np.flatnonzero(sched.presence_at(seg.start))) == present
    assert len(list(sched.events())) == sum(
        len(s.joins) + len(s.leaves) for s in sched.segments)


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("spec", PROPERTY_SPECS)
def test_bulk_apply_matches_the_per_event_oracle(spec, seed):
    """Segment-bulk application through the ``Database`` leaves the
    ``FleetStore`` bit-identical to the per-event ``ClientRecord`` path."""
    M = 64
    sched = traffic.build_traffic_schedule(spec, M, seed=seed)
    cards = np.random.default_rng(0).integers(10, 100, M)

    def seeded():
        db = Database(control_plane="columnar", device="cpu")
        db.fleet = FleetStore(capacity=M, device="cpu")
        if len(sched.initial):
            db.register_clients_bulk(sched.initial, cards[sched.initial],
                                     5, 1)
        return db

    bulk, ev = seeded(), seeded()
    for seg in sched.segments:
        if len(seg.leaves):
            bulk.unregister_clients_bulk(seg.leaves)
        if len(seg.joins):
            bulk.register_clients_bulk(seg.joins, cards[seg.joins], 5, 1)
    for t, kind, cid in sched.events():
        if kind == "leave":
            ev.unregister_client(cid)
        else:
            ev.register_client(ClientRecord(
                client_id=cid, hardware="",
                data_cardinality=int(cards[cid]), batch_size=5,
                local_epochs=1))
    fa, fb = bulk.fleet, ev.fleet
    assert fa._slot == fb._slot and fa._free == fb._free
    for col in ("active", "ids", "seq", "cardinality", "status"):
        assert np.array_equal(getattr(fa, col), getattr(fb, col)), col
    assert bulk.client_ids() == ev.client_ids()


# ------------------------------------------------------------------- runs
@pytest.mark.parametrize("profile", sorted(traffic.TRAFFIC_PROFILES)
                         + [ENGINE_SPECS[0], ENGINE_SPECS[4]])
def test_scheduler_run_equals_the_references(datasets, jmodel, profile):
    port, m, _ = run_against_reference(
        datasets, jmodel, base_cfg_kw(strategy="apodotiko", rounds=3,
                                      traffic_profile=profile),
        fleets=(det_fleet(N_CLIENTS), det_fleet(N_CLIENTS)))
    assert m["traffic_profile"] == profile
    assert port.traffic is not None
    if profile in ENGINE_SPECS:
        assert m["n_traffic_joins"] + m["n_traffic_leaves"] > 0


@pytest.mark.parametrize("profile", sorted(traffic.TRAFFIC_PROFILES)
                         + ENGINE_SPECS)
def test_controller_and_scheduler_are_bit_identical(datasets, profile):
    _, sched, m = run_engine_pair(
        base_cfg_kw(rounds=3, strategy="apodotiko", traffic_profile=profile),
        datasets[1], fleet=det_fleet(N_CLIENTS))
    assert m["traffic_segments_applied"] == sched._traffic_pos
    assert m["n_traffic_dropped"] == sched.traffic.n_dropped


def test_controller_and_scheduler_object_plane_host_data(datasets):
    run_engine_pair(base_cfg_kw(rounds=3, strategy="apodotiko",
                                traffic_profile=ENGINE_SPECS[0],
                                control_plane="object", data_plane="host"),
                    datasets[1], fleet=det_fleet(N_CLIENTS))


def test_leaves_zero_the_scaffold_variates(datasets):
    """A departed id's variate row starts from zero when it rejoins."""
    eng = Scheduler(FLConfig(**base_cfg_kw(
        rounds=3, strategy="scaffold", traffic_profile=ENGINE_SPECS[3])),
        ProxyCNN(10), datasets[1], det_fleet(N_CLIENTS), device="cpu")
    eng.run()
    assert eng.n_traffic_leaves > 0
    gone = [c for c in range(N_CLIENTS) if not eng.db.has_client(c)]
    assert gone and all(not eng.c_buf[c].any() for c in gone)


def test_traffic_off_draws_nothing(datasets):
    kw = base_cfg_kw(strategy="apodotiko")
    runs = [Scheduler(FLConfig(**kw, traffic_profile=p), ProxyCNN(10),
                      datasets[1], det_fleet(N_CLIENTS), device="cpu")
            for p in ("auto", "", "off")]
    traces = []
    for eng in runs:
        m = eng.run()
        assert eng.traffic is None and m["traffic_profile"] == ""
        assert m["n_traffic_joins"] == m["n_traffic_leaves"] == 0
        traces.append([(r.client_id, r.t_invoked, r.duration)
                       for r in eng.platform.invocations])
    assert traces[0] == traces[1] == traces[2]


# --------------------------------------------------------------- megastep
def test_trace_demo_fuses_to_each_boundary_bit_identically(datasets):
    """``trace-demo`` (joins at 90 s, leaves at 210 s): fused runs stop
    short of each unapplied segment, the segment applies at the next round
    open, and fusion re-engages after it, bit-identical to stepwise."""
    m = _fused_and_stepwise(megastep_cfg(rounds=40,
                                         traffic_profile="trace-demo"),
                            datasets[1], min_fused_rounds=30)
    assert m["megastep_scans"] >= 3
    assert (m["n_traffic_joins"], m["n_traffic_leaves"]) == (2, 2)
    assert m["megastep_fallback_reason"] == "eligible"


def test_stochastic_traffic_refuses_the_megastep(datasets):
    m = _fused_and_stepwise(megastep_cfg(
        rounds=4, traffic_profile="init:1,window:30,poisson:0:600"),
        datasets[1])
    assert m["megastep_rounds"] == 0
    assert m["megastep_fallback_reason"] == \
        "stochastic traffic profile active"
