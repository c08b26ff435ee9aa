"""The port's fault injection (``repro_torch.faas.faults``) against the
reference's (``repro.faas.faults``), and within the port.

Against the reference: the parsed specs, the resolved profiles and every
``FaultModel.evaluate`` outcome are equal; the platform's invocation
records under each profile (phase attribution, slowdowns, late landings,
zombies, cold starts after a crash) are equal field for field; and a full
``Scheduler`` run under each canned profile, with the ``chaos`` preset's
recovery layer armed, gives the reference's chaos trace (every invocation's
phase, loss, timeout and cancellation flags), counters and accuracies, from
the reference-initialized params with its minibatch draws replayed
(``JaxBatchIndices``); params within rtol 1e-4 / atol 1e-5.

Within the port (the twin of ``tests/chaos_harness.py``): the ``Controller``
and the ``Scheduler`` give bit-identical runs under each profile, a crash
storm leaks no update row or blob on either update plane, and the fused
megastep refuses faulted rounds with the reference's reasons while staying
bit-identical to the stepwise engine."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax

import repro.core.megastep as jax_megastep
from repro.core.scheduler import Scheduler as JaxScheduler
from repro.core.services import FLConfig as JaxFLConfig
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.faas import faults as jfaults
from repro.faas.hardware import HardwareProfile as JaxHardwareProfile
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.faas.platform import FaaSPlatform as JaxPlatform
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import Scheduler, build_engine
from repro_torch.core.services import FLConfig
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas import faults
from repro_torch.faas.hardware import HardwareProfile, paper_fleet
from repro_torch.faas.platform import FaaSPlatform
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import JaxBatchIndices, one_torch_thread  # noqa: F401
from trace_harness import N_CLIENTS, base_cfg_kw

RTOL, ATOL = 1e-4, 1e-5
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the ``chaos`` preset's recovery layer (sweep/presets.py)
CHAOS_KW = dict(retry_budget=8, invocation_timeout=300.0,
                quarantine_threshold=3)
HW = HardwareProfile("t", speed=1.0, vcpus=1.0, mem_gib=2.0)
JHW = JaxHardwareProfile("t", speed=1.0, vcpus=1.0, mem_gib=2.0)
# every kind of fault, a window that opens at t = 0 (the canned outage
# windows open at 150 s, past a 3-round run at this size)
ALL_KINDS = ("crash:train:0.2,slow:2.5:0.2,loss:0.15:0.2:45,oom:2.0:0.3,"
             "crash:startup:0.1,crash:upload:0.1,outage:0-40:mod3=1")


def det_fleet(n, speeds=(1.0, 1.45, 1.9)):
    """``trace_harness.det_fleet`` in the port's hardware profiles."""
    return [HardwareProfile(f"det{i % len(speeds)}",
                            speed=speeds[i % len(speeds)], vcpus=1.0,
                            mem_gib=2.0, variability=0.0)
            for i in range(n)]


def megastep_cfg(**kw):
    """``trace_harness.megastep_cfg``: a config the fused path engages on."""
    base = dict(n_clients=N_CLIENTS, clients_per_round=4, rounds=8,
                local_epochs=1, batch_size=5, base_step_time=0.5,
                strategy="apodotiko-topk", concurrency_ratio=1.0,
                eval_every=0, keep_warm=1e9, seed=0)
    base.update(kw)
    return base


def chaos_trace(engine):
    """``chaos_harness.chaos_trace``: the round log, every invocation
    record, and each invocation's fault attribution."""
    hist = [(l.round, l.t_start, l.t_end, l.accuracy, l.n_aggregated,
             l.n_stale) for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    flt = [(r.client_id, r.round, r.failed_phase, r.lost, r.timed_out,
            r.cancelled) for r in engine.platform.invocations]
    return hist, inv, flt


def assert_params_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def assert_no_leaks(engine):
    """``chaos_harness.assert_no_leaks`` for the port: every in-flight entry
    is live, and every allocated update row / stored blob is reachable from
    an un-aggregated result or a live un-landed payload."""
    live_rows = set()
    for cid, invs in engine.inflight.items():
        assert invs, f"empty inflight bucket leaked for client {cid}"
        for inv in invs:
            assert not inv.done, f"settled invocation leaked for {cid}"
            if not inv.payload.landed and inv.payload.row >= 0:
                live_rows.add(inv.payload.row)
    db = engine.db
    pending = {r.update_row for r in db.results
               if not r.aggregated and r.update_row >= 0}
    if engine.update_plane == "device":
        free = list(engine.store._free)
        assert len(free) == len(set(free)), "duplicate free-list entries"
        allocated = set(range(engine.store.capacity)) - set(free)
        assert allocated == pending | live_rows
    else:
        assert engine.store is None
    expected = {r.update_key for r in db.results
                if not r.aggregated and r.update_key}
    expected |= set(db.global_models.values())
    assert set(db.blobs) == expected


def assert_fleet_consistent(engine):
    """``chaos_harness.assert_fleet_consistent``: the slot map and the free
    list partition the columnar fleet's capacity."""
    if not engine.db.columnar:
        return
    fleet = engine.db.fleet
    free = list(fleet._free)
    assert len(free) == len(set(free))
    active = set(np.flatnonzero(fleet.active).tolist())
    assert active.isdisjoint(free)
    assert active | set(free) == set(range(fleet.capacity))
    assert set(fleet._slot.values()) == active
    for cid, slot in fleet._slot.items():
        assert int(fleet.ids[slot]) == int(cid)


def run_engine_pair(kw, data, fleet=None):
    """The port's ``Controller`` and ``Scheduler`` on one config (recovery
    off: it is Scheduler-only): bit-identical chaos traces, counters and
    params, and no leak on either (the twin of
    ``chaos_harness.run_chaos_pair``). Returns (legacy, sched, metrics)."""
    cfg = FLConfig(**kw)
    assert not (cfg.invocation_timeout or cfg.retry_budget
                or cfg.quarantine_threshold or cfg.quorum_fraction < 1.0)
    fl = list(fleet) if fleet is not None else list(paper_fleet(N_CLIENTS))
    legacy = Controller(cfg, ProxyCNN(10), data, list(fl), device="cpu")
    m_legacy = legacy.run()
    sched = Scheduler(FLConfig(**kw), ProxyCNN(10), data, list(fl),
                      device="cpu")
    m_sched = sched.run()
    assert chaos_trace(sched) == chaos_trace(legacy)
    for key in ("total_time", "total_cost_usd", "n_failures",
                "failures_by_phase", "n_traffic_joins", "n_traffic_leaves",
                "n_traffic_dropped", "traffic_segments_applied"):
        assert m_sched[key] == m_legacy[key], key
    assert_params_equal(legacy.params, sched.params)
    for eng in (legacy, sched):
        assert_no_leaks(eng)
        assert_fleet_consistent(eng)
    return legacy, sched, m_sched


@pytest.fixture(scope="module")
def datasets():
    jdata = jax_dataset("mnist", n_clients=N_CLIENTS, scale=0.05, seed=0)
    data = make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)
    for f in ("X", "y", "n", "eval_x", "eval_y"):
        np.testing.assert_array_equal(getattr(data, f), getattr(jdata, f))
    return jdata, data


@pytest.fixture(scope="module")
def jmodel():
    """One reference model for the module: its compiled cohort programs
    are cached by model object, so the runs share them."""
    return JaxProxyCNN(10)


def run_against_reference(datasets, jmodel, kw, fleets=None):
    """The reference's stepwise ``Scheduler`` and the port's ``build_engine``
    on one config, from the reference's params with its draws replayed:
    the chaos trace, the counters and the accuracies equal, params within
    rtol 1e-4 / atol 1e-5. Returns (port engine, port metrics, reference
    metrics)."""
    jdata, data = datasets
    jfleet, fleet = fleets or (jax_fleet(N_CLIENTS), paper_fleet(N_CLIENTS))
    ref = JaxScheduler(JaxFLConfig(**kw, megastep="stepwise"), jmodel, jdata,
                       list(jfleet))
    m_ref = ref.run()
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(
        kw["seed"]))[0])
    port = build_engine(FLConfig(**kw), ProxyCNN(10), data, list(fleet),
                        device="cpu", init_params=params_from_numpy(init, "cpu"))
    port.trainer.batch_indices = JaxBatchIndices(kw["seed"], kw["batch_size"])
    m = port.run()
    assert chaos_trace(port) == chaos_trace(ref)
    for key in ("rounds", "total_time", "total_cost_usd", "cold_start_ratio",
                "n_invocations", "n_failures", "n_timeouts", "n_retries",
                "n_quarantined", "retry_latency_s", "failures_by_phase",
                "fault_profile", "traffic_profile", "n_traffic_joins",
                "n_traffic_leaves", "n_traffic_dropped",
                "traffic_segments_applied", "update_plane", "data_plane",
                "update_host_bytes", "data_host_bytes", "history"):
        assert m[key] == m_ref[key], key
    if port.store is not None:
        assert port.store._free == ref.store._free
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref.params[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    return port, m, m_ref


# ------------------------------------------------------- parse and resolve
def _as_plain(fault):
    return type(fault).__name__, dataclasses.asdict(fault)


@pytest.mark.parametrize("spec", list(faults.FAULT_PROFILES.values()) + [
    ALL_KINDS, "outage:10-20:3+7", "loss:0.5", "loss:0.5:0.3"])
def test_parse_equals_the_references(spec):
    mine, ref = faults.parse_faults(spec), jfaults.parse_faults(spec)
    assert [_as_plain(f) for f in mine] == [_as_plain(f) for f in ref]


def test_resolve_and_build_read_no_environment(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "crash-heavy")
    for off in ("auto", "", None, "none", "off"):
        assert faults.resolve_fault_profile(off) == ""
    assert faults.FAULT_PROFILES == jfaults.FAULT_PROFILES
    for name in faults.FAULT_PROFILES:
        assert faults.resolve_fault_profile(name) == name
    assert faults.resolve_fault_profile(ALL_KINDS) == ALL_KINDS
    with pytest.raises(ValueError, match="unknown fault spec"):
        faults.resolve_fault_profile("meteor:0.5")
    with pytest.raises(ValueError, match="unknown crash phase"):
        faults.parse_faults("crash:teardown:0.5")
    assert faults.build_fault_model("", 0) is None
    model = faults.build_fault_model("crash-heavy", 3)
    assert model.active and len(model.stochastic) == 3
    (w,) = faults.parse_faults("outage:10-20:3+7")
    assert w.hits(3, 15.0) and w.hits(7, 10.0)
    assert not w.hits(4, 15.0) and not w.hits(3, 20.0)


# ---------------------------------------------------------- the fault model
@pytest.mark.parametrize("spec", sorted(faults.FAULT_PROFILES) + [ALL_KINDS])
def test_outcomes_replay_and_equal_the_references(spec):
    """Same (schedule, seed): the same outcomes, call for call, in both
    packages; another seed, other outcomes."""
    def outcomes(mod, hw, seed):
        m = mod.build_fault_model(spec, seed)
        return [dataclasses.asdict(m.evaluate(cid, float(t), hw))
                for t in range(0, 600, 7) for cid in range(6)]

    mine = outcomes(faults, HW, 7)
    assert mine == outcomes(faults, HW, 7)
    assert mine == outcomes(jfaults, JHW, 7)
    if spec != "outage-window":
        assert outcomes(faults, HW, 8) != mine


def test_outage_is_deterministic_and_draws_only_the_fraction():
    """An outage-only schedule takes exactly one draw a call (the crash
    fraction), so its generator stays in lockstep with a bare generator
    drawing one uniform a call."""
    m = faults.FaultModel(faults.FaultSchedule(
        seed=5, faults=faults.parse_faults("outage:10-20:mod2=0")))
    bare = np.random.default_rng(5)
    for t in range(30):
        out = m.evaluate(t % 5, float(t), HW)
        assert out.frac == float(bare.uniform(0.1, 0.9))
        hit = 10 <= t < 20 and (t % 5) % 2 == 0
        assert out.failed_phase == ("outage" if hit else "")
    assert m._rng.bit_generator.state == bare.bit_generator.state


def test_oom_keys_on_the_hardware_tier():
    m = faults.FaultModel(faults.FaultSchedule(seed=0, faults=(
        faults.OOMFault(rate=1.0, mem_below_gib=2.0),)))
    big = HardwareProfile("big", speed=1.0, vcpus=2.0, mem_gib=4.0)
    assert m.evaluate(0, 0.0, HW).failed_phase == "oom"
    assert m.evaluate(0, 0.0, big).failed_phase == ""


@pytest.mark.parametrize("spec", sorted(faults.FAULT_PROFILES) + [ALL_KINDS])
def test_platform_phase_attribution_equals_the_references(spec):
    """Each invocation record (duration by phase, slowdown, late landing,
    zombie, cold start after a crash) equals the reference platform's."""
    fleet, jfleet = paper_fleet(12), jax_fleet(12)
    mine = FaaSPlatform(seed=3, keep_warm=60.0,
                        faults=faults.build_fault_model(spec, 3))
    ref = JaxPlatform(seed=3, keep_warm=60.0,
                      faults=jfaults.build_fault_model(spec, 3))
    for t in range(0, 900, 15):
        for cid in range(12):
            a = mine.invoke(cid, t // 60, float(t), 7.0 + cid, fleet[cid],
                            0.5)
            b = ref.invoke(cid, t // 60, float(t), 7.0 + cid, jfleet[cid],
                           0.5)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    phases = {r.failed_phase for r in mine.invocations}
    assert phases - {""}, "no fault struck"
    if spec == ALL_KINDS:
        assert phases >= {"startup", "train", "upload", "oom", "outage",
                          "loss"}
        assert any(r.duration > 40 for r in mine.invocations
                   if not r.failed)                   # late landings


# ------------------------------------------------------- runs vs reference
@pytest.mark.parametrize("profile", sorted(faults.FAULT_PROFILES)
                         + [ALL_KINDS])
def test_scheduler_run_equals_the_references(datasets, jmodel, profile):
    port, m, _ = run_against_reference(
        datasets, jmodel, base_cfg_kw(strategy="apodotiko", rounds=3,
                                      fault_profile=profile, **CHAOS_KW))
    assert m["fault_profile"] == profile
    assert port.platform.faults is not None and port.platform.faults.active
    if profile != "outage-window":          # its windows open at 150 s
        assert m["n_failures"] > 0
    assert_no_leaks(port)


# ---------------------------------------------------------- within the port
@pytest.mark.parametrize("profile", sorted(faults.FAULT_PROFILES)
                         + [ALL_KINDS])
def test_controller_and_scheduler_are_bit_identical(datasets, profile):
    _, _, m = run_engine_pair(
        base_cfg_kw(strategy="fedavg", fault_profile=profile), datasets[1])
    assert m["fault_profile"] == profile


def test_controller_and_scheduler_async_on_the_blob_plane(datasets):
    run_engine_pair(base_cfg_kw(strategy="apodotiko", update_plane="blob",
                                fault_profile="lossy-network"), datasets[1])


def test_faults_off_is_the_fault_free_run(datasets):
    kw = base_cfg_kw(strategy="fedavg")
    a = Scheduler(FLConfig(**kw), ProxyCNN(10), datasets[1],
                  list(paper_fleet(N_CLIENTS)), device="cpu")
    a.run()
    assert a.platform.faults is None
    b = Scheduler(FLConfig(**kw, fault_profile="none"), ProxyCNN(10),
                  datasets[1], list(paper_fleet(N_CLIENTS)), device="cpu")
    b.run()
    assert chaos_trace(a) == chaos_trace(b)
    assert a.metrics()["fault_profile"] == b.metrics()["fault_profile"] == ""


@pytest.mark.parametrize("update_plane", ("device", "blob"))
def test_crash_storm_leaves_no_leaks(datasets, update_plane):
    kw = base_cfg_kw(strategy="apodotiko", update_plane=update_plane,
                     fault_profile="crash:train:0.5,crash:startup:0.2,"
                                   "crash:upload:0.2")
    eng = Scheduler(FLConfig(**kw), ProxyCNN(10), datasets[1],
                    list(paper_fleet(N_CLIENTS)), device="cpu")
    m = eng.run()
    assert m["n_failures"] > 0
    assert set(m["failures_by_phase"]) <= {"startup", "train", "upload"}
    assert_no_leaks(eng)
    assert_fleet_consistent(eng)


def test_outage_targets_only_its_group(datasets):
    eng = Scheduler(FLConfig(**base_cfg_kw(
        strategy="fedavg", fault_profile="outage:0-100000:mod2=1")),
        ProxyCNN(10), datasets[1], list(paper_fleet(N_CLIENTS)),
        device="cpu")
    assert eng.run()["n_failures"] > 0
    for r in eng.platform.invocations:
        assert r.failed == (r.client_id % 2 == 1)
        assert r.failed_phase == ("outage" if r.failed else "")


# ----------------------------------------------------------------- megastep
def _fused_and_stepwise(kw, data, min_fused_rounds=0):
    """Both megastep modes of one faulted config: bit-identical runs.
    Returns the fused run's metrics."""
    runs = {}
    for mode in ("stepwise", "fused"):
        eng = Scheduler(FLConfig(**{**kw, "megastep": mode}), ProxyCNN(10),
                        data, det_fleet(N_CLIENTS), device="cpu")
        runs[mode] = (eng, eng.run())
    (step, m_step), (fused, m_fused) = runs["stepwise"], runs["fused"]
    assert m_step["megastep_rounds"] == 0
    assert m_fused["megastep_rounds"] >= min_fused_rounds
    assert chaos_trace(fused) == chaos_trace(step)
    assert m_fused["total_time"] == m_step["total_time"]
    assert_params_equal(step.params, fused.params)
    assert step.store._free == fused.store._free
    return m_fused


@pytest.mark.parametrize("kw, reason", [
    (dict(invocation_timeout=500.0), "retry/timeout recovery enabled"),
    (dict(retry_budget=2), "retry/timeout recovery enabled"),
    (dict(quorum_fraction=0.5), "partial-cohort quorum enabled"),
    (dict(fault_profile="crash:train:0.3"),
     "stochastic fault schedule active"),
])
def test_recovery_and_stochastic_faults_refuse_the_megastep(datasets, kw,
                                                            reason):
    """The reference's reasons (``tests/test_chaos.py``), each a string of
    the reference's ``_plan``."""
    assert f'"{reason}"' in inspect.getsource(jax_megastep._plan)
    eng = Scheduler(FLConfig(**megastep_cfg(rounds=2, megastep="fused",
                                            **kw)),
                    ProxyCNN(10), datasets[1], det_fleet(N_CLIENTS),
                    device="cpu")
    m = eng.run()
    assert m["megastep_rounds"] == 0
    assert m["megastep_fallback_reason"] == reason


def _round_start(kw, data, r):
    cal = Scheduler(FLConfig(**kw, megastep="stepwise"), ProxyCNN(10), data,
                    det_fleet(N_CLIENTS), device="cpu")
    cal.run()
    return cal.history[r].t_start


def test_megastep_refuses_an_overlapping_outage_window(datasets):
    kw = megastep_cfg(rounds=3, clients_per_round=N_CLIENTS)
    t1 = _round_start(kw, datasets[1], 1)
    m = _fused_and_stepwise(
        dict(kw, fault_profile=f"outage:{t1 - 0.5}-1000000:mod1=0"),
        datasets[1])
    assert m["megastep_rounds"] == 0
    reason = "fault window overlaps horizon"
    assert m["megastep_fallback_reason"] == reason
    assert f'"{reason}"' in inspect.getsource(jax_megastep._plan)


def test_megastep_reengages_after_an_outage_window(datasets):
    kw = megastep_cfg(rounds=8, clients_per_round=N_CLIENTS)
    t3 = _round_start(kw, datasets[1], 3)
    m = _fused_and_stepwise(
        dict(kw, fault_profile=f"outage:{t3 - 0.25}-{t3 + 0.25}:mod2=1"),
        datasets[1], min_fused_rounds=1)
    assert m["megastep_scans"] >= 2
    assert 0 < m["megastep_rounds"] < kw["rounds"] - 1
    assert m["n_failures"] > 0
    assert m["failures_by_phase"] == {"outage": m["n_failures"]}


def test_megastep_engages_with_a_future_window(datasets):
    m = _fused_and_stepwise(
        megastep_cfg(rounds=4, clients_per_round=N_CLIENTS,
                     fault_profile="outage:1e7-2e7:mod1=0"),
        datasets[1], min_fused_rounds=1)
    assert m["megastep_scans"] >= 1
