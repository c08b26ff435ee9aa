"""The port's fused-round megastep (``repro_torch.core.megastep``).

Within the port: a ``megastep="fused"`` run must be bit-identical to the
stepwise event-driven oracle — host trace, simulated time and cost, params,
the update store's free list, the fleet's host columns and device score
state, and the trainer's generator — when the fused path engages, when it
falls back, and across the strategy matrix, where it never engages (the
twin of ``tests/test_megastep.py``).

Against the reference: the port's fused run and the reference's
``Scheduler(megastep="fused")`` start from the reference-initialized params
with the reference's minibatch draws replayed (``JaxBatchIndices``): the
host trace, the megastep counters and fallback reason and the free list
are identical, params within rtol 1e-4 / atol 1e-5 (the conv reductions
run in another order in the two frameworks). Everything runs on the CPU
(``device="cpu"``), where each kernel wrapper takes its plain version.
"""
import heapq

import numpy as np
import pytest
import torch

import jax

from repro.core.scheduler import Scheduler as JaxScheduler
from repro.core.services import FLConfig as JaxFLConfig
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch.core import aggregation
from repro_torch.core.client import CohortTrainer
from repro_torch.core.data_plane import DatasetStore
from repro_torch.core.megastep import _plan
from repro_torch.core.scheduler import Scheduler, build_engine
from repro_torch.core.services import FLConfig, resolve_megastep
from repro_torch.core.update_store import UpdateStore
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import HardwareProfile, paper_fleet
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import JaxBatchIndices
from trace_harness import (ALL_STRATEGIES, N_CLIENTS, REACTIVE, base_cfg_kw,
                           megastep_cfg)
from trace_harness import det_fleet as jax_det_fleet
from trace_harness import trace as jax_trace

RTOL, ATOL = 1e-4, 1e-5
MATRIX = ALL_STRATEGIES + REACTIVE + ("apodotiko-topk",)


@pytest.fixture(scope="module")
def data():
    return make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)


def det_fleet(n, speeds=(1.0, 1.45, 1.9)):
    """``trace_harness.det_fleet`` in the port's hardware profiles."""
    return [HardwareProfile(f"det{i % len(speeds)}",
                            speed=speeds[i % len(speeds)], vcpus=1.0,
                            mem_gib=2.0, variability=0.0)
            for i in range(n)]


def trace(engine):
    """``trace_harness.trace``: every externally observable record."""
    hist = [(l.round, l.t_start, l.t_end, l.accuracy, l.n_aggregated,
             l.n_stale) for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


def assert_params_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def assert_state_equal(a, b):
    """``trace_harness.assert_fleet_state_equal`` for the port: the fleet's
    host columns, the flushed device score state, the update store's free
    list and the trainer's generator, all bit for bit."""
    fa, fb = a.db.fleet, b.db.fleet
    for col in ("ema_num", "ema_den", "ema_num32", "ema_den32", "booster",
                "status", "n_invocations", "n_failures", "dur_len"):
        assert np.array_equal(getattr(fa, col), getattr(fb, col)), col
    assert np.array_equal(fa.durations, fb.durations)
    fa._flush_device()
    fb._flush_device()
    for col in ("num", "den", "booster", "eligible", "ever"):
        assert torch.equal(getattr(fa._dev, col), getattr(fb._dev, col)), col
    if a.store is not None or b.store is not None:
        assert a.store._free == b.store._free
    assert torch.equal(a.trainer.generator.get_state(),
                       b.trainer.generator.get_state())


def run_modes(kw, data, fleet=None, after=None):
    """One port run per megastep mode on the CPU; ``after(engine)`` (if
    given) runs a second segment on each. Returns ``{mode: (engine,
    metrics)}``."""
    runs = {}
    for mode in ("stepwise", "fused"):
        fl = list(fleet) if fleet is not None else det_fleet(
            kw.get("n_clients", N_CLIENTS))
        eng = Scheduler(FLConfig(**{**kw, "megastep": mode}), ProxyCNN(10),
                        data, fl, device="cpu")
        m = eng.run()
        if after is not None:
            m = after(eng)
        runs[mode] = (eng, m)
    return runs


def assert_fused_matches_stepwise(kw, data, fleet=None, min_fused_rounds=0,
                                  after=None):
    """The megastep's differential contract in the port (twin of
    ``trace_harness.assert_fused_matches_stepwise``). Returns
    ``(m_stepwise, m_fused)``."""
    runs = run_modes(kw, data, fleet, after)
    step, m_step = runs["stepwise"]
    fused, m_fused = runs["fused"]
    assert m_step["megastep_rounds"] == 0
    assert m_fused["megastep_rounds"] >= min_fused_rounds, \
        m_fused["megastep_fallback_reason"]
    assert trace(fused) == trace(step)
    assert m_fused["total_time"] == m_step["total_time"]
    assert m_fused["total_cost_usd"] == m_step["total_cost_usd"]
    assert_params_equal(step.params, fused.params)
    if step.db.columnar and fused.db.columnar:
        assert_state_equal(step, fused)
    return m_step, m_fused


# ------------------------------------------------------- resolution order
def test_resolve_megastep_reads_no_environment(monkeypatch):
    assert resolve_megastep("auto") == "fused"
    assert resolve_megastep("") == resolve_megastep(None) == "fused"
    assert resolve_megastep("stepwise") == "stepwise"
    monkeypatch.setenv("REPRO_MEGASTEP", "stepwise")
    assert resolve_megastep("auto") == "fused"
    with pytest.raises(ValueError, match="unknown megastep"):
        resolve_megastep("turbo")
    with pytest.raises(ValueError, match="unknown megastep"):
        Scheduler(FLConfig(megastep="turbo"), ProxyCNN(10), None, [],
                  device="cpu")


def test_default_engine_is_fused_and_reports_its_counters(data):
    eng = build_engine(FLConfig(**megastep_cfg(rounds=2)), ProxyCNN(10),
                       data, det_fleet(N_CLIENTS), device="cpu")
    assert eng.megastep == "fused"
    m = eng.metrics()
    assert (m["megastep"], m["megastep_rounds"], m["megastep_scans"],
            m["megastep_fallback_reason"]) == ("fused", 0, 0, "unattempted")


# ------------------------------------------------------------- engagement
def test_megastep_engages_and_is_bit_identical(data):
    """ceil(10/4) = 3 stepwise bootstrap rounds, then the remaining 5 as
    one fused run, every observable equal to the stepwise run's."""
    m_step, m_fused = assert_fused_matches_stepwise(
        megastep_cfg(), data, min_fused_rounds=5)
    assert m_fused["megastep_scans"] == 1
    assert m_fused["megastep_fallback_reason"] == "eligible"
    assert m_step["megastep_fallback_reason"] == "unattempted"


def test_port_fused_matches_reference_fused():
    """The port's fused run against the reference's: identical host trace,
    megastep counters and reason, free list and device booster; params
    within rtol 1e-4 / atol 1e-5."""
    kw = megastep_cfg()
    jdata = jax_dataset("mnist", n_clients=N_CLIENTS, scale=0.05, seed=0)
    data = make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)
    jmodel = JaxProxyCNN(10)
    ref = JaxScheduler(JaxFLConfig(**kw, megastep="fused"), jmodel, jdata,
                       jax_det_fleet(N_CLIENTS))
    m_ref = ref.run()
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))[0])
    port = Scheduler(FLConfig(**kw, megastep="fused"), ProxyCNN(10), data,
                     det_fleet(N_CLIENTS), device="cpu",
                     init_params=params_from_numpy(init, "cpu"))
    port.trainer.batch_indices = JaxBatchIndices(kw["seed"], kw["batch_size"])
    m = port.run()
    assert m["megastep_rounds"] == 5
    assert trace(port) == jax_trace(ref)
    for key in ("megastep_rounds", "megastep_scans",
                "megastep_fallback_reason", "total_time", "total_cost_usd",
                "invocation_counts"):
        assert m[key] == m_ref[key], key
    assert port.store._free == [int(i) for i in ref.store._free]
    ref.db.fleet._flush_device()
    port.db.fleet._flush_device()
    np.testing.assert_array_equal(port.db.fleet._dev.booster.numpy(),
                                  np.asarray(ref.db.fleet._dev.booster))
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref.params[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# -------------------------------------------------------- acceptance matrix
@pytest.mark.parametrize("strategy", MATRIX)
def test_fused_vs_stepwise_matrix(strategy, data):
    """Every strategy on the noisy paper fleet (the port's device planes):
    the fused scheduler is indistinguishable from stepwise, here through
    the eligibility fallback, since variability > 0."""
    m_step, m_fused = assert_fused_matches_stepwise(
        base_cfg_kw(strategy=strategy), data,
        fleet=paper_fleet(N_CLIENTS))
    assert m_fused["megastep_rounds"] == 0
    assert m_fused["megastep_fallback_reason"] != "eligible"


@pytest.mark.parametrize("kw,engages", [
    (dict(), True),
    (dict(eval_every=1), False),
    (dict(failure_rate=0.2), False),
    (dict(concurrency_ratio=0.5), False),
])
def test_eligibility_gates(kw, engages, data):
    """Each gate flips exactly the engagement bit; bit-identity holds on
    both sides of it."""
    m_step, m_fused = assert_fused_matches_stepwise(
        megastep_cfg(rounds=5, **kw), data)
    assert (m_fused["megastep_rounds"] > 0) == engages


@pytest.mark.parametrize("kw, match", [
    (dict(update_plane="blob"), "blob update plane"),
    (dict(data_plane="host"), "host data plane"),
])
def test_left_out_planes_still_raise_with_the_fused_default(kw, match, data):
    """The oracle planes run under the fused default, and the megastep
    refuses them with the reference's reason, bit-identical to stepwise."""
    m_step, m_fused = assert_fused_matches_stepwise(
        megastep_cfg(rounds=5, **kw), data)
    assert m_fused["megastep_rounds"] == 0
    assert m_fused["megastep_fallback_reason"] == match


# ------------------------------------------------------ fallback boundaries
def test_fallback_timer_armed_then_cleared(data):
    """An armed timer keeps the fused path out, side-effect free, and
    clearing it re-admits the very same rounds."""
    eng = Scheduler(FLConfig(**megastep_cfg(rounds=3)), ProxyCNN(10), data,
                    det_fleet(N_CLIENTS), device="cpu")
    eng.run()
    assert eng.megastep_rounds == 0          # bootstrap rounds only
    eng.cfg.rounds = 5
    heapq.heappush(eng._timers, (eng.loop.now + 5.0, 0, eng.db.round,
                                 "hedge"))
    before = (len(eng.history), eng.db.round, list(eng.store._free))
    plan, reason = _plan(eng)
    assert plan is None and reason == "timer armed"
    assert (len(eng.history), eng.db.round, list(eng.store._free)) == before
    heapq.heappop(eng._timers)
    plan, reason = _plan(eng)
    assert plan is not None and reason == "eligible"
    assert (plan.R, plan.K, plan.Kp) == (2, 4, 4)
    m = eng.run()
    assert m["megastep_rounds"] == 2


def test_fallback_k_exceeds_idle_pool(data):
    """``remove_clients`` shrinking the idle pool below K: the plan refuses
    and mutates nothing."""
    eng = Scheduler(FLConfig(**megastep_cfg(rounds=5)), ProxyCNN(10), data,
                    det_fleet(N_CLIENTS), device="cpu")
    m = eng.run()
    assert m["megastep_rounds"] > 0
    eng.remove_clients(list(range(7)))       # 3 idle < K=4
    eng.cfg.rounds = 6
    before = (len(eng.history), eng.db.round, list(eng.store._free))
    plan, reason = _plan(eng)
    assert plan is None and reason == "K exceeds idle-client count"
    assert (len(eng.history), eng.db.round, list(eng.store._free)) == before


def test_fallback_noisy_hardware(data):
    """One client with nonzero duration variability poisons the whole
    eligibility proof: every round stays stepwise, runs stay identical."""
    fleet = det_fleet(N_CLIENTS)
    fleet[3] = HardwareProfile("noisy", speed=1.45, vcpus=1.0, mem_gib=2.0,
                               variability=0.05)
    m_step, m_fused = assert_fused_matches_stepwise(
        megastep_cfg(rounds=5), data, fleet=fleet)
    assert m_fused["megastep_rounds"] == 0
    assert m_fused["megastep_fallback_reason"] \
        == "client hardware has nonzero variability"


def test_fallback_cold_horizon(data):
    """A short keep-warm window breaks the warm-horizon proof: no round
    fuses, runs stay identical including the cold-start records."""
    m_step, m_fused = assert_fused_matches_stepwise(
        megastep_cfg(rounds=5, keep_warm=0.5), data)
    assert m_fused["megastep_rounds"] == 0
    assert m_fused["megastep_fallback_reason"] \
        == "no quiescent horizon (keep-warm or sim budget)"


def test_fallback_progress_callback(data):
    """A per-round progress callback may mutate the engine mid-run, which
    the fused rounds could not observe, so it gates fusion."""
    logs = []
    eng = Scheduler(FLConfig(**megastep_cfg()), ProxyCNN(10), data,
                    det_fleet(N_CLIENTS), device="cpu")
    m = eng.run(progress=logs.append)
    assert m["megastep_rounds"] == 0
    assert "progress callback" in m["megastep_fallback_reason"]
    assert len(logs) == 8


def test_churn_between_runs_stays_identical(data):
    """``remove_clients`` between run segments: both modes remove the same
    clients, extend the horizon, and still agree bitwise, the fused path
    re-engaging on the shrunken fleet."""
    def after(eng):
        eng.remove_clients([2, 7])
        eng.cfg.rounds = 8
        return eng.run()

    m_step, m_fused = assert_fused_matches_stepwise(
        megastep_cfg(rounds=5), data, after=after)
    assert m_fused["megastep_rounds"] > 2


def test_engages_with_pad_lanes(data):
    """K = 3 pads to Kp = 4: the pad lane's row is popped and pushed back
    by the fused body's free-stack algebra as ``alloc`` / ``free`` do."""
    m_step, m_fused = assert_fused_matches_stepwise(
        megastep_cfg(clients_per_round=3), data, min_fused_rounds=4)
    assert m_fused["megastep_fallback_reason"] == "eligible"


# --------------------------------------------------- randomized properties
@pytest.mark.parametrize("seed", range(5))
def test_eligibility_never_admits_divergent_round(seed, data):
    """Seeded property sweep (the reference's): random fleets (mixed zero
    and nonzero variability, duration ties included), cohort sizes, CR
    gates, keep-warm windows and failure rates — whatever subset of
    rounds the eligibility check admits, the run stays bit-identical to
    stepwise."""
    rng = np.random.default_rng(seed)
    fleet = [HardwareProfile(f"p{i}",
                             speed=float(rng.choice([1.0, 1.3, 1.7])),
                             vcpus=1.0, mem_gib=2.0,
                             variability=float(rng.choice([0.0, 0.0, 0.1])))
             for i in range(N_CLIENTS)]
    kw = megastep_cfg(rounds=int(rng.integers(3, 7)),
                      clients_per_round=int(rng.integers(2, 5)),
                      concurrency_ratio=float(rng.choice([0.5, 1.0])),
                      keep_warm=float(rng.choice([2.0, 1e9])),
                      failure_rate=float(rng.choice([0.0, 0.0, 0.25])),
                      seed=seed)
    assert_fused_matches_stepwise(kw, data, fleet=fleet)


@pytest.mark.parametrize("seed", range(3))
def test_random_churn_schedule_stays_identical(seed, data):
    """Seeded churn schedule (the reference's): random horizon, random
    victims removed between segments, random extension — fused equals
    stepwise on the two-segment trace and end state."""
    draws = {}

    def run(mode):
        rng = np.random.default_rng(100 + seed)       # same draws per mode
        eng = Scheduler(
            FLConfig(**megastep_cfg(rounds=int(rng.integers(3, 6)),
                                    megastep=mode, seed=seed)),
            ProxyCNN(10), data, det_fleet(N_CLIENTS), device="cpu")
        eng.run()
        victims = rng.choice(N_CLIENTS, size=int(rng.integers(1, 3)),
                             replace=False)
        eng.remove_clients([int(v) for v in victims])
        eng.cfg.rounds += int(rng.integers(1, 4))
        eng.run()
        draws[mode] = victims.tolist()
        return eng

    step, fused = run("stepwise"), run("fused")
    assert draws["stepwise"] == draws["fused"]
    assert step.megastep_rounds == 0
    assert trace(fused) == trace(step)
    assert_params_equal(step.params, fused.params)
    assert_state_equal(step, fused)


def test_plan_refuses_scaffold_with_its_reason(data):
    eng = Scheduler(FLConfig(**megastep_cfg(strategy="scaffold")),
                    ProxyCNN(10), data, det_fleet(N_CLIENTS), device="cpu")
    plan, reason = _plan(eng)
    assert plan is None
    assert reason == "strategy is not adapter-wrapped apodotiko-topk"
    eng.policy.strategy.name = "apodotiko-topk"   # past the policy gate
    assert _plan(eng) == (None, "scaffold variates")


# ------------------------------------------------------- the body's parts
def test_fused_weight_normalization_equals_the_hosts():
    """Integer-valued weights (s(T,T) = 1, so the weight is n): the fused
    body's ``w / w.sum()`` on a tensor equals the host's fp32 cast then
    normalize to the bit, whatever the order of the sum."""
    rng = np.random.default_rng(0)
    for k in (1, 4, 30, 100, 1000):
        n = rng.integers(1, 600, size=k)
        host = n.astype(np.float64).astype(np.float32)
        host = host / host.sum()
        w = torch.as_tensor(n.astype(np.float32))
        got = (w / w.sum()).numpy()
        assert np.array_equal(got.view(np.int32), host.view(np.int32)), k


@pytest.mark.parametrize("cap, k, plant", [(208, 100, False),
                                           (208, 30, False),
                                           (16, 3, True)])
def test_aggregate_rows_traced_equals_the_stepwise_route(cap, k, plant):
    """The fused body's aggregation on card-resident ids and weights equals
    the stepwise route to the bit: the gather where ``rows_dispatch`` says
    so, the sweep otherwise, and the sweep's guard recompute when a freed
    row holds inf (``plant``)."""
    gen = torch.Generator().manual_seed(k)
    buf = torch.randn(cap, 4096, generator=gen)
    rows = torch.randperm(cap, generator=gen)[:k]
    if plant:
        free = [i for i in range(cap) if i not in set(rows.tolist())][0]
        buf[free, 5] = float("inf")
    w = torch.rand(k, generator=gen)
    w = w / w.sum()
    sparse = aggregation.rows_dispatch(cap, k)
    assert sparse == (cap >= 4 * max(k, 8))
    want = (ops.aggregate_rows_gather if sparse else ops.aggregate_rows)(
        buf, rows.numpy(), w.numpy())
    if plant:
        assert not bool(torch.isfinite(want).all())
        want = ops.aggregate_rows_gather(buf, rows.numpy(), w.numpy())
    got = ops.aggregate_rows_traced(buf, rows, w, sparse=sparse)
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_train_cohort_rows_equals_train_cohort_indexed(data):
    """The fused body's cohort entry (device tensors, rows allocated by the
    caller) trains as the stepwise entry does: the same rows, losses and
    generator state, to the bit."""
    params = ProxyCNN(10).init(torch.Generator().manual_seed(1))
    sel = np.array([4, 1, 2], np.int64)            # K=3 -> Kp=4
    n = data.n[sel].astype(np.int64)
    steps = np.maximum(np.ceil(n / 5).astype(np.int64), 1)
    n_params = sum(p.numel() for p in params.values())
    results = []
    for entry in ("indexed", "rows"):
        t = CohortTrainer(ProxyCNN(10), optimizer="adam", lr=1e-3,
                          batch_size=5, seed=7, device="cpu")
        store = UpdateStore(n_params, capacity=8, device="cpu")
        ds = DatasetStore(data, device="cpu")
        if entry == "indexed":
            ids, _, loss = t.train_cohort_indexed(params, ds, sel, n, steps,
                                                  update_sink=store)
        else:
            ids = store.alloc(4)
            sel_p = torch.as_tensor(np.append(sel, sel[-1]))
            loss = t.train_cohort_rows(
                params, ds, sel_p, torch.as_tensor(np.append(n, n[-1])),
                torch.as_tensor(np.append(steps, 0).astype(np.int32)),
                store.buffer, torch.as_tensor(ids))
            ids, loss = ids[:3], loss[:3].numpy()
        results.append((store.gather(ids), loss, t.generator.get_state()))
    (a, la, ga), (b, lb, gb) = results
    assert torch.equal(a, b) and np.array_equal(la, lb) and torch.equal(ga, gb)


def test_free_stack_is_the_alloc_order():
    store = UpdateStore(1500, capacity=16, device="cpu")
    store.free(store.alloc(5)[::-1])
    stack = store.free_stack()
    assert stack.dtype == np.int64 and stack.tolist() == store._free
    assert store.alloc(3).tolist() == stack[::-1][:3].tolist()
