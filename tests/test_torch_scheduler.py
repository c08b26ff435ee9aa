"""The port's event-driven ``Scheduler`` (``build_engine``'s default) vs the
reference's ``Scheduler(megastep="stepwise")``, and vs the port's own
``Controller`` poll loop.

Against the reference: both start from the reference-initialized params
on the same numpy dataset, with the reference's minibatch draws replayed
(``JaxBatchIndices``). The host trace (selections, invocation records,
hedges, cancellations, retries, round boundaries, simulated clock, cost)
depends only on numpy RNG and must be identical, as must the update
store's free list and the accuracies (both divide the correct count in
fp32). Params agree at rtol 1e-4 / atol 1e-5: the conv reductions run in
another order in the two frameworks.

Within the port, the Controller and the Scheduler on the same config are
bit-identical (the twin of ``trace_harness.assert_engines_equivalent``)."""
import numpy as np
import pytest
import torch

import jax

from repro.core.scheduler import Scheduler as JaxScheduler
from repro.core.services import FLConfig as JaxFLConfig
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.faas.hardware import HARDWARE_PROFILES as JAX_PROFILES
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro.models.proxy_models import ProxyLSTM as JaxProxyLSTM
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import Scheduler, build_engine
from repro_torch.core.services import FLConfig, resolve_engine
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import HARDWARE_PROFILES, paper_fleet
from repro_torch.kernels.topk import block_topk
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN, ProxyLSTM
from test_torch_client_store import JaxBatchIndices, one_torch_thread  # noqa: F401
from trace_harness import N_CLIENTS, base_cfg_kw

RTOL, ATOL = 1e-4, 1e-5

# the smoke_hedge preset (sweep/presets.py): cold starts dominate and
# keep-warm sits below the round cadence, so hedges ride warm containers
HEDGE_KW = dict(cold_start_s=120.0, keep_warm=30.0, hedge_fraction=1.0,
                concurrency_ratio=0.5)
RECOVERY_KW = dict(failure_rate=0.3, invocation_timeout=9.0, retry_budget=3,
                   retry_jitter=0.1, quarantine_threshold=2,
                   quarantine_rounds=2)
METRICS = ("rounds", "total_time", "total_cost_usd", "cold_start_ratio",
           "n_invocations", "invocation_counts", "n_hedges", "n_hedge_wins",
           "n_cancelled", "n_failures", "n_timeouts", "n_retries",
           "n_quarantined", "retry_latency_s", "failures_by_phase",
           "final_accuracy", "history", "strategy", "engine")


def straggler_fleet(profiles, n):
    """The sweep's "straggler" scenario: 75% 1vCPU, 25% GPU, shuffled."""
    rng = np.random.default_rng(0)
    n_slow = round(n * 0.75)
    fleet = ([profiles["cpu1"]] * n_slow
             + [profiles["gpu"]] * (n - n_slow))
    rng.shuffle(fleet)
    return fleet


def trace(engine):
    """``trace_harness.trace``: every externally observable record."""
    hist = [(l.round, l.t_start, l.t_end, l.accuracy, l.n_aggregated,
             l.n_stale) for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


@pytest.fixture(scope="module")
def datasets():
    jdata = jax_dataset("mnist", n_clients=N_CLIENTS, scale=0.05, seed=0)
    data = make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)
    for f in ("X", "y", "n", "eval_x", "eval_y"):
        np.testing.assert_array_equal(getattr(data, f), getattr(jdata, f))
    return jdata, data


# the two other proxies the sweep trains: its shakespeare cells (SGD 0.5,
# batch 8: sweep/runner.py) and a speech cell's 35-class CNN
OTHER_PROXIES = {
    "shakespeare": (lambda: (JaxProxyLSTM(vocab=82, seq_len=20),
                             ProxyLSTM(vocab=82, seq_len=20)),
                    dict(optimizer="sgd", lr=0.5, batch_size=8)),
    "speech": (lambda: (JaxProxyCNN(35), ProxyCNN(35)), {}),
}


@pytest.fixture(scope="module")
def other_datasets():
    out = {}
    for name in OTHER_PROXIES:
        jdata = jax_dataset(name, n_clients=N_CLIENTS, scale=0.05, seed=0)
        data = make_federated_dataset(name, n_clients=N_CLIENTS, scale=0.05,
                                      seed=0)
        for f in ("X", "y", "n", "eval_x", "eval_y"):
            np.testing.assert_array_equal(getattr(data, f),
                                          getattr(jdata, f))
        out[name] = (jdata, data)
    return out


def _run_both(datasets, kw, straggler=False, models=None):
    jdata, data = datasets
    if straggler:
        jfleet = straggler_fleet(JAX_PROFILES, N_CLIENTS)
        fleet = straggler_fleet(HARDWARE_PROFILES, N_CLIENTS)
    else:
        jfleet, fleet = jax_fleet(N_CLIENTS), paper_fleet(N_CLIENTS)
    jmodel, model = models or (JaxProxyCNN(10), ProxyCNN(10))
    ref = JaxScheduler(JaxFLConfig(**kw, megastep="stepwise"), jmodel, jdata,
                       list(jfleet))
    m_ref = ref.run()
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))[0])
    port = build_engine(FLConfig(**kw), model, data, list(fleet),
                        device="cpu", init_params=params_from_numpy(init, "cpu"))
    assert isinstance(port, Scheduler)
    port.trainer.batch_indices = JaxBatchIndices(kw["seed"], kw["batch_size"])
    m = port.run()
    assert trace(port) == trace(ref)
    for key in METRICS:
        assert m[key] == m_ref[key], key
    assert [l.accuracy for l in port.history] == \
        [float(l.accuracy) for l in ref.history]
    assert port.store._free == ref.store._free
    assert sorted(port.inflight) == sorted(ref.inflight)
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref.params[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    return port, m


@pytest.mark.parametrize("strategy", ["fedavg", "apodotiko", "apodotiko-topk",
                                      "apodotiko-adaptive"])
def test_scheduler_matches_reference(datasets, strategy):
    launches = block_topk.launches
    port, m = _run_both(datasets, base_cfg_kw(strategy=strategy, rounds=3))
    assert m["rounds"] == 3 and m["engine"] == "scheduler"
    assert m["megastep"] == "fused" and m["megastep_rounds"] == 0
    assert m["megastep_fallback_reason"] == (
        "per-round evaluation enabled" if strategy == "apodotiko-topk"
        else "strategy is not adapter-wrapped apodotiko-topk")
    assert block_topk.launches == launches      # the CPU takes the plain route
    if strategy == "apodotiko-topk":
        assert port.db.columnar and port.db.fleet._dev is not None


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("dataset", list(OTHER_PROXIES))
def test_scheduler_matches_reference_on_the_other_proxies(other_datasets,
                                                          dataset):
    """ProxyLSTM on the shakespeare proxy (int32 token ids through the
    resident store, SGD) and ProxyCNN(35) on the speech proxy (Adam)."""
    make_models, over = OTHER_PROXIES[dataset]
    port, m = _run_both(other_datasets[dataset],
                        base_cfg_kw(strategy="apodotiko", rounds=3, **over),
                        models=make_models())
    assert m["rounds"] == 3 and m["n_invocations"] > 0
    assert port.dataset.X.dtype == (torch.int32 if dataset == "shakespeare"
                                    else torch.float32)


def test_scheduler_matches_reference_with_hedges_firing(datasets):
    port, m = _run_both(
        datasets, base_cfg_kw(strategy="apodotiko-hedge", rounds=4,
                              **HEDGE_KW), straggler=True)
    assert m["n_hedges"] > 0 and m["n_cancelled"] > 0


def test_scheduler_matches_reference_with_recovery(datasets):
    port, m = _run_both(
        datasets, base_cfg_kw(strategy="apodotiko", rounds=3, **RECOVERY_KW))
    assert m["n_failures"] > 0
    assert m["n_retries"] > 0 and m["n_timeouts"] > 0
    assert m["n_quarantined"] > 0


@pytest.mark.parametrize("strategy", ["fedavg", "fedprox", "fedlesscan",
                                      "fedbuff", "apodotiko", "apodotiko-topk"])
def test_port_controller_and_scheduler_are_bit_identical(datasets, strategy):
    _, data = datasets
    cfg = FLConfig(**base_cfg_kw(strategy=strategy, rounds=3))
    legacy = Controller(cfg, ProxyCNN(10), data, list(paper_fleet(N_CLIENTS)),
                        device="cpu")
    m_legacy = legacy.run()
    sched = Scheduler(cfg, ProxyCNN(10), data, list(paper_fleet(N_CLIENTS)),
                      device="cpu")
    m_sched = sched.run()
    assert trace(sched) == trace(legacy)
    for key in ("total_time", "total_cost_usd", "strategy"):
        assert m_sched[key] == m_legacy[key], key
    assert (m_sched["engine"], m_legacy["engine"]) == ("scheduler",
                                                       "controller")
    assert sched.store._free == legacy.store._free
    for name, leaf in sched.params.items():
        assert torch.equal(leaf, legacy.params[name]), name


def test_build_engine_resolves_auto_scheduler_and_legacy(datasets):
    _, data = datasets
    assert resolve_engine("auto") == resolve_engine(None) == "scheduler"
    assert resolve_engine("legacy") == "legacy"
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine("poll")
    kinds = {}
    for engine in ("auto", "scheduler", "legacy"):
        cfg = FLConfig(**base_cfg_kw(rounds=1, engine=engine))
        eng = build_engine(cfg, ProxyCNN(10), data,
                           list(paper_fleet(N_CLIENTS)), device="cpu")
        kinds[engine] = type(eng)
    assert kinds == {"auto": Scheduler, "scheduler": Scheduler,
                     "legacy": Controller}
    with pytest.raises(ValueError, match="reactive"):
        build_engine(FLConfig(**base_cfg_kw(strategy="apodotiko-hedge",
                                            engine="legacy")),
                     ProxyCNN(10), data, list(paper_fleet(N_CLIENTS)),
                     device="cpu")
