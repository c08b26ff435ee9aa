"""SCAFFOLD in the port: the control-variate buffer, the cohort step's
variate correction and update, and the runtime's elastic membership.

Against the reference, on both engines: the port starts from the
reference-initialized params with the reference's minibatch draws replayed
(``JaxBatchIndices``). The host trace is identical; params and ``c_global``
agree at rtol 1e-4 / atol 1e-5 (the conv reductions, and the sum of the
cohort's variate deltas, run in another order in the two frameworks). A
client's variate divides a params difference by ``steps * lr``, so the
per-client rows of ``c_buf`` are held to atol 1e-5 / lr. Within the port
the Controller and the Scheduler are bit-identical. CPU only
(``device="cpu"``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.client import CohortTrainer as JaxTrainer
from repro.core.controller import Controller as JaxController
from repro.core.data_plane import DatasetStore as JaxDatasetStore
from repro.core.scheduler import Scheduler as JaxScheduler
from repro.core.services import FLConfig as JaxFLConfig
from repro.core.update_store import UpdateStore as JaxUpdateStore
from repro.core.update_store import (gather_stacked as jax_gather_stacked,
                                     grow_stacked as jax_grow_stacked,
                                     scatter_stacked_tree as jax_scatter)
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch.core.client import CohortTrainer
from repro_torch.core.controller import Controller
from repro_torch.core.data_plane import DatasetStore
from repro_torch.core.database import ClientRecord
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.services import FLConfig
from repro_torch.core.strategies.base import StrategyConfig, build_strategy
from repro_torch.core.update_store import (UpdateStore, gather_stacked,
                                           grow_stacked, scatter_stacked_tree)
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import paper_fleet
from repro_torch.kernels.ops import RavelSpec
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import JaxBatchIndices
from trace_harness import N_CLIENTS, base_cfg_kw
from trace_harness import trace as jax_trace

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def datasets():
    return (jax_dataset("mnist", n_clients=N_CLIENTS, scale=0.05, seed=0),
            make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                   seed=0))


def trace(engine):
    hist = [(l.round, l.t_start, l.t_end, l.accuracy, l.n_aggregated,
             l.n_stale) for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


def _close(port_tree, ref_tree, atol=ATOL, what=""):
    for name, leaf in port_tree.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_tree[name]),
                                   rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("engines", [(JaxScheduler, Scheduler),
                                     (JaxController, Controller)],
                         ids=["scheduler", "legacy"])
def test_scaffold_matches_reference(datasets, engines):
    jcls, cls = engines
    jdata, data = datasets
    kw = base_cfg_kw(strategy="scaffold", rounds=3)
    jmodel = JaxProxyCNN(10)
    ref = jcls(JaxFLConfig(**kw), jmodel, jdata, list(jax_fleet(N_CLIENTS)))
    m_ref = ref.run()
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))[0])
    port = cls(FLConfig(**kw), ProxyCNN(10), data,
               list(paper_fleet(N_CLIENTS)), device="cpu",
               init_params=params_from_numpy(init, "cpu"))
    port.trainer.batch_indices = JaxBatchIndices(kw["seed"], kw["batch_size"])
    m = port.run()
    assert m["rounds"] == 3 and m["strategy"] == "scaffold"
    assert trace(port) == jax_trace(ref)
    for key in ("total_time", "total_cost_usd", "invocation_counts"):
        assert m[key] == m_ref[key], key
    assert port.store._free == ref.store._free
    _close(port.params, ref.params, what="params")
    spec = port.spec
    assert port.c_global.shape == (port.store.row_width,)
    assert float(port.c_global.abs().max()) > 0
    _close(spec.unravel(port.c_global), ref.c_global, what="c_global")
    assert port.c_buf.shape[0] == ref._c_cap == N_CLIENTS
    for cid in range(N_CLIENTS):
        _close(spec.unravel(port.c_buf[cid]),
               {k: v[cid] for k, v in ref.c_buf.items()},
               atol=ATOL / port.cfg.lr, what=f"c_buf[{cid}]")


def test_port_controller_and_scheduler_are_bit_identical(datasets):
    _, data = datasets
    cfg = FLConfig(**base_cfg_kw(strategy="scaffold", rounds=3))
    runs = [cls(cfg, ProxyCNN(10), data, list(paper_fleet(N_CLIENTS)),
                device="cpu") for cls in (Controller, Scheduler)]
    for eng in runs:
        eng.run()
    legacy, sched = runs
    assert trace(sched) == trace(legacy)
    for name, leaf in sched.params.items():
        assert torch.equal(leaf, legacy.params[name]), name
    assert torch.equal(sched.c_global, legacy.c_global)
    assert torch.equal(sched.c_buf, legacy.c_buf)
    assert sched.metrics()["megastep_fallback_reason"] \
        == "strategy is not adapter-wrapped apodotiko-topk"


def test_cohort_step_variates_match_reference(datasets):
    """One cohort with nonzero variates through both trainers: the rows,
    the new variates and the losses, at a pad lane (K=3, Kp=4)."""
    jdata, data = datasets
    jmodel = JaxProxyCNN(10)
    jparams = jmodel.init(jax.random.PRNGKey(3))[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    spec = RavelSpec(params)
    selection = [4, 1, 2]
    n_i = jdata.n[selection]
    steps = np.array([3, 7, 5], np.int64)
    rng = np.random.default_rng(0)
    W = UpdateStore(spec.n_params, device="cpu").row_width
    cg_flat = np.zeros(W, np.float32)
    cg_flat[:spec.n_params] = rng.normal(0, 0.1, spec.n_params)
    ci_flat = np.zeros((3, W), np.float32)
    ci_flat[:, :spec.n_params] = rng.normal(0, 0.1, (3, spec.n_params))
    kw = dict(optimizer="adam", lr=1e-3, batch_size=5, seed=7)

    jcg = jax.tree.map(jnp.asarray, {k: v.numpy() for k, v in
                                     spec.unravel(torch.as_tensor(cg_flat))
                                     .items()})
    jci = {k: jnp.asarray(v.numpy()) for k, v in
           spec.unravel_stacked(torch.as_tensor(ci_flat)).items()}
    jt = JaxTrainer(jmodel, scaffold=True, **kw)
    jstore = JaxUpdateStore(spec.n_params, capacity=2)
    jids, jci_new, jloss = jt.train_cohort_indexed(
        jparams, JaxDatasetStore(jdata), selection, n_i, steps, jcg, jci,
        update_sink=jstore)

    t = CohortTrainer(ProxyCNN(10), device="cpu",
                      batch_indices=JaxBatchIndices(7, 5), **kw)
    store = UpdateStore(spec.n_params, capacity=2, device="cpu")
    ids, ci_new, loss = t.train_cohort_indexed(
        params, DatasetStore(data, device="cpu"), selection, n_i, steps,
        torch.as_tensor(cg_flat), torch.as_tensor(ci_flat),
        update_sink=store)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(store.gather(ids).numpy(),
                               np.asarray(jstore.gather(jids)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, np.asarray(jloss), rtol=RTOL, atol=ATOL)
    assert ci_new.shape == (3, W)
    assert not ci_new[:, spec.n_params:].any()       # pad columns stay 0
    _close(spec.unravel_stacked(ci_new), jci_new, atol=ATOL / kw["lr"],
           what="c_i'")


def test_without_scaffold_there_is_no_variate_state(datasets):
    _, data = datasets
    eng = Scheduler(FLConfig(**base_cfg_kw(strategy="fedavg")), ProxyCNN(10),
                    data, list(paper_fleet(N_CLIENTS)), device="cpu")
    assert eng.c_global is None and eng.c_buf is None
    assert build_strategy("scaffold", StrategyConfig()).needs_scaffold


def test_add_clients_grows_the_variate_buffer(datasets):
    _, data = datasets
    eng = Scheduler(FLConfig(**base_cfg_kw(strategy="scaffold", rounds=1)),
                    ProxyCNN(10), data, list(paper_fleet(N_CLIENTS)),
                    device="cpu")
    eng.run()
    before = eng.c_buf.clone()
    assert eng._c_cap == N_CLIENTS
    joined = []
    eng._emit = joined.append
    rec = ClientRecord(client_id=N_CLIENTS + 3, hardware="cpu1",
                       data_cardinality=20, batch_size=5, local_epochs=1)
    eng.add_clients([rec], [paper_fleet(1)[0]])
    assert eng._c_cap == 2 * N_CLIENTS               # amortized doubling
    assert eng.c_buf.shape == (2 * N_CLIENTS, eng.store.row_width)
    assert torch.equal(eng.c_buf[:N_CLIENTS], before)
    assert not eng.c_buf[N_CLIENTS:].any()
    assert eng.db.has_client(N_CLIENTS + 3)
    assert eng.fleet[-1] is eng.hw[N_CLIENTS + 3]
    assert [e.client_id for e in joined] == [N_CLIENTS + 3]


def test_remove_clients_zeroes_a_leavers_variates(datasets):
    _, data = datasets
    fleet = list(paper_fleet(N_CLIENTS))
    eng = Scheduler(FLConfig(**base_cfg_kw(strategy="scaffold", rounds=2)),
                    ProxyCNN(10), data, fleet, device="cpu")
    eng.run()
    trained = [c for c in range(N_CLIENTS) if eng.c_buf[c].any()]
    assert len(trained) >= 2
    leaver, stayer = trained[:2]
    keep = eng.c_buf[stayer].clone()
    hw_after = [eng.hw[c] for c in range(N_CLIENTS) if c != leaver]
    cost = eng.metrics()["total_cost_usd"]
    left = []
    eng._emit = left.append
    eng.remove_clients([leaver, N_CLIENTS + 50])     # the second is unknown
    assert not eng.c_buf[leaver].any()
    assert torch.equal(eng.c_buf[stayer], keep)
    assert not eng.db.has_client(leaver) and leaver not in eng.hw
    assert eng.fleet == hw_after and len(fleet) == N_CLIENTS - 1
    assert [e.client_id for e in left] == [leaver]
    # metrics still price the leaver's past invocations
    assert eng.metrics()["total_cost_usd"] == cost


def test_stacked_helpers_match_reference():
    rng = np.random.default_rng(0)
    buf = rng.normal(size=(6, 16)).astype(np.float32)
    idx = np.array([4, 0, 2])
    vals = rng.normal(size=(3, 16)).astype(np.float32)
    jtree = {"a": jnp.asarray(buf)}
    t = torch.as_tensor(buf.copy())
    np.testing.assert_array_equal(gather_stacked(t, idx).numpy(),
                                  np.asarray(jax_gather_stacked(jtree,
                                                                idx)["a"]))
    out = scatter_stacked_tree(t, idx, torch.as_tensor(vals))
    assert out is t
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jax_scatter(jtree, idx, {"a": vals})["a"]))
    grown = grow_stacked(t, 6, 11)
    np.testing.assert_array_equal(
        grown.numpy(), np.asarray(jax_grow_stacked({"a": jnp.asarray(
            t.numpy())}, 6, 11)["a"]))
    assert grow_stacked(t, 6, 6) is t
