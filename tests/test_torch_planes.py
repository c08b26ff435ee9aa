"""The port's equivalence oracles: the ``host`` data plane
(``CohortTrainer.train_cohort``: the cohort's arrays uploaded every
dispatch) and the ``blob`` update plane (trained models as host trees
through the database, reduced by ``core.aggregation.weighted_aggregate``).

Within the port: the host data plane is bit-identical to the device data
plane (trace, params, free list, generator), on both engines and with
SCAFFOLD, as the reference holds its planes (``tests/test_data_plane.py``);
the blob update plane gives the device plane's trace with params within
atol 1e-5 (the two routes sum the updates in other orders: pending order
against the store's row order; ``tests/test_update_plane.py``'s limit).

Against the reference: ``weighted_aggregate``
at the kernels' tolerance (rtol 1e-5 / atol 1e-6), and full runs on the
oracle planes with the trace, the byte counters (``update_host_bytes``,
``data_host_bytes``) and the accuracies equal, params within rtol 1e-4 /
atol 1e-5, from the reference's params with its draws replayed."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import aggregation as jagg
from repro_torch.core import aggregation
from repro_torch.core.client import CohortTrainer
from repro_torch.core.controller import Controller
from repro_torch.core.data_plane import DatasetStore, resolve_data_plane
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.services import FLConfig, resolve_update_plane
from repro_torch.core.update_store import UpdateStore
from repro_torch.faas.hardware import paper_fleet
from repro_torch.kernels.staleness_agg import staleness_agg
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import JaxBatchIndices, one_torch_thread  # noqa: F401
from test_torch_faults import (assert_no_leaks, assert_params_equal,  # noqa: F401
                               chaos_trace, datasets, jmodel,
                               run_against_reference)
from trace_harness import N_CLIENTS, base_cfg_kw

pytestmark = pytest.mark.usefixtures("one_torch_thread")
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6


def run_planes(kw, data, key, values, engine=Scheduler):
    """One port run per value of the plane setting ``key``."""
    runs = {}
    for v in values:
        eng = engine(FLConfig(**{**kw, key: v}), ProxyCNN(10), data,
                     list(paper_fleet(N_CLIENTS)), device="cpu")
        runs[v] = (eng, eng.run())
    return runs


def test_resolvers_read_no_environment(monkeypatch):
    monkeypatch.setenv("REPRO_UPDATE_PLANE", "blob")
    monkeypatch.setenv("REPRO_DATA_PLANE", "host")
    assert resolve_update_plane("auto") == resolve_update_plane(None) == \
        "device"
    assert resolve_data_plane("auto") == resolve_data_plane("") == "device"
    assert resolve_update_plane("blob") == "blob"
    assert resolve_data_plane("host") == "host"
    with pytest.raises(ValueError, match="unknown update plane"):
        resolve_update_plane("mongo")
    with pytest.raises(ValueError, match="unknown data plane"):
        resolve_data_plane("nfs")


# -------------------------------------------------------- host data plane
@pytest.mark.parametrize("engine, strategy", [
    (Scheduler, "fedavg"), (Scheduler, "apodotiko"), (Scheduler, "scaffold"),
    (Scheduler, "apodotiko-hedge"), (Controller, "apodotiko")])
def test_host_data_plane_is_bit_identical_to_device(datasets, engine,
                                                    strategy):
    data = datasets[1]
    runs = run_planes(base_cfg_kw(strategy=strategy, rounds=3), data,
                      "data_plane", ("device", "host"), engine)
    (dev, m_dev), (host, m_host) = runs["device"], runs["host"]
    assert chaos_trace(host) == chaos_trace(dev)
    assert m_host["total_time"] == m_dev["total_time"]
    assert_params_equal(dev.params, host.params)
    assert dev.store._free == host.store._free
    assert torch.equal(dev.trainer.generator.get_state(),
                       host.trainer.generator.get_state())
    if strategy == "scaffold":
        assert torch.equal(dev.c_global, host.c_global)
        assert torch.equal(dev.c_buf, host.c_buf)
    assert (m_dev["data_host_bytes"], m_host["data_resident_bytes"]) == (0, 0)
    assert m_host["data_host_bytes"] > 0 and m_dev["data_resident_bytes"] > 0
    assert host.dataset is None


def test_train_cohort_equals_train_cohort_indexed_with_replayed_draws(
        datasets):
    """One cohort through both entries with the reference's draws replayed
    (the ``batch_indices`` hook): rows, losses and the upload count."""
    data = datasets[1]
    model = ProxyCNN(10)
    params = model.init(torch.Generator().manual_seed(3))
    sel = [4, 1, 2]                          # K=3 -> Kp=4 (one pad lane)
    n_i, steps = data.n[sel], np.array([3, 7, 5], np.int64)
    out = []
    for host in (False, True):
        t = CohortTrainer(model, optimizer="adam", lr=1e-3, batch_size=5,
                          prox_mu=0.01, seed=7, device="cpu",
                          batch_indices=JaxBatchIndices(7, 5))
        store = UpdateStore(sum(p.numel() for p in params.values()),
                            capacity=2, device="cpu")
        if host:
            ids, _, loss = t.train_cohort(params, data.X[sel], data.y[sel],
                                          n_i, steps, update_sink=store)
            pad = np.concatenate([data.X[sel], data.X[sel][-1:]])
            ypad = np.concatenate([data.y[sel], data.y[sel][-1:]])
            assert t.data_h2d_bytes == pad.nbytes + ypad.nbytes
        else:
            ids, _, loss = t.train_cohort_indexed(
                params, DatasetStore(data, device="cpu"), sel, n_i, steps,
                update_sink=store)
            assert t.data_h2d_bytes == 0
        out.append((ids, store.gather(ids), loss, store._free))
    (a_ids, a_rows, a_loss, a_free), (b_ids, b_rows, b_loss, b_free) = out
    np.testing.assert_array_equal(a_ids, b_ids)
    assert torch.equal(a_rows, b_rows) and a_free == b_free
    np.testing.assert_array_equal(a_loss, b_loss)


# ------------------------------------------------------- blob update plane
@pytest.mark.parametrize("engine, strategy", [
    (Scheduler, "apodotiko"), (Scheduler, "scaffold"),
    (Controller, "apodotiko")])
def test_blob_plane_is_the_device_plane_within_atol(datasets, engine,
                                                    strategy):
    kw = base_cfg_kw(strategy=strategy, rounds=4, concurrency_ratio=0.5)
    runs = run_planes(kw, datasets[1], "update_plane", ("device", "blob"),
                      engine)
    (dev, m_dev), (blob, m_blob) = runs["device"], runs["blob"]
    assert chaos_trace(blob)[1:] == chaos_trace(dev)[1:]
    hd, hb = m_dev["history"], m_blob["history"]
    assert [h[:2] for h in hd] == [h[:2] for h in hb] and len(hd) >= 2
    np.testing.assert_allclose([h[2] for h in hd], [h[2] for h in hb],
                               atol=1e-5)
    for name, leaf in dev.params.items():
        np.testing.assert_allclose(blob.params[name].numpy(), leaf.numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert m_dev["update_host_bytes"] == 0 < m_blob["update_host_bytes"]
    assert blob.store is None and dev.store is not None
    for eng in (dev, blob):
        assert_no_leaks(eng)


def test_blob_plane_bytes_are_the_trees_both_ways(datasets):
    """Each trained update counts once on its way to the host, and once
    more for each aggregation it enters on its way back."""
    eng = Scheduler(FLConfig(**base_cfg_kw(strategy="fedavg", rounds=2,
                                           update_plane="blob")),
                    ProxyCNN(10), datasets[1], list(paper_fleet(N_CLIENTS)),
                    device="cpu")
    m = eng.run()
    per_update = 4 * eng.spec.n_params
    trained = m["n_invocations"]
    aggregated = sum(l.n_aggregated for l in eng.history)
    assert m["update_host_bytes"] == per_update * (trained + aggregated)


# ------------------------------------------------------------- aggregation
def _trees(rng, k, shapes):
    return [{name: rng.normal(size=s).astype(np.float32)
             for name, s in shapes.items()} for _ in range(k)]


@pytest.mark.parametrize("k", [1, 3, 8, 13])
def test_weighted_aggregate_equals_the_references(k):
    rng = np.random.default_rng(k)
    shapes = {"a": (33, 5), "b": (7,), "c": ()}
    ups = _trees(rng, k, shapes)
    w = jagg.staleness_weights(list(range(k)), list(rng.integers(1, 50, k)),
                               k)
    launches = staleness_agg.launches
    got = aggregation.weighted_aggregate(
        [{n: torch.as_tensor(x) for n, x in u.items()} for u in ups], w)
    assert staleness_agg.launches == launches     # plain version on the CPU
    want = jagg.weighted_aggregate(
        [{n: jnp.asarray(x) for n, x in u.items()} for u in ups], w)
    assert sorted(got) == sorted(want)
    for name in shapes:
        assert got[name].dtype == torch.float32
        assert tuple(got[name].shape) == shapes[name]
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    half = aggregation.weighted_aggregate(
        [{n: torch.as_tensor(x) for n, x in u.items()} for u in ups], w,
        out_dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())
    with pytest.raises(ValueError):
        aggregation.weighted_aggregate([], [])


# ------------------------------------------------------- runs vs reference
@pytest.mark.parametrize("planes", [
    dict(update_plane="blob"), dict(data_plane="host"),
    dict(update_plane="blob", data_plane="host")])
def test_oracle_planes_equal_the_references(datasets, jmodel, planes):
    port, m, m_ref = run_against_reference(
        datasets, jmodel, base_cfg_kw(strategy="apodotiko", rounds=3,
                                      **planes))
    assert (m["update_plane"], m["data_plane"]) == (
        planes.get("update_plane", "device"),
        planes.get("data_plane", "device"))
    assert (m["update_host_bytes"] > 0) == ("update_plane" in planes)
    assert (m["data_host_bytes"] > 0) == ("data_plane" in planes)
    assert_no_leaks(port)
