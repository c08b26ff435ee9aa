"""Full port ``Controller`` runs vs the reference's ``Controller``.

Both start from the reference-initialized params on the same numpy
dataset. The host trace (selections, invocation records, round
boundaries, simulated clock, cost, cold starts) depends only on numpy RNG
and must be identical. With the reference's minibatch draws replayed
(``JaxBatchIndices``) the final params agree at rtol 1e-4 / atol 1e-5 and
the accuracies match."""
import numpy as np
import pytest

import jax

from repro.core.controller import Controller as JaxController
from repro.core.controller import FLConfig as JaxFLConfig
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch.core import aggregation
from repro_torch.core.controller import Controller, FLConfig
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import JaxBatchIndices
from trace_harness import N_CLIENTS, base_cfg_kw

RTOL, ATOL = 1e-4, 1e-5


def host_trace(engine):
    """The reference harness's ``trace`` minus the accuracy column."""
    hist = [(l.round, l.t_start, l.t_end, l.n_aggregated, l.n_stale)
            for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


def _run_both(kw):
    """The reference and the port Controller on the same data and params."""
    jdata = jax_dataset("mnist", n_clients=N_CLIENTS, scale=0.05, seed=0)
    data = make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)
    for f in ("X", "y", "n", "eval_x", "eval_y"):
        np.testing.assert_array_equal(getattr(data, f), getattr(jdata, f))

    jmodel = JaxProxyCNN(10)
    ref = JaxController(JaxFLConfig(**kw), jmodel, jdata,
                        list(jax_fleet(N_CLIENTS)))
    m_ref = ref.run()
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))[0])
    port = Controller(FLConfig(**kw), ProxyCNN(10), data,
                      list(paper_fleet(N_CLIENTS)), device="cpu",
                      init_params=params_from_numpy(init, "cpu"))
    port.trainer.batch_indices = JaxBatchIndices(kw["seed"], kw["batch_size"])
    m = port.run()
    return port, m, ref, m_ref, data


@pytest.mark.parametrize("strategy", ["fedavg", "apodotiko"])
def test_controller_matches_reference(strategy):
    port, m, ref, m_ref, _ = _run_both(
        base_cfg_kw(strategy=strategy, rounds=3))
    assert m["rounds"] == m_ref["rounds"] == 3
    assert host_trace(port) == host_trace(ref)
    for key in ("total_time", "total_cost_usd", "cold_start_ratio",
                "n_invocations", "invocation_counts"):
        assert m[key] == m_ref[key], key
    assert port.store._free == ref.store._free
    assert aggregation.last_path() == "sweep"
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref.params[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # exactly the reference's fp32 accuracies, as plain floats
    assert ([l.accuracy for l in port.history]
            == [float(l.accuracy) for l in ref.history])
    assert m["final_accuracy"] == float(m_ref["final_accuracy"])


def test_controller_matches_reference_with_failed_invocations():
    """Crashed invocations free their rows and mark the client failed, as
    in the reference: same trace, same free list, same params."""
    port, m, ref, m_ref, _ = _run_both(
        base_cfg_kw(strategy="apodotiko", rounds=3, failure_rate=0.3))
    assert m["n_failures"] == m_ref["n_failures"] > 0
    assert host_trace(port) == host_trace(ref)
    assert port.store._free == ref.store._free
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref.params[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
