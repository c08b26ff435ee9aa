"""Federated LM training (``examples/train_fl_lm.py``'s setup) on the port
against the reference.

Both ``Controller``s federate the same qwen3-family decoder (the smoke
config with a 256-token vocabulary) over the same Markov token streams,
the port started from the reference's params with the reference's
minibatch draws replayed (``JaxBatchIndices``). At 6 clients
(``clients_per_round = max(4, 6 // 3)`` = 4) and 2 rounds: the host trace
(selections, invocation records, round boundaries, simulated clock, cost,
cold starts) and the update store's free list identical, the token
accuracies the reference's (fp32, summed per batch in float64 as it does),
the global params within rtol 1e-4 / atol 1e-5. The cohort trainer and its
list-bearing params (``layers.first == []``) and the token data with ``-1``
padding rows run through ``RavelSpec``, ``DatasetStore`` and the vmapped
step as the paper models' do."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as jax_get_config
from repro.core.controller import Controller as JaxController
from repro.core.controller import FLConfig as JaxFLConfig
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.models.api import LMClientAdapter as JaxLMClientAdapter
from repro_torch.core.client import CohortTrainer
from repro_torch.core.controller import Controller
from repro_torch.core.data_plane import DatasetStore
from repro_torch.faas.hardware import paper_fleet
from repro_torch.kernels.ops import RavelSpec, tree_leaves
from repro_torch.models.api import LMClientAdapter
from repro_torch.models.convert import params_from_numpy
from test_torch_client_store import JaxBatchIndices, one_torch_thread  # noqa: F401
from test_torch_controller import host_trace

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
N_CLIENTS, ROUNDS = 6, 2
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    """The reference's and the port's run of the example's setup."""
    ref_ex, port_ex = _example("train_fl_lm"), _example("torch_train_fl_lm")
    jcfg = jax_get_config("qwen3-1.7b", smoke=True).with_(vocab_size=256)
    cfg = port_ex.lm_config("qwen3-1.7b", full=False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jdata = ref_ex.make_lm_federated_data(N_CLIENTS, 256, seq_len=32,
                                          samples_per_client=24)
    data = port_ex.make_lm_federated_data(N_CLIENTS, 256, seq_len=32,
                                          samples_per_client=24)
    for f in ("X", "y", "n", "eval_x", "eval_y"):
        np.testing.assert_array_equal(getattr(data, f), getattr(jdata, f))
    fl = port_ex.fl_config(N_CLIENTS, ROUNDS)
    jfl = JaxFLConfig(
        n_clients=N_CLIENTS, clients_per_round=max(4, N_CLIENTS // 3),
        rounds=ROUNDS, strategy="apodotiko", concurrency_ratio=0.5,
        local_epochs=1, batch_size=4, optimizer="adam", lr=3e-4,
        base_step_time=2.0, seed=0)
    assert fl.clients_per_round == jfl.clients_per_round == 4

    jmodel = JaxLMClientAdapter(jcfg)
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))[0])
    ref = JaxController(jfl, jmodel, jdata, list(jax_fleet(N_CLIENTS)))
    m_ref = ref.run()
    port = Controller(fl, LMClientAdapter(cfg), data,
                      list(paper_fleet(N_CLIENTS)), device="cpu",
                      init_params=params_from_numpy(init, "cpu"))
    port.trainer.batch_indices = JaxBatchIndices(fl.seed, fl.batch_size)
    m = port.run()
    return port, m, ref, m_ref


def test_host_trace_and_counters_equal_the_reference(runs):
    port, m, ref, m_ref = runs
    assert m["rounds"] == m_ref["rounds"] == ROUNDS
    assert host_trace(port) == host_trace(ref)
    for key in ("total_time", "total_cost_usd", "cold_start_ratio",
                "n_invocations", "invocation_counts"):
        assert m[key] == m_ref[key], key
    assert port.store._free == ref.store._free


def test_token_accuracies_equal_the_reference(runs):
    port, m, ref, m_ref = runs
    assert ([l.accuracy for l in port.history]
            == [float(l.accuracy) for l in ref.history])
    assert m["final_accuracy"] == float(m_ref["final_accuracy"])


def test_global_params_match_the_reference(runs):
    port, _, ref, _ = runs
    assert port.params["layers"]["first"] == []
    want = jax.tree.leaves(ref.params)
    got = tree_leaves(port.params)
    assert len(got) == len(want) == 13
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_one_lm_cohort_trains_as_the_reference_trainer():
    """One cohort of 3 clients (padded to 4 lanes) through the port's
    ``CohortTrainer`` against the reference's ``CohortTrainer``, from the
    same params on the same draws, with SGD: trained rows and mean losses
    within rtol 1e-4 / atol 1e-5. SGD's step is linear in the grads, so
    the rows hold the grads' tolerance. Under Adam a single cohort's
    element whose gradient sits at fp32's rounding floor takes a step of
    about lr whatever its sign, and one of 49,152 elements strayed 3.2e-5
    here; Adam's lanes are held by the ``Controller`` run above."""
    from repro.core.client import CohortTrainer as JaxTrainer
    from repro.core.data_plane import DatasetStore as JaxDatasetStore

    ex = _example("torch_train_fl_lm")
    cfg = ex.lm_config("qwen3-1.7b", full=False)
    data = ex.make_lm_federated_data(4, 256, seq_len=16,
                                     samples_per_client=8)
    assert (data.y == -1).any()
    jmodel = JaxLMClientAdapter(jax_get_config("qwen3-1.7b", smoke=True)
                                .with_(vocab_size=256))
    jparams = jmodel.init(jax.random.PRNGKey(1))[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    sel, steps = np.array([2, 0, 3]), np.array([2, 1, 3])
    n_i = data.n[sel]

    jtr = JaxTrainer(jmodel, optimizer="sgd", lr=0.1, batch_size=4, seed=0)
    jstacked, _, jloss = jtr.train_cohort_indexed(
        jparams, JaxDatasetStore(data), sel, n_i, steps)
    tr = CohortTrainer(LMClientAdapter(cfg), optimizer="sgd", lr=0.1,
                       batch_size=4, seed=0, device="cpu",
                       batch_indices=JaxBatchIndices(0, 4))
    stacked, _, loss = tr.train_cohort_indexed(
        params, DatasetStore(data, device="cpu"), sel, n_i, steps)
    np.testing.assert_allclose(loss, np.asarray(jloss), rtol=RTOL, atol=ATOL)
    spec = RavelSpec(params)
    assert spec.n_params == sum(int(np.prod(a.shape))
                                for a in jax.tree.leaves(jparams))
    for a, b in zip(tree_leaves(stacked), jax.tree.leaves(jstacked)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    assert all(torch.isfinite(a).all() for a in tree_leaves(stacked))


def test_build_engine_runs_the_lm_client_as_the_controller():
    """The LM client through ``build_engine`` (the event-driven Scheduler,
    the main path's engine) against the ``Controller`` poll loop, from one
    set of params on the CPU: host trace and accuracies identical, params
    equal to the bit."""
    from repro_torch.core.scheduler import build_engine

    ex = _example("torch_train_fl_lm")
    cfg = ex.lm_config("qwen3-1.7b", full=False)
    data = ex.make_lm_federated_data(N_CLIENTS, 256, seq_len=32,
                                     samples_per_client=24)
    init = LMClientAdapter(cfg).init(torch.Generator().manual_seed(3))
    engines = [
        make(ex.fl_config(N_CLIENTS, ROUNDS), LMClientAdapter(cfg), data,
             list(paper_fleet(N_CLIENTS)), device="cpu", init_params=init)
        for make in (Controller, build_engine)]
    for eng in engines:
        eng.run()
    ctl, sched = engines
    assert type(sched).__name__ == "Scheduler"
    assert host_trace(sched) == host_trace(ctl)
    assert [l.accuracy for l in sched.history] == \
        [l.accuracy for l in ctl.history]
    for a, b in zip(tree_leaves(sched.params), tree_leaves(ctl.params)):
        assert torch.equal(a, b)
