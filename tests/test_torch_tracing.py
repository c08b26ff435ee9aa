"""The port's span recorder (``repro_torch.tracing``) and the local-training
loop's lane-step counters (``CohortTrainer``, ``FLRuntime.metrics()``).

Tracing is off by default and then records nothing and allocates nothing
at a span site; on, it changes no value, so a traced run's params and
history equal an untraced run's to the bit. The traced spans form a tree
(each child inside its parent, every local step inside a cohort), and the
counters count what the loop ran against what the lanes' budgets asked.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.client import CohortTrainer
from repro_torch.core.scheduler import build_engine
from repro_torch.core.services import FLConfig
from repro_torch.core.update_store import _round_up
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import paper_fleet
from repro_torch.kernels.ops import BLOCK_N, RavelSpec
from repro_torch.models.proxy_models import build_bench_model
from repro_torch.sharding import flmesh
from test_torch_client_store import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_CLIENTS = 10
COUNTERS = ("local_steps", "lane_steps_run", "lane_steps_useful",
            "lane_steps_pad")
# 3 clients a round pad every cohort to 4 lanes
KW = dict(n_clients=N_CLIENTS, clients_per_round=3, rounds=2, local_epochs=1,
          batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0,
          strategy="apodotiko")


@pytest.fixture(scope="module")
def data():
    return make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    tracing.stop()
    yield
    tracing.stop()


def _run(data, traced: bool, **over):
    eng = build_engine(FLConfig(**{**KW, **over}), build_bench_model("mnist"),
                       data, list(paper_fleet(N_CLIENTS)), device="cpu")
    if traced:
        tracing.start()
    m = eng.run()
    return eng, m, tracing.stop()


def test_off_records_nothing_and_a_traced_run_is_bit_equal(data):
    """(a) Off, a run records no span; on, the run's params, history and
    generator are the untraced run's to the bit."""
    off, m_off, spans_off = _run(data, traced=False)
    assert spans_off == []
    on, m_on, spans_on = _run(data, traced=True)
    assert spans_on
    assert m_on["history"] == m_off["history"]
    for name, leaf in off.params.items():
        assert torch.equal(leaf.view(torch.int32),
                           on.params[name].view(torch.int32)), name
    assert torch.equal(off.trainer.generator.get_state(),
                       on.trainer.generator.get_state())
    assert {k: m_on[k] for k in COUNTERS} == {k: m_off[k] for k in COUNTERS}


def test_the_traced_span_tree_is_well_formed(data):
    """(b) Each child lies inside its parent and carries its round; every
    ``step`` is a cohort's child with ``step.grad`` then ``step.opt``
    inside it; the ``step`` spans number the ``local_steps`` counted."""
    eng, m, spans = _run(data, traced=True)
    names = {s.name for s in spans}
    assert {"round", "selection", "cohort", "cohort.draw", "step",
            "step.grad", "step.opt", "cohort.wait", "cohort.land",
            "aggregation", "evaluation", "evaluation.wait"} <= names
    for s in spans:
        assert s.start_ns <= s.end_ns, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
            assert s.round == p.round
    rounds = [s for s in spans if s.name == "round"]
    assert [s.round for s in rounds] == list(range(KW["rounds"]))
    assert all(s.round is not None for s in spans)
    steps = [i for i, s in enumerate(spans) if s.name == "step"]
    assert all(spans[spans[i].parent].name == "cohort" for i in steps)
    for i in steps:
        kids = [s.name for s in spans if s.parent == i]
        assert kids == ["step.grad", "step.opt"]
    assert len(steps) == m["local_steps"] > 0


def test_span_off_is_the_shared_no_op():
    """(d) Off, ``span`` hands back one shared object for every name and
    ``begin`` no token."""
    a, b = tracing.span("step"), tracing.span("cohort")
    assert a is b
    with a as inside:
        assert inside is None
    assert tracing.begin("round", round=3) is None
    tracing.end(None)
    assert tracing.stop() == []


def test_begin_and_end_nest_across_calls():
    """The round's explicit begin and end, a span timed by its caller
    (``at=``) inside it, and a token from a stopped session, which the
    next session ignores."""
    tracing.start()
    tok = tracing.begin("round", round=7)
    with tracing.span("cohort"):
        tracing.end(tracing.begin("mesh.collective", at=5), at=6)
    tracing.end(tok)
    stale = tracing.begin("round", round=8)
    first = tracing.stop()
    assert [(s.name, s.parent, s.round) for s in first] == [
        ("round", -1, 7), ("cohort", 0, 7), ("mesh.collective", 1, 7),
        ("round", -1, 8)]
    assert first[2][1:3] == (5, 6)
    assert first[-1].end_ns >= first[-1].start_ns      # ended at stop()
    tracing.start()
    tracing.end(stale)
    with tracing.span("step"):
        pass
    assert [(s.name, s.parent, s.round) for s in tracing.stop()] == [
        ("step", -1, None)]


def _cohort_trainer():
    model = build_bench_model("mnist")
    trainer = CohortTrainer(model, optimizer="adam", lr=1e-3, batch_size=2,
                            device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    store = SimpleNamespace(X=torch.randn(3, 12, 8, 8, 1),
                            y=torch.randint(0, 10, (3, 12)))
    return trainer, params, store


def test_lane_step_counters_on_a_hand_built_cohort():
    """(c) Budgets [1, 3, 5] pad to 4 lanes and run 5 steps: 20 lane-steps
    run, 9 useful, 5 on the pad lane (the other 6 past a lane's budget)."""
    trainer, params, store = _cohort_trainer()
    trainer.train_cohort_indexed(params, store, [0, 1, 2],
                                 np.array([12, 12, 12]), np.array([1, 3, 5]))
    assert [getattr(trainer, k) for k in COUNTERS] == [5, 20, 9, 5]


def test_fused_cohort_counts_local_steps_alone():
    """``train_cohort_rows`` has its budgets on the card: it counts its
    loop's iterations and leaves the three lane-step counters, which then
    cover the host-side entries' cohorts alone."""
    trainer, params, store = _cohort_trainer()
    W = _round_up(RavelSpec(params).n_params, BLOCK_N)
    trainer.train_cohort_rows(
        params, store, torch.tensor([0, 1, 2, 2]),
        torch.tensor([12, 12, 12, 12]),
        torch.tensor([1, 3, 5, 0], dtype=torch.int32),
        torch.zeros((4, W)), torch.arange(4))
    assert [getattr(trainer, k) for k in COUNTERS] == [5, 0, 0, 0]


def test_counters_add_up_over_a_run(data):
    """Each cohort pads 3 lanes to 4: run is useful plus pad (every real
    lane's budget is the same), and ``metrics()`` reports the trainer's
    counters."""
    eng, m, _ = _run(data, traced=False)
    tr = eng.trainer
    assert [m[k] for k in COUNTERS] == [getattr(tr, k) for k in COUNTERS]
    assert m["lane_steps_run"] == 4 * m["local_steps"]
    assert m["lane_steps_pad"] == m["local_steps"]
    assert m["lane_steps_run"] == m["lane_steps_useful"] + m["lane_steps_pad"]


def test_snapshot_spans_time_snapshot_s(data, tmp_path):
    """A durable run's ``snapshot`` spans are ``snapshot_s``'s own clock
    reads, with the gather and the write inside them."""
    _, m, spans = _run(data, traced=True, durability="journal",
                       checkpoint_dir=str(tmp_path))
    snaps = [i for i, s in enumerate(spans) if s.name == "snapshot"]
    assert len(snaps) == m["n_snapshots"] == KW["rounds"]
    total = sum(spans[i].end_ns - spans[i].start_ns for i in snaps) / 1e9
    assert total == pytest.approx(m["snapshot_s"], rel=1e-12)
    for i in snaps:
        kids = [s.name for s in spans if s.parent == i]
        assert kids == ["snapshot.gather", "snapshot.write"]


def test_mesh_collective_span_is_collective_s():
    """A collective's timer records its interval as a ``mesh.collective``
    span of the same length as the seconds it adds to ``collective_s``."""
    mesh = SimpleNamespace(collective_s=0.0, n_collectives=0)
    tracing.start()
    with flmesh._timed(mesh):
        pass
    (s,) = tracing.stop()
    assert s.name == "mesh.collective" and mesh.n_collectives == 1
    assert (s.end_ns - s.start_ns) / 1e9 == mesh.collective_s
