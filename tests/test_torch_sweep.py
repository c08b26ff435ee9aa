"""The port's sweep engine (``repro_torch.sweep``) against the reference's.

The jax-free tests of ``tests/test_sweep.py`` have twins here. Beyond
them: every preset and every cell's ``FLConfig`` equals the reference's
field for field; ``grid``, ``results`` and ``presets`` are the reference's
source apart from imports (and the presets' module docstring); one set of
metrics renders to byte-identical tables in both packages; and the
``smoke`` preset run through both ``run_sweep``s, the port's cells started
from the reference's params with its minibatch draws replayed
(``JaxBatchIndices``), gives the same table to the byte; and the
``chaos``, ``production_load`` and ``dataplane_ablation`` presets, cut to a
few rounds, give the reference's host columns in every cell."""
import copy
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import sweep as jsweep
from repro.models.proxy_models import build_bench_model as jax_bench_model
from repro_torch.core.scheduler import build_engine
from repro_torch.models.convert import params_from_numpy
from repro_torch.sweep import (PRESETS, SCHEMA, LocalRunner, ResultTable,
                               RunSpec, SweepScale, SweepSpec, expand_grid,
                               get_preset, run_sweep)
from test_torch_client_store import JaxBatchIndices, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the columns a run's host side decides (numpy RNG and simulated time); the
# rest follow the accuracies
HOST_COLUMNS = ("sweep", "dataset", "scenario", "strategy", "seed",
                "concurrency_ratio", "staleness_fn", "data_plane",
                "fault_profile", "traffic_profile", "rounds", "sim_time_s",
                "cold_starts", "cold_start_ratio",
                "cold_start_reduction_vs_fedavg", "cost_usd",
                "cost_vs_fedavg", "p50_round_latency_s",
                "p99_round_latency_s", "cost_per_round_usd", "n_invocations",
                "n_failures", "n_retries", "n_quarantined", "error")


def small_spec(**kw):
    base = dict(name="t", datasets=("mnist", "speech"),
                strategies=("fedavg", "fedbuff", "apodotiko"),
                seeds=(0, 1), scale=SweepScale(rounds=4))
    base.update(kw)
    return SweepSpec(**base)


class FakeRunner:
    """Deterministic canned metrics: apodotiko converges 2x faster than
    fedavg, fedbuff 1.25x; cold starts and cost scale the same way."""

    SPEED = {"fedavg": 1.0, "fedbuff": 1.25, "apodotiko": 2.0}

    def __init__(self, fail_on=()):
        self.calls = []
        self.fail_on = set(fail_on)

    def __call__(self, run) -> dict:
        self.calls.append(run.key)
        if run.strategy in self.fail_on:
            raise RuntimeError("boom")
        v = self.SPEED[run.strategy]
        hist = [(t * 100.0 / v, r, 0.1 * (t + 1)) for t, r in
                zip(range(8), range(8))]
        return {"strategy": run.strategy, "rounds": 8,
                "final_accuracy": 0.8, "history": hist,
                "total_time": 800.0 / v, "total_cost_usd": 4.0 / v,
                "cold_start_ratio": 0.4 / v, "n_invocations": 100}


def cpu_runner(scale, **kw):
    return LocalRunner(scale, device="cpu", **kw)


# ------------------------------------------------------------------- grid
def test_expand_grid_full_product_unique_keys():
    spec = small_spec()
    runs = expand_grid(spec)
    assert len(runs) == spec.n_runs == 2 * 3 * 2
    keys = [r.key for r in runs]
    assert len(set(keys)) == len(keys)


def test_expand_grid_deterministic():
    assert expand_grid(small_spec()) == expand_grid(small_spec())


def test_seeds_flow_into_cells_and_config():
    runs = expand_grid(small_spec(seeds=(7, 13)))
    assert sorted({r.seed for r in runs}) == [7, 13]
    runner = cpu_runner(SweepScale(n_clients=6, clients_per_round=3))
    run = next(r for r in runs if r.seed == 13 and r.strategy == "apodotiko")
    cfg = runner.config(run)
    assert cfg.seed == 13 and cfg.strategy == "apodotiko"
    assert cfg.n_clients == 6 and cfg.clients_per_round == 3
    assert runner.scale.data_seed == 0


def test_overrides_reach_flconfig():
    spec = small_spec(overrides=(("failure_rate", 0.1), ("local_epochs", 2)))
    run = expand_grid(spec)[0]
    cfg = cpu_runner(spec.scale).config(run)
    assert cfg.failure_rate == 0.1 and cfg.local_epochs == 2


def test_control_plane_axis_expands():
    spec = small_spec(strategies=("apodotiko",), datasets=("mnist",),
                      seeds=(0,), control_planes=("columnar", "object"))
    runs = expand_grid(spec)
    assert len(runs) == spec.n_runs == 2
    assert {r.control_plane for r in runs} == {"columnar", "object"}
    assert all("/ctl=" in r.key for r in runs)
    assert len({r.group for r in runs}) == 2
    cfg = cpu_runner(SweepScale(n_clients=6, clients_per_round=3)).config(
        runs[0])
    assert cfg.control_plane == runs[0].control_plane


def test_fault_profile_axis_expands():
    spec = small_spec(strategies=("apodotiko",), datasets=("mnist",),
                      seeds=(0,), fault_profiles=("none", "crash-heavy"))
    runs = expand_grid(spec)
    assert len(runs) == spec.n_runs == 2
    assert {r.fault_profile for r in runs} == {"none", "crash-heavy"}
    assert all("/faults=" in r.key for r in runs)
    assert len({r.group for r in runs}) == 2
    cfg = cpu_runner(SweepScale(n_clients=6, clients_per_round=3)).config(
        runs[1])
    assert cfg.fault_profile == "crash-heavy"
    assert "/faults=" not in expand_grid(small_spec())[0].key


# ------------------------------------------------------------------ table
def test_result_table_schema_and_speedups():
    spec = small_spec(seeds=(0,))
    table = run_sweep(spec, runner=FakeRunner())
    assert len(table.rows) == spec.n_runs
    for row in table.rows:
        assert set(row) == set(SCHEMA)
        assert row["error"] is None
    for row in table.rows:
        if row["strategy"] == "fedavg":
            assert row["speedup_vs_fedavg"] == pytest.approx(1.0)
            assert row["cost_vs_fedavg"] == pytest.approx(1.0)
        if row["strategy"] == "apodotiko":
            assert row["speedup_vs_fedavg"] == pytest.approx(2.0, rel=0.01)
            assert row["cold_start_reduction_vs_fedavg"] == pytest.approx(
                2.0, rel=0.01)
    assert table.mean_speedup("fedbuff") == pytest.approx(1.25, rel=0.01)


def test_concurrent_matches_serial():
    spec = small_spec()
    serial = run_sweep(spec, runner=FakeRunner(), max_workers=1)
    threaded = run_sweep(spec, runner=FakeRunner(), max_workers=4)
    assert serial.rows == threaded.rows


def test_empty_history_run_does_not_poison_target():
    class EmptyHistoryRunner(FakeRunner):
        def __call__(self, run):
            m = super().__call__(run)
            if run.strategy == "fedbuff":
                m["history"] = []
                m["rounds"] = 0
            return m

    table = run_sweep(small_spec(seeds=(0,)), runner=EmptyHistoryRunner())
    by_strat = {r["strategy"]: r for r in table.rows
                if r["dataset"] == "mnist"}
    assert by_strat["fedavg"]["target_acc"] > 0
    assert by_strat["fedbuff"]["time_to_target_s"] is None
    assert by_strat["fedbuff"]["speedup_vs_fedavg"] is None
    assert by_strat["apodotiko"]["speedup_vs_fedavg"] == pytest.approx(
        2.0, rel=0.01)


def test_failed_cell_keeps_row():
    table = run_sweep(small_spec(seeds=(0,)),
                      runner=FakeRunner(fail_on={"fedbuff"}))
    bad = [r for r in table.rows if r["strategy"] == "fedbuff"]
    good = [r for r in table.rows if r["strategy"] != "fedbuff"]
    assert all("boom" in r["error"] for r in bad)
    assert all(r["time_to_target_s"] is None for r in bad)
    assert all(r["error"] is None for r in good)


def test_renderers():
    table = run_sweep(small_spec(seeds=(0,)), runner=FakeRunner())
    md = table.to_markdown(columns=("dataset", "strategy",
                                    "speedup_vs_fedavg"))
    assert "apodotiko" in md and md.count("\n") == len(table.rows) + 2
    lines = table.to_csv().strip().split("\n")
    assert lines[0].split(",") == list(SCHEMA)
    assert len(lines) == len(table.rows) + 1
    assert len(table.select(dataset="mnist", strategy="apodotiko").rows) == 1


def test_the_same_metrics_render_byte_identical_in_both_packages():
    """``ResultTable.from_runs`` over one list of metrics (a failed cell
    among them) gives the reference's markdown and CSV to the byte."""
    spec = small_spec()
    runs, jruns = expand_grid(spec), jsweep.expand_grid(
        jsweep.SweepSpec(**dataclasses.asdict(spec)
                         | {"scale": jsweep.SweepScale(rounds=4)}))
    assert [r.key for r in runs] == [r.key for r in jruns]
    fake = FakeRunner(fail_on={"fedbuff"})
    metrics = []
    for r in runs:
        try:
            metrics.append(fake(r))
        except RuntimeError as e:
            metrics.append({"error": f"RuntimeError: {e}"})
    mine = ResultTable.from_runs("t", runs, metrics)
    ref = jsweep.ResultTable.from_runs("t", jruns, metrics)
    assert mine.to_markdown() == ref.to_markdown()
    assert mine.to_csv() == ref.to_csv()
    assert mine.rows == ref.rows


def test_presets_registry():
    assert "paper_mnist" in PRESETS and "paper_tables" in PRESETS
    assert len(get_preset("paper_mnist").strategies) == 6
    with pytest.raises(KeyError, match="unknown sweep preset"):
        get_preset("nope")


def test_preset_specs_are_immutable():
    spec = get_preset("smoke")
    with pytest.raises(Exception):
        spec.name = "hacked"
    assert copy.deepcopy(spec) == spec


@pytest.mark.parametrize("full", [False, True])
def test_every_preset_equals_the_reference_field_for_field(monkeypatch,
                                                           full):
    if full:
        monkeypatch.setenv("SWEEP_FULL", "1")
    assert set(PRESETS) == set(jsweep.PRESETS)
    for name in PRESETS:
        assert dataclasses.asdict(get_preset(name)) == \
            dataclasses.asdict(jsweep.get_preset(name)), name


def test_every_cells_config_equals_the_reference_runners():
    """For every cell of every preset, the port runner's ``FLConfig`` has
    the reference runner's value in every field both configs have."""
    for name in PRESETS:
        spec = get_preset(name)
        port, ref = cpu_runner(spec.scale), jsweep.LocalRunner(
            jsweep.get_preset(name).scale)
        for run, jrun in zip(expand_grid(spec),
                             jsweep.expand_grid(jsweep.get_preset(name))):
            a = dataclasses.asdict(port.config(run))
            b = dataclasses.asdict(ref.config(jrun))
            shared = a.keys() & b.keys()
            assert len(shared) > 40
            assert {k: a[k] for k in shared} == {k: b[k] for k in shared}, \
                run.key


def _code(path: Path, drop_docstring: bool = False) -> str:
    """The module's source with ``repro_torch`` read as ``repro`` in its
    import lines (and re-wrapped continuation lines joined)."""
    src = path.read_text()
    if drop_docstring:
        src = src.split('"""', 2)[2]
    src = re.sub(r"^(from|import) repro_torch\.", r"\1 repro.", src,
                 flags=re.M)
    return re.sub(r",\n\s+", ", ", src)


@pytest.mark.parametrize("name", ["grid", "results", "presets"])
def test_grid_results_presets_are_the_references_source(name):
    mine = ROOT / "src" / "repro_torch" / "sweep" / f"{name}.py"
    ref = ROOT / "src" / "repro" / "sweep" / f"{name}.py"
    drop = name == "presets"
    assert _code(mine, drop) == _code(ref, drop)


# ------------------------------------------------------------ end-to-end
def test_tiny_real_sweep_end_to_end():
    spec = SweepSpec(name="e2e", datasets=("mnist",),
                     strategies=("fedavg", "apodotiko"),
                     scale=SweepScale(n_clients=6, clients_per_round=3,
                                      rounds=3, data_scale=0.05,
                                      local_epochs=1, sim_budget=300.0,
                                      eval_every=1))
    table = run_sweep(spec, max_workers=2, device="cpu")
    assert [r["strategy"] for r in table.rows] == ["fedavg", "apodotiko"]
    for row in table.rows:
        assert row["error"] is None
        assert row["rounds"] >= 1
        assert row["sim_time_s"] > 0
        assert 0.0 <= row["final_acc"] <= 1.0
        assert row["cost_usd"] > 0
        assert row["n_invocations"] >= 3
    assert table.rows[0]["speedup_vs_fedavg"] == pytest.approx(1.0)


def test_local_runner_shares_setup_and_takes_the_card_by_default(
        monkeypatch):
    scale = SweepScale(n_clients=6, clients_per_round=3, rounds=2,
                       data_scale=0.05, local_epochs=1)
    runner = cpu_runner(scale)
    runs = expand_grid(SweepSpec(name="s", datasets=("mnist",),
                                 strategies=("fedavg", "apodotiko"),
                                 scale=scale))
    runner.warm(runs)
    assert runner.data("mnist") is runner.data("mnist")
    assert runner.model("mnist") is runner.model("mnist")
    assert runner.fleet("heterogeneous") is runner.fleet("heterogeneous")
    eng = runner.engine(runs[0])                 # built, not run
    assert eng.device.type == "cpu" and eng.history == []
    assert eng.cfg == runner.config(runs[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalRunner(scale)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sweep(get_preset("smoke"))


def test_result_cache_keys_the_device(tmp_path):
    """A card run and a CPU run of one cell draw their minibatches from
    different generators, so the cache keeps them apart."""
    scale = SweepScale(n_clients=6, clients_per_round=3, rounds=1,
                       data_scale=0.05, local_epochs=1)
    run = expand_grid(SweepSpec(name="c", strategies=("fedavg",),
                                scale=scale))[0]
    runner = cpu_runner(scale, cache_dir=str(tmp_path))
    first = runner(run)
    assert len(list(tmp_path.iterdir())) == 1
    # read back from the cache (JSON: the history's tuples come back lists)
    assert runner(run) == json.loads(json.dumps(first))
    cpu_path = runner._cache_path(run)
    runner.device = torch.device("cuda")
    assert runner._cache_path(run) != cpu_path


class ReplayRunner(LocalRunner):
    """Starts each cell from the reference's params (its engine's
    ``model.init(PRNGKey(cfg.seed))``) and replays the reference trainer's
    minibatch draws."""

    def engine(self, run):
        cfg = self.config(run)
        init = jax.tree.map(np.asarray, jax_bench_model(run.dataset).init(
            jax.random.PRNGKey(cfg.seed))[0])
        eng = build_engine(cfg, self.model(run.dataset),
                           self.data(run.dataset),
                           list(self.fleet(run.scenario)), device=self.device,
                           init_params=params_from_numpy(init, self.device))
        eng.trainer.batch_indices = JaxBatchIndices(cfg.seed, cfg.batch_size)
        return eng


def test_smoke_preset_equals_the_references_table():
    spec, jspec = get_preset("smoke"), jsweep.get_preset("smoke")
    ref = jsweep.run_sweep(jspec)
    mine = run_sweep(spec, runner=ReplayRunner(spec.scale, device="cpu"))
    assert all(r["error"] is None for r in mine.rows)
    for a, b in zip(mine.rows, ref.rows):
        assert {c: a[c] for c in HOST_COLUMNS} == \
            {c: b[c] for c in HOST_COLUMNS}
    assert mine.to_markdown() == ref.to_markdown()


def test_smoke_table_is_byte_identical_for_one_and_two_workers():
    spec = get_preset("smoke")
    serial = run_sweep(spec, device="cpu", max_workers=1)
    pair = run_sweep(spec, device="cpu", max_workers=2)
    assert serial.to_markdown() == pair.to_markdown()
    assert serial.rows == pair.rows


# the three presets of the profiles and planes slice, each at its own
# scale cut to 3 rounds (production_load to 5: its flash crowd lands at
# 60 s of simulated time), on one shared seed
SLICE_PRESETS = {
    "chaos": SweepScale(n_clients=8, clients_per_round=4, rounds=3,
                        data_scale=0.06, local_epochs=1, sim_budget=400.0),
    "production_load": SweepScale(n_clients=8, clients_per_round=4,
                                  rounds=5, data_scale=0.06, local_epochs=1,
                                  sim_budget=900.0),
    "dataplane_ablation": SweepScale(n_clients=8, clients_per_round=4,
                                     rounds=3, data_scale=0.06,
                                     local_epochs=1, sim_budget=400.0),
}


@pytest.mark.parametrize("name", sorted(SLICE_PRESETS))
def test_profile_and_plane_tables_equal_the_references_host_columns(name):
    """Every cell of ``chaos`` (fault profiles, recovery armed),
    ``production_load`` (traffic profiles) and ``dataplane_ablation``
    (device and host data planes) runs in the port, and its host columns
    equal the reference's run of the same cells."""
    spec = dataclasses.replace(get_preset(name), scale=SLICE_PRESETS[name])
    jspec = dataclasses.replace(jsweep.get_preset(name),
                                scale=jsweep.SweepScale(
                                    **dataclasses.asdict(spec.scale)))
    mine = run_sweep(spec, device="cpu")
    ref = jsweep.run_sweep(jspec)
    assert len(mine.rows) == len(ref.rows) == spec.n_runs
    for a, b in zip(mine.rows, ref.rows):
        assert a["error"] is None and a["rounds"] > 0
        assert {c: a[c] for c in HOST_COLUMNS} == \
            {c: b[c] for c in HOST_COLUMNS}
    axis = {"chaos": "fault_profile", "production_load": "traffic_profile",
            "dataplane_ablation": "data_plane"}[name]
    assert len({r[axis] for r in mine.rows}) > 1
