"""The port's FL mesh plane on a CPU process group of 6 ranks (``2x3``,
gloo), against the reference's 1x1 runs.

One group runs for the module (``tests/torch_mesh_worker.py``, a
``file://`` rendezvous in a temporary folder), each rank writing one
record; the tests below assert on the records. The mesh is asymmetric, so
a swapped axis shows. The reference's own multi-device test fails under
jax 0.9.0, so the port is held to the reference's 1x1 path:

  * the sharded store's ids, free list and capacity equal the reference's
    ``UpdateStore``'s, ``gather`` its rows to the bit, through a growth;
  * the psum aggregate within 1e-5 of the reference's
    ``weighted_aggregate_rows(mesh=None)``; a NaN in a freed row takes the
    finiteness guard's recompute on every rank;
  * ``apodotiko-topk`` (5 rounds, K = 4, the reference test's config) and
    SCAFFOLD (2 rounds), with the reference's minibatch draws replayed:
    host traces equal the reference's 1x1 Scheduler's, params within rtol
    1e-4 / atol 1e-5;
  * fused against stepwise at ``2x3``, K = 4 and K = 3 (pad lanes),
    bit-equal with at least one fused round;
  * every rank's params equal rank 0's, bit for bit;
  * ``fl_round``'s ``scatter_bf16`` cell: within one bf16 ulp of the
    exact sum rounded through bf16, one at each rank's partial, plus the
    fp32 summation's bound.

The draws: the test runs the port at 1x1 with ``JaxBatchIndices`` and
records every index table it hands out; the ranks replay them in order
(the 2x3 run draws the same tables: the data axis of 2 leaves every
cohort bucket as at 1x1).
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.core.aggregation import weighted_aggregate_rows as jax_agg_rows
from repro.core.scheduler import Scheduler as JaxScheduler
from repro.core.services import FLConfig as JaxFLConfig
from repro.core.update_store import UpdateStore as JaxUpdateStore
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.faas.hardware import HardwareProfile as JaxHardwareProfile
from repro.kernels.ops import RavelSpec as JaxRavelSpec
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch.core.scheduler import build_engine
from repro_torch.core.services import FLConfig
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import JaxBatchIndices
from torch_mesh_worker import det_fleet, trace

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
MESH, WORLD = "2x3", 6
RTOL, ATOL = 1e-4, 1e-5
AGG_TOL = 1e-5
WORKER_TIMEOUT_S = 400
# tests/test_mesh_plane.py's config (the reference's mesh test)
CFG = dict(n_clients=10, clients_per_round=4, rounds=5, local_epochs=1,
           batch_size=5, base_step_time=0.5, strategy="apodotiko-topk",
           concurrency_ratio=1.0, eval_every=0, keep_warm=1e9, seed=0)
SCAFFOLD_OVER = dict(strategy="scaffold", rounds=2, megastep="stepwise")
TOPK_OVER = dict(megastep="stepwise")


class Recording:
    """``JaxBatchIndices`` that keeps every table it hands out."""

    def __init__(self, seed: int, batch_size: int):
        self.inner = JaxBatchIndices(seed, batch_size)
        self.tables = []

    def __call__(self, Kp, max_steps, n_i):
        t = self.inner(Kp, max_steps, n_i)
        self.tables.append(t.numpy())
        return t


def _jax_fleet(n: int) -> list:
    speeds = (1.0, 1.45, 1.9)
    return [JaxHardwareProfile(f"det{i % 3}", speed=speeds[i % 3], vcpus=1.0,
                               mem_gib=2.0, variability=0.0)
            for i in range(n)]


def _port_1x1_tables(data, init, over) -> list:
    """The reference's draws, in the order a 1x1 port run makes them."""
    cfg = FLConfig(**{**CFG, **over})
    eng = build_engine(cfg, ProxyCNN(10), data, det_fleet(cfg.n_clients),
                       device="cpu", init_params=params_from_numpy(init,
                                                                   "cpu"))
    rec = Recording(cfg.seed, cfg.batch_size)
    eng.trainer.batch_indices = rec
    eng.run()
    return rec.tables


def _reference_run(jdata, over):
    cfg = JaxFLConfig(**{**CFG, **over})
    eng = JaxScheduler(cfg, JaxProxyCNN(10), jdata,
                       _jax_fleet(cfg.n_clients))
    eng.run()
    out = dict(trace=trace(eng),
               params={k: np.asarray(v) for k, v in eng.params.items()},
               free=list(eng.store._free), capacity=eng.store.capacity)
    if eng.c_global is not None:
        out["c_global"] = np.concatenate(
            [np.asarray(x).ravel() for x in jax.tree.leaves(eng.c_global)])
    return out


def _reference_store():
    """The workers' store sequence on the reference's 1x1 store."""
    store = JaxUpdateStore(1500, capacity=3)
    rng = np.random.default_rng(0)
    steps = []
    for k in (5, 6, 2, 9):
        ids = store.alloc(k)
        drop = rng.choice(ids, size=k // 2, replace=False)
        store.free(drop)
        steps.append((np.asarray(ids).tolist(), list(store._free),
                      store.capacity))
    rows = rng.normal(size=(3, 1500)).astype(np.float32)
    ids = store.put(rows)
    alloc = dict(steps=steps, put_ids=np.asarray(ids).tolist(),
                 gather=np.asarray(store.gather(ids)))
    grow = JaxUpdateStore(1500, capacity=2)
    caps = []
    for k in (6, 6, 12):
        grow.put(rng.normal(size=(k, 1500)).astype(np.float32))
        caps.append(grow.capacity)
    return dict(alloc=alloc, growth=dict(caps=caps, free=list(grow._free)))


def _reference_aggregates(rec: dict) -> dict:
    """The workers' aggregate cases on the reference's 1x1 store."""
    spec = JaxRavelSpec({"w": np.zeros(1500, np.float32)})
    out = {}
    for case in ("finite", "nan_freed"):
        store = JaxUpdateStore(1500, capacity=16)
        ids = store.put(rec["rows"])
        if case == "nan_freed":
            spare = store.alloc(1)
            store.write_at(spare, np.full((1, 1500), np.nan, np.float32))
            store.free(spare)
        got = jax_agg_rows(store.buffer, np.asarray(ids)[rec["pick"]],
                           rec["w"], spec)
        out[case] = np.asarray(got["w"])
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Start the 6 ranks, compute the reference's side meanwhile, and
    return every rank's record beside it."""
    tmp = tmp_path_factory.mktemp("mesh_plane")
    jdata = jax_dataset("mnist", n_clients=CFG["n_clients"], scale=0.05,
                        seed=0)
    data = make_federated_dataset("mnist", n_clients=CFG["n_clients"],
                                  scale=0.05, seed=0)
    init = jax.tree.map(np.asarray,
                        JaxProxyCNN(10).init(jax.random.PRNGKey(0))[0])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tables = {"topk": _port_1x1_tables(data, init, TOPK_OVER),
                  "scaffold": _port_1x1_tables(data, init, SCAFFOLD_OVER)}
    finally:
        torch.set_num_threads(n)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"tables": tables, "init": init}, f)
    spec = dict(mesh=MESH, world=WORLD, init=str(tmp / "rendezvous"),
                out=str(tmp), inputs=str(tmp / "inputs.pkl"), cfg=CFG,
                scaffold_over=SCAFFOLD_OVER)
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs, logs = [], []
    try:
        for r in range(WORLD):
            log = open(tmp / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(tmp / "spec.json"),
                 str(r)], env=env, cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))
        ref = dict(topk=_reference_run(jdata, TOPK_OVER),
                   scaffold=_reference_run(jdata, SCAFFOLD_OVER),
                   store=_reference_store())
        rcs = [p.wait(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rcs):
        tails = {r: (tmp / f"rank{r}.log").read_text()[-3000:]
                 for r, rc in enumerate(rcs) if rc}
        pytest.fail(f"ranks exited {rcs}: {tails}")
    records = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            records.append(pickle.load(f))
    ref["aggregate"] = _reference_aggregates(records[0]["aggregate"])
    return records, ref


def _close(port: dict, ref: dict, what: str) -> None:
    for name, leaf in port.items():
        np.testing.assert_allclose(leaf, ref[name], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


def test_ranks_sit_on_the_mesh(group):
    records, _ = group
    for rec in records:
        assert rec["coords"] == divmod(rec["rank"], 3)
        assert "gloo" in rec["repr"] and "'2x3'" in rec["repr"]
        # [capacity / 2, W / 3]: W = 1500 rounded up to lcm(1024, 3)
        assert rec["store"]["alloc"]["row_width"] == 3072
        alloc = rec["store"]["alloc"]
        assert alloc["tile"] == (alloc["capacity"] // 2, 1024)
        assert rec["topk"]["mesh"] == MESH
        assert rec["counters"]["mesh_host_bytes"] == 0   # CPU tensors
        assert rec["topk"]["mesh_collectives"] > 0


def test_sharded_store_ids_and_gather_equal_the_references(group):
    records, ref = group
    want = ref["store"]["alloc"]
    for rec in records:
        got = rec["store"]["alloc"]
        assert got["steps"] == want["steps"]
        assert got["put_ids"] == want["put_ids"]
        assert np.array_equal(got["gather"][:, :1500].view(np.int32),
                              want["gather"][:, :1500].view(np.int32))
        assert not got["gather"][:, 1500:].any()


def test_store_grows_under_the_mesh(group):
    records, ref = group
    want = ref["store"]["growth"]
    assert want["caps"] == [8, 16, 32]
    for rec in records:
        got = rec["store"]["growth"]
        assert got["caps"] == want["caps"] and got["free"] == want["free"]
        for (ids, rows), back in zip(got["written"], got["gathered"]):
            assert np.array_equal(back[:, :1500], rows)


def test_psum_aggregate_matches_the_reference(group):
    records, ref = group
    want = ref["aggregate"]["finite"]
    first = records[0]["aggregate"]["finite"]["agg"]
    for rec in records:
        got = rec["aggregate"]["finite"]
        assert got["path"] == "psum" and got["recomputes"] == 0
        assert float(np.abs(got["agg"] - want).max()) <= AGG_TOL
        assert np.array_equal(got["agg"].view(np.int32), first.view(np.int32))


def test_a_nan_freed_row_takes_the_guard_on_every_rank(group):
    records, ref = group
    want = ref["aggregate"]["nan_freed"]
    assert np.isfinite(want).all()
    for rec in records:
        got = rec["aggregate"]["nan_freed"]
        assert got["recomputes"] == 1 and got["path"] == "psum"
        assert np.isfinite(got["agg"]).all()
        assert float(np.abs(got["agg"] - want).max()) <= AGG_TOL


def test_topk_trace_and_params_match_the_reference_1x1(group):
    records, ref = group
    want = ref["topk"]
    for rec in records:
        got = rec["topk"]
        assert got["trace"] == want["trace"]
        assert got["free"] == want["free"]
        assert got["capacity"] == want["capacity"]
        _close(got["params"], want["params"], "topk")


def test_scaffold_matches_the_reference_1x1(group):
    records, ref = group
    want = ref["scaffold"]
    for rec in records:
        got = rec["scaffold"]
        assert got["trace"] == want["trace"]
        _close(got["params"], want["params"], "scaffold")
        assert np.abs(got["c_global"]).max() > 0
        np.testing.assert_allclose(got["c_global"], want["c_global"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [4, 3])
def test_fused_equals_stepwise_at_the_mesh(group, k):
    records, _ = group
    for rec in records:
        step, fused = rec[f"mega_{k}_stepwise"], rec[f"mega_{k}_fused"]
        assert step["megastep_rounds"] == 0
        assert fused["megastep_rounds"] >= 1, fused["fallback"]
        assert fused["trace"] == step["trace"]
        assert fused["free"] == step["free"]
        for name, leaf in step["params"].items():
            assert np.array_equal(fused["params"][name].view(np.int32),
                                  leaf.view(np.int32)), name


@pytest.mark.parametrize("run", ["topk", "scaffold", "mega_4_fused",
                                 "mega_3_fused", "mega_3_stepwise"])
def test_every_ranks_params_are_bit_equal(group, run):
    records, _ = group
    first = records[0][run]["params"]
    for rec in records[1:]:
        assert rec[run]["trace"] == records[0][run]["trace"]
        for name, leaf in rec[run]["params"].items():
            assert np.array_equal(leaf.view(np.int32),
                                  first[name].view(np.int32)), name


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


def test_scatter_bf16_on_the_mesh(group):
    """The bf16-wire psum against the exact (fp64) sum of the same updates
    rounded through bf16, every rank alike. The wire rounds each data
    rank's fp32 partial to
    bf16 before the sum, so the bound is chip_smoke's ``aggregate_check``
    (one bf16 ulp at the sum plus the fp32 summation's bound, K * 2^-24 *
    sum_k |w_k x_k|) plus one bf16 ulp at each partial: where the two
    partials nearly cancel, their rounding is many ulps of the small sum
    (46x the sum's alone on these updates)."""
    records, _ = group
    first = records[0]["scatter_bf16"]
    assert first["w_spec"] == ("data",)
    w = torch.as_tensor(first["w"])
    K, d = w.shape[0], 2
    for rec in records:
        got = rec["scatter_bf16"]
        assert got["dtypes"] == first["dtypes"]
        for x, o, o0 in zip(got["updates"], got["out"], first["out"]):
            assert np.array_equal(o, o0)
            xt = torch.as_tensor(x)
            terms = xt.to(torch.float64) * w.to(torch.float64).reshape(
                (K,) + (1,) * (xt.dim() - 1))
            want = terms.sum(0).to(torch.bfloat16).to(torch.float64)
            partials = terms.reshape((d, K // d) + terms.shape[1:]).sum(1)
            bound = (_bf16_ulp(want) + _bf16_ulp(partials).sum(0)
                     + K * 2.0 ** -24 * terms.abs().sum(0))
            err = (torch.as_tensor(o, dtype=torch.float64) - want).abs()
            assert bool((err <= bound).all()), float((err / bound).max())
