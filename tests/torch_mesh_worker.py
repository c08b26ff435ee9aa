"""One rank of ``tests/test_torch_mesh_plane.py``'s CPU process group.

    python tests/torch_mesh_worker.py SPEC.json RANK

Joins the gloo group that SPEC names (a ``file://`` rendezvous), runs the
cases below on the CPU at SPEC's mesh, and pickles one record for the test
to read (``rank<R>.pkl`` in SPEC's ``out`` directory). Imports neither
``jax`` nor ``repro``: where a case needs the reference's minibatch draws,
SPEC carries them as index tables (``ReplayIndices``), recorded by the test
from the reference's draws in the order a 1x1 run makes them."""
from __future__ import annotations

import json
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
if __name__ == "__main__":     # a rank needs neither (the test imports both)
    sys.modules["jax"] = None
    sys.modules["repro"] = None

from repro_torch.core import aggregation  # noqa: E402
from repro_torch.core.scheduler import build_engine  # noqa: E402
from repro_torch.core.services import FLConfig  # noqa: E402
from repro_torch.core.update_store import UpdateStore  # noqa: E402
from repro_torch.data.synthetic import make_federated_dataset  # noqa: E402
from repro_torch.faas.hardware import HardwareProfile  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.ops import RavelSpec, tree_leaves  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.proxy_models import ProxyCNN  # noqa: E402
from repro_torch.sharding import flmesh  # noqa: E402

SPEEDS = (1.0, 1.45, 1.9)


class ReplayIndices:
    """``CohortTrainer.batch_indices`` from recorded tables, in order; a
    call whose shape differs from the next table's raises."""

    def __init__(self, tables):
        self.tables = list(tables)
        self.pos = 0

    def __call__(self, Kp, max_steps, n_i):
        table = self.tables[self.pos]
        if table.shape[:2] != (Kp, max_steps):
            raise AssertionError(f"draw {self.pos}: asked for "
                                 f"{(Kp, max_steps)}, recorded "
                                 f"{table.shape[:2]}")
        self.pos += 1
        return torch.as_tensor(table, dtype=torch.int64, device=n_i.device)


def det_fleet(n: int) -> list:
    return [HardwareProfile(f"det{i % 3}", speed=SPEEDS[i % 3], vcpus=1.0,
                            mem_gib=2.0, variability=0.0) for i in range(n)]


def trace(engine):
    hist = [(l.round, l.t_start, l.t_end, l.accuracy, l.n_aggregated,
             l.n_stale) for l in engine.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed)
           for r in engine.platform.invocations]
    return hist, inv


def numpy_params(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def store_cases(mesh) -> dict:
    """The allocator sequence of ``test_torch_client_store``, growth of a
    store filled past its capacity twice, and ``gather`` of every row."""
    out = {}
    store = UpdateStore(1500, capacity=3, device="cpu", mesh=mesh)
    rng = np.random.default_rng(0)
    steps = []
    for k in (5, 6, 2, 9):
        ids = store.alloc(k)
        drop = rng.choice(ids, size=k // 2, replace=False)
        store.free(drop)
        steps.append((ids.tolist(), list(store._free), store.capacity))
    rows = rng.normal(size=(3, 1500)).astype(np.float32)
    ids = store.put(torch.as_tensor(rows))
    out["alloc"] = dict(steps=steps, put_ids=ids.tolist(),
                        gather=store.gather(ids).numpy(),
                        row_width=store.row_width, capacity=store.capacity,
                        tile=tuple(store.buffer.shape))
    grow = UpdateStore(1500, capacity=2, device="cpu", mesh=mesh)
    written, caps = [], []
    for k in (6, 6, 12):
        rows = rng.normal(size=(k, 1500)).astype(np.float32)
        ids = grow.put(torch.as_tensor(rows))
        written.append((ids.tolist(), rows))
        caps.append(grow.capacity)
    out["growth"] = dict(
        caps=caps, free=list(grow._free), written=written,
        gathered=[grow.gather(ids).numpy() for ids, _ in written])
    return out


def aggregate_cases(mesh) -> dict:
    """``weighted_aggregate_rows(mesh=)`` over 7 of 10 rows, then again with
    a freed row holding NaN (the finiteness guard's recompute)."""
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(10, 1500)).astype(np.float32)
    pick = np.array([9, 2, 5, 0, 7, 3, 8])
    w = rng.uniform(0.5, 1.5, size=7)
    w = (w / w.sum()).astype(np.float32)
    spec = RavelSpec({"w": torch.zeros(1500)})
    out = {"rows": rows, "pick": pick, "w": w}
    for case in ("finite", "nan_freed"):
        store = UpdateStore(1500, capacity=16, device="cpu", mesh=mesh)
        ids = store.put(torch.as_tensor(rows))
        if case == "nan_freed":
            spare = store.alloc(1)
            store.write_at(spare, np.full((1, 1500), np.nan, np.float32))
            store.free(spare)
            out["nan_row"] = int(spare[0])
        guard0, launches0 = (aggregation.guard_recomputes(),
                             launch_counts()["staleness_agg"])
        agg = aggregation.weighted_aggregate_rows(
            store.buffer, ids[pick], w, spec, mesh=mesh)
        out[case] = dict(
            ids=ids.tolist(), agg=agg["w"].numpy(),
            path=aggregation.last_path(),
            recomputes=aggregation.guard_recomputes() - guard0,
            launches=launch_counts()["staleness_agg"] - launches0)
    return out


def engine_run(spec: dict, mesh_spec: str, data, tables=None, init=None,
               **over) -> dict:
    cfg = FLConfig(**{**spec["cfg"], **over}, mesh=mesh_spec)
    params = (params_from_numpy(init, "cpu") if init is not None else None)
    eng = build_engine(cfg, ProxyCNN(10), data, det_fleet(cfg.n_clients),
                       device="cpu", init_params=params)
    if tables is not None:
        eng.trainer.batch_indices = ReplayIndices(tables)
    c0 = launch_counts()
    t0 = time.perf_counter()
    m = eng.run()
    wall = time.perf_counter() - t0
    counts = {k: v - c0[k] for k, v in launch_counts().items()}
    rec = dict(trace=trace(eng), params=numpy_params(eng.params),
               free=list(eng.store._free), capacity=eng.store.capacity,
               tile=tuple(eng.store.buffer.shape), launches=counts,
               megastep_rounds=m["megastep_rounds"],
               fallback=m["megastep_fallback_reason"], mesh=m["mesh"],
               mesh_collectives=m["mesh_collectives"],
               mesh_host_bytes=m["mesh_host_bytes"], wall_s=wall,
               n_params=eng.spec.n_params,
               largest_budgets=largest_budgets(eng, cfg))
    if eng.c_global is not None:
        rec["c_global"] = eng.c_global[:eng.spec.n_params].numpy()
    return rec


def largest_budgets(eng, cfg) -> list:
    """Each round's largest step budget: the cohort's local steps."""
    out = {}
    for r in eng.platform.invocations:
        steps = max(-(-int(eng.data.n[r.client_id]) // cfg.batch_size)
                    * cfg.local_epochs, 1)
        out[r.round] = max(out.get(r.round, 0), steps)
    return [out[k] for k in sorted(out)]


def scatter_bf16_case(mesh) -> dict:
    """``fl_round``'s ``scatter_bf16`` cell on this mesh against the 1x1
    fp32 sum of the same updates (qwen3-1.7b's smoke widths, K = 6)."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import cut_shape
    smoke = get_config("qwen3-1.7b", smoke=True)
    over = {k: getattr(smoke, k) for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab_size", "param_dtype", "compute_dtype")}
    shape, _ = cut_shape(SHAPES["fl_round"], global_batch=6)
    cell = steps.build_cell("qwen3-1.7b", shape, mesh, overrides=over,
                            variant="scatter_bf16")
    upd, w = cell.make_args("cpu", seed=5)
    got = cell.fn(upd, w)
    return dict(updates=[x.float().numpy() for x in tree_leaves(upd)],
                dtypes=[str(x.dtype) for x in tree_leaves(got)],
                w=w.numpy(),
                out=[x.float().numpy() for x in tree_leaves(got)],
                w_spec=tuple(cell.in_shardings[1]))


def main() -> int:
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{spec['init']}",
                            rank=rank, world_size=spec["world"])
    try:
        with open(spec["inputs"], "rb") as f:
            inputs = pickle.load(f)
        mesh = flmesh.build_fl_mesh(spec["mesh"], "cpu")
        data = make_federated_dataset("mnist", n_clients=spec["cfg"][
            "n_clients"], scale=0.05, seed=0)
        rec = dict(rank=rank, coords=(mesh.data_index, mesh.model_index),
                   repr=repr(mesh), store=store_cases(mesh),
                   aggregate=aggregate_cases(mesh))
        rec["topk"] = engine_run(spec, spec["mesh"], data,
                                 tables=inputs["tables"]["topk"],
                                 init=inputs["init"], megastep="stepwise")
        rec["scaffold"] = engine_run(spec, spec["mesh"], data,
                                     tables=inputs["tables"]["scaffold"],
                                     init=inputs["init"],
                                     **spec["scaffold_over"])
        for k in (4, 3):
            for mode in ("stepwise", "fused"):
                rec[f"mega_{k}_{mode}"] = engine_run(
                    spec, spec["mesh"], data, megastep=mode,
                    clients_per_round=k)
        rec["scatter_bf16"] = scatter_bf16_case(mesh)
        rec["counters"] = mesh.counters()
    finally:
        dist.destroy_process_group()
    with open(Path(spec["out"]) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
