#!/usr/bin/env python3
"""One rank of ``chip_smoke.py``'s ``mesh`` phase.

    python3 scripts/torch_mesh_child.py SPEC.json RANK

Joins the gloo process group that SPEC names (``world`` ranks, a
``file://`` rendezvous at ``init``) and runs each of SPEC's ``runs``
(each naming its dataset, model and fleet) through
``build_engine(FLConfig(**cfg, mesh=SPEC's mesh), ...).run()`` on SPEC's
device, under deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` comes
from the parent). For each run it zeroes every kernel count just before
and reads them just after, and writes to SPEC's ``out`` directory one JSON
record a rank (``rank<R>.json``: host trace, launches, each round's
largest step budget, wall seconds a round, the mesh's collective
counters) and the params (``rank<R>_<run>.pt``, on the CPU: the final
ones, and after each round of a run timed a round).

Then SPEC's ``durable`` runs, in folders under its ``root`` (rank 0
writes the files, every rank reads them): the golden durable run (its
params in ``rank<R>_durable_golden.pt``), one run killed at a journal
boundary on every rank and resumed in this process and group
(``chip_smoke.crash_and_resume``: the launches of the re-executed rounds,
and every ``durable_state`` key and the journal's bytes against the
golden run's on this rank), and the Scheduler's database checkpoints
resumed at this mesh (``chip_smoke.checkpoint_resume``; rank 0 writes the
checkpoint's state to ``ckpt_want.pt`` for the parent's 1x1 resume).
Their record is the ``durable`` entry of ``rank<R>.json``.

Any failure raises: the exit code is non-zero and the parent fails the
phase. Imports neither ``jax`` nor ``repro``; the kernels are the ones the
parent built into ``build/kernels/``.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
for mod in ("jax", "repro"):          # the port must not need either
    sys.modules[mod] = None

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402


def one_run(run: dict, spec: dict, datasets: dict, dev) -> tuple:
    """``run`` on this rank: its record and its final params."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.core.services import FLConfig
    from repro_torch.faas.hardware import paper_fleet

    from repro_torch.data.synthetic import make_federated_dataset

    key = json.dumps(run["data"], sort_keys=True)
    if key not in datasets:
        datasets[key] = make_federated_dataset(**run["data"])
    data = datasets[key]
    cfg = FLConfig(**run["cfg"], mesh=spec["mesh"])
    fleet = (cs.det_fleet(cfg.n_clients) if run["fleet"] == "det"
             else list(paper_fleet(cfg.n_clients)))
    eng = build_engine(cfg, cs.mesh_model(run["model"]), data, fleet,
                       device=dev)
    walls, clock, rounds = [], [0.0], []

    def progress(log):
        cs.sync(dev)
        now = time.perf_counter()
        walls.append(now - clock[0])
        rounds.append({k: v.detach().cpu() for k, v in eng.params.items()})
        cs.sync(dev)
        clock[0] = time.perf_counter()

    cs.zero_counts()
    cs.sync(dev)
    clock[0] = t0 = time.perf_counter()
    m = eng.run(progress=progress if run["per_round"] else None)
    cs.sync(dev)
    wall = time.perf_counter() - t0
    launches = cs.read_counts()
    budgets = {}
    for r in eng.platform.invocations:
        budgets[r.round] = max(budgets.get(r.round, 0), cs.step_budget(
            data, r.client_id, cfg.batch_size, cfg.local_epochs))
    rec = {"name": run["name"], "trace": cs.host_trace(eng),
           "launches": launches, "rounds": len(eng.history),
           "aggregations": sum(1 for l in eng.history if l.n_aggregated),
           "largest_step_budgets": [budgets[k] for k in sorted(budgets)],
           "round_wall_s": walls, "wall_s": wall,
           "megastep_rounds": m["megastep_rounds"],
           "megastep_fallback_reason": m["megastep_fallback_reason"],
           "mesh": m["mesh"], "device": m["device"],
           "store_tile": list(eng.store.buffer.shape),
           "store_capacity": eng.store.capacity,
           "row_width": eng.store.row_width,
           **{k: m[k] for k in ("mesh_host_bytes", "mesh_collective_s",
                                "mesh_collectives")}}
    params = {"final": {k: v.detach().cpu() for k, v in eng.params.items()},
              "rounds": rounds}
    return rec, params


def durable_runs(spec: dict, datasets: dict, dev, out: Path,
                 rank: int) -> dict:
    """SPEC's ``durable`` runs on this rank: their record."""
    from repro_torch.core.journal import Journal

    dur = spec["durable"]
    key = json.dumps(dur["data"], sort_keys=True)
    if key not in datasets:
        from repro_torch.data.synthetic import make_federated_dataset
        datasets[key] = make_federated_dataset(**dur["data"])
    data, model = datasets[key], cs.mesh_model(dur["model"])
    root = Path(dur["root"])

    def cfg(name: str):
        return cs.durable_cfg(dur["strategy"], dur["rounds"],
                              str(root / name), mesh=spec["mesh"],
                              **dur["over"])

    t0 = time.perf_counter()
    cs.zero_counts()
    eng, m, wall = cs.timed_durable_run(cfg("golden"), model, data, dev)
    launches = cs.read_counts()
    gold = cs.durable_state(eng)
    torch.save({k: v.detach().cpu() for k, v in eng.params.items()},
               out / f"rank{rank}_durable_golden.pt")
    golden = {"wall_s": wall, "rounds": len(eng.history),
              "launches": {k: launches[k] for k in ("staleness_agg",
                                                    "fused_adam")},
              "snapshot_ms": m["snapshot_s"] / max(m["n_snapshots"], 1)
              * 1e3,
              **{k: m[k] for k in ("journal_records", "journal_bytes",
                                   "journal_fsyncs", "n_snapshots",
                                   "mesh_host_bytes", "mesh_collectives",
                                   "megastep_fallback_reason")}}
    del eng
    gold_journal = (root / "golden" / "journal.wal").read_bytes()
    records, _ = Journal.read(str(root / "golden" / "journal.wal"))
    k = cs.crash_points(records)[dur["crash"]]
    crash = cs.crash_and_resume(cfg(dur["crash"]), model, data, dev, k,
                                gold, gold_journal)
    crash["point"] = dur["crash"]
    ckpt, want = cs.checkpoint_resume(model, data, dev, str(root),
                                      engine="scheduler", mesh=spec["mesh"],
                                      **dur["over"])
    if rank == 0:
        torch.save(want, out / "ckpt_want.pt")
    return {"golden": golden, "crash": crash, "checkpoint": ckpt,
            "wall_s": time.perf_counter() - t0}


def main() -> int:
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    out = Path(spec["out"])
    dev = torch.device(spec["device"])
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"file://{spec['init']}",
                            rank=rank, world_size=spec["world"])
    try:
        from repro_torch.sharding import flmesh
        mesh = flmesh.build_fl_mesh(spec["mesh"], dev)
        records, datasets = [], {}
        for run in spec["runs"]:
            rec, params = one_run(run, spec, datasets, dev)
            torch.save(params, out / f"rank{rank}_{run['name']}.pt")
            records.append(rec)
        result = {"rank": rank, "coords": [mesh.data_index,
                                           mesh.model_index],
                  "mesh": repr(mesh), "backend": mesh.backend,
                  "stages": mesh.stages, "runs": records}
        if "durable" in spec:
            result["durable"] = durable_runs(spec, datasets, dev, out, rank)
    finally:
        dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
