"""One rank of ``tests/test_torch_mesh_durability.py``'s CPU process group.

    python tests/torch_mesh_durability_worker.py SPEC.json RANK

Joins the gloo group that SPEC names (a ``file://`` rendezvous), runs the
durable and checkpointed cases below at SPEC's mesh on SPEC's ``device``
(the CPU unless it names a card; on a card under deterministic
algorithms; SPEC's ``cases``, ``points`` and ``checkpoints`` may cut the
list), each in its own folder under SPEC's ``root`` (rank 0 writes the
files, every rank reads them), and pickles one record for the test to
read (``rank<R>.pkl`` in SPEC's ``out`` directory). Every rank's journal records are captured
as it builds them, so the test can hold each rank's to rank 0's. Imports
neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
if __name__ == "__main__":     # a rank needs neither (the test imports both)
    sys.modules["jax"] = None
    sys.modules["repro"] = None

from repro_torch.core.journal import JOURNAL_NAME, Journal  # noqa: E402
from repro_torch.core.scheduler import Scheduler, build_engine  # noqa: E402
from repro_torch.core.services import FLConfig  # noqa: E402
from repro_torch.data.synthetic import make_federated_dataset  # noqa: E402
from repro_torch.durability import (SimulatedCrash,  # noqa: E402
                                    resume_durable)
from repro_torch.durability.manager import DurabilityManager  # noqa: E402
from repro_torch.faas.hardware import paper_fleet  # noqa: E402
from repro_torch.models.proxy_models import build_bench_model  # noqa: E402
from repro_torch.sharding import flmesh  # noqa: E402

#: every record a DurabilityManager of this process builds, in order
#: (``capture_records``)
CAPTURED: list = []


def capture_records() -> None:
    """Make every ``DurabilityManager`` of this process append each record
    it builds to ``CAPTURED`` (a rank's own, whether or not it writes)."""
    build = DurabilityManager._next_record

    def capturing(self, kind, payload, round_):
        rec = build(self, kind, payload, round_)
        CAPTURED.append(json.loads(json.dumps(rec)))
        return rec

    DurabilityManager._next_record = capturing


#: the within-port cases: the Scheduler on the columnar plane (crashed at
#: every point of ``crash_points``), the Controller on the object plane
#: and SCAFFOLD (crashed mid round 2)
CASES = {"sched": dict(strategy="apodotiko"),
         "legacy": dict(strategy="apodotiko", engine="legacy",
                        control_plane="object"),
         "scaffold": dict(strategy="scaffold")}


def crash_points(records: list) -> dict:
    """``crash_after`` values (records processed before the crash): the
    genesis record alone, just before and just after the first
    ``round_close`` (whose snapshot is not yet written), just after that
    snapshot, the middle ``ResultLanded`` of round 2, and all records but
    the last."""
    close = next(r["q"] for r in records if r["k"] == "round_close")
    landed = [r["q"] for r in records
              if r["k"] == "ResultLanded" and r["r"] == 1]
    return {"genesis": 1, "before_close": close, "after_close": close + 1,
            "after_snapshot": close + 2,
            "mid_round_2": landed[len(landed) // 2] + 1,
            "last_but_one": len(records) - 1}


def bit_equal(got, want, what: str) -> None:
    """Assert equality through dicts, lists and arrays, fp32 arrays as
    their int32 bit patterns."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            bit_equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        if want.dtype == np.float32:
            got, want = got.view(np.int32), want.view(np.int32)
        assert np.array_equal(got, want,
                              equal_nan=want.dtype.kind == "f"), what
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            bit_equal(g, w, f"{what}[{i}]")
    else:
        assert got == want, what


def engine_trace(eng) -> tuple:
    """The round log, every invocation record and its fault attribution."""
    hist = [(l.round, l.t_start, l.t_end, l.accuracy, l.n_aggregated,
             l.n_stale) for l in eng.history]
    inv = [(r.client_id, r.round, r.t_invoked, r.cold, r.duration, r.failed,
            r.failed_phase, r.lost, r.timed_out, r.cancelled)
           for r in eng.platform.invocations]
    return hist, inv


def host(t: torch.Tensor):
    return t.detach().cpu().numpy()


#: the keys of ``durable_state`` that a resume must give back
STATE_KEYS = ("trace", "total_time", "round", "params", "free", "live",
              "rows", "generator", "capacity", "fleet", "c_global", "c_buf")


def durable_state(eng) -> dict:
    """What a resume must give back bit for bit; the live rows gathered
    whole (a collective: every rank calls this at the same point) and cut
    to the model's params."""
    live = [int(i) for i in eng.store.live_rows()]
    n = eng.spec.n_params
    out = {"trace": engine_trace(eng), "total_time": eng.loop.now,
           "round": eng.db.round,
           "params": {k: host(v) for k, v in eng.params.items()},
           "free": list(eng.store._free), "live": live,
           "rows": host(eng.store.gather(live))[:, :n],
           "generator": host(eng.trainer.generator.get_state()),
           "capacity": eng.store.capacity}
    if eng.db.columnar:
        out["fleet"] = eng.db.fleet.state_dict()
    if eng.c_global is not None:
        out["c_global"] = host(eng.c_global)
        out["c_buf"] = host(eng.c_buf)
    return out


def checkpoint_state(eng) -> dict:
    """What a database checkpoint restores: the round, the results, the
    client records (or fleet columns), the params and the pending rows
    (ids, and their values cut to the model's params)."""
    pending = sorted(r.update_row for r in eng.db.results
                     if not r.aggregated)
    clients = (eng.db.fleet.state_dict() if eng.db.columnar else
               {c: dataclasses.asdict(r) for c, r in eng.db.clients.items()})
    return {"round": eng.db.round,
            "results": [dataclasses.asdict(r) for r in eng.db.results],
            "clients": clients,
            "params": {k: host(v) for k, v in eng.params.items()},
            "pending": pending,
            "rows": host(eng.store.gather(pending))[:, :eng.spec.n_params]}


class Setup:
    def __init__(self, spec: dict):
        self.spec = spec
        self.kw = spec["cfg"]
        self.device = spec.get("device", "cpu")
        self.data = make_federated_dataset(
            "mnist", n_clients=self.kw["n_clients"], scale=0.05, seed=0)

    def model(self):
        return build_bench_model("mnist")

    def fleet(self) -> list:
        return list(paper_fleet(self.kw["n_clients"]))

    def durable_cfg(self, root: str, **over) -> FLConfig:
        return FLConfig(**{**self.kw, **over}, durability="journal",
                        checkpoint_dir=root, mesh=self.spec["mesh"])

    def golden(self, case: str) -> dict:
        root = os.path.join(self.spec["root"], case, "golden")
        CAPTURED.clear()
        eng = build_engine(self.durable_cfg(root, **CASES[case]),
                           self.model(), self.data, self.fleet(),
                           device=self.device)
        m = eng.run()
        rec = durable_state(eng)
        rec.update(records=list(CAPTURED), metrics={
            k: m[k] for k in ("journal_records", "journal_bytes",
                              "journal_fsyncs", "n_snapshots", "mesh",
                              "mesh_host_bytes")})
        return rec

    def crash_resume(self, case: str, name: str, k: int) -> dict:
        """Kill the case's run after record ``k`` on every rank, resume it
        in this process and group, and run it to the end."""
        root = os.path.join(self.spec["root"], case, name)
        cfg = self.durable_cfg(root, **CASES[case])
        eng = build_engine(cfg, self.model(), self.data, self.fleet(),
                           device=self.device)
        eng.durability.crash_after = k
        try:
            eng.run()
            raise AssertionError(f"{case}: no crash at record {k}")
        except SimulatedCrash:
            pass
        del eng
        res = resume_durable(cfg, self.model(), self.data, self.fleet(),
                             device=self.device)
        snap_round = res.db.round
        m = res.run()
        rec = durable_state(res)
        rec.update(k=k, snapshot_round=snap_round,
                   replayed=m["journal_replayed"],
                   journal_bytes=m["journal_bytes"])
        return rec

    def checkpoint(self) -> dict:
        """The Scheduler with ``checkpoint_every=1`` for 2 rounds, its
        stragglers landed and one more ``checkpoint()`` (live rows in it),
        then ``Scheduler.resume`` at this mesh with ``rounds=3``."""
        root = os.path.join(self.spec["root"], "ckpt_mesh")
        kw = dict(self.kw, strategy="apodotiko", rounds=2)
        sched = Scheduler(FLConfig(**kw, checkpoint_every=1,
                                   checkpoint_dir=root,
                                   mesh=self.spec["mesh"]),
                          self.model(), self.data, self.fleet(),
                          device=self.device)
        sched.run()
        while sched.loop.step():
            pass
        sched.checkpoint()
        want = checkpoint_state(sched)
        del sched
        return {"want": want, **self.resume(root)}

    def resume(self, root: str) -> dict:
        """``Scheduler.resume`` of the checkpoint in ``root`` at this mesh
        (rounds=3): its state, then one more round."""
        kw = dict(self.kw, strategy="apodotiko", rounds=3)
        res = Scheduler.resume(FLConfig(**kw, checkpoint_dir=root,
                                        mesh=self.spec["mesh"]),
                               self.model(), self.data, self.fleet(),
                               device=self.device)
        got = checkpoint_state(res)
        m = res.run()
        return {"got": got, "rounds_run": m["rounds"],
                "final_round": res.db.round,
                "row_width": res.store.row_width,
                "after": durable_state(res)}


def main() -> int:
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    if spec.get("device", "cpu") != "cpu":
        torch.use_deterministic_algorithms(True)
    capture_records()
    dist.init_process_group("gloo", init_method=f"file://{spec['init']}",
                            rank=rank, world_size=spec["world"])
    try:
        setup = Setup(spec)
        mesh = flmesh.build_fl_mesh(spec["mesh"], setup.device)
        rec = {"rank": rank, "coords": (mesh.data_index, mesh.model_index)}
        for case in spec.get("cases", CASES):
            gold = rec[f"{case}_golden"] = setup.golden(case)
            points = crash_points(gold["records"])
            if case != "sched":
                points = {"mid_round_2": points["mid_round_2"]}
            for name in spec.get("points", points):
                rec[f"{case}_{name}"] = setup.crash_resume(case, name,
                                                           points[name])
        if spec.get("checkpoints", True):
            rec["ckpt_mesh"] = setup.checkpoint()
            rec["ckpt_from_1x1"] = setup.resume(spec["ckpt_1x1"])
        rec["counters"] = mesh.counters()
    finally:
        dist.destroy_process_group()
    with open(Path(spec["out"]) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
