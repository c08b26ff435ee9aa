"""The port's durable runs and database checkpoints under an FL mesh, on a
CPU process group of 6 ranks (``2x3``, gloo; asymmetric, so a swapped
axis shows), at the reference durable harness's size (ProxyCNN, 10
clients on the paper fleet, 4 a round, E=1, B=5).

One group runs for the module (``tests/torch_mesh_durability_worker.py``,
a ``file://`` rendezvous in a temporary folder), each rank writing one
record; the tests below assert on the records and on the files rank 0
wrote. The reference's own multi-device path fails under jax 0.9.0, so
its side is its 1x1 run:

  * the ``2x3`` journal equals the reference's 1x1 journal record for
    record in ``q``, ``k``, ``t``, ``r``, ``p`` and ``g`` minus ``g["k"]``;
    its genesis digest is the reference's ``config_digest`` of the config
    with ``mesh="2x3"``;
  * every rank builds the same records as rank 0; rank 0 alone writes;
  * the Scheduler on the columnar plane killed at six boundaries (around
    the first snapshot's ``round_close`` among them), the Controller on
    the object plane and SCAFFOLD at one each, resumed in the same group:
    journal bytes, history, clock, free list, live rows, generator, fleet
    columns and every rank's params equal the golden ``2x3`` run's, bit
    for bit, and every rank equals rank 0;
  * a ``2x3`` database checkpoint resumes at ``2x3`` and at ``1x1`` (the
    ``2x3`` rows are wider: ``write_at`` trims them), and a ``1x1``
    checkpoint at ``2x3``, each with its round, results, client columns,
    params and pending rows;
  * a ``2x3`` journal is refused under ``1x1``.
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

from repro.core.journal import Journal as JaxJournal
from repro.core.scheduler import build_engine as jax_build_engine
from repro.core.services import FLConfig as JaxFLConfig
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.durability import config_digest as jax_config_digest
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.models.proxy_models import build_bench_model as jax_bench_model
from repro_torch.core.journal import JOURNAL_NAME, Journal
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.services import FLConfig
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.durability import resume_durable
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.proxy_models import build_bench_model
from torch_mesh_durability_worker import (CASES, STATE_KEYS, bit_equal,
                                          checkpoint_state, durable_state)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_mesh_durability_worker.py"
MESH, WORLD = "2x3", 6
WORKER_TIMEOUT_S = 300
# trace_harness.base_cfg_kw: the reference durable harness's config
CFG = dict(n_clients=10, clients_per_round=4, rounds=2, local_epochs=1,
           batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0)
SCHED_POINTS = ("genesis", "before_close", "after_close", "after_snapshot",
                "mid_round_2", "last_but_one")


def _no_gen_key(records):
    out = []
    for r in records:
        r = json.loads(json.dumps(r))
        r["g"].pop("k", None)
        out.append(r)
    return out


def _setup():
    data = make_federated_dataset("mnist", n_clients=CFG["n_clients"],
                                  scale=0.05, seed=0)
    return build_bench_model("mnist"), data, list(paper_fleet(
        CFG["n_clients"]))


def _checkpoint_1x1(root: str) -> dict:
    """The worker's checkpoint case at 1x1, in this process: the state a
    resume at 2x3 must restore."""
    model, data, fleet = _setup()
    sched = Scheduler(FLConfig(**CFG, strategy="apodotiko",
                               checkpoint_every=1, checkpoint_dir=root),
                      model, data, fleet, device="cpu")
    sched.run()
    while sched.loop.step():
        pass
    sched.checkpoint()
    return checkpoint_state(sched)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Start the 6 ranks, compute the reference's and the 1x1 side
    meanwhile, and return every rank's record beside them."""
    tmp = tmp_path_factory.mktemp("mesh_durability")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want_1x1 = _checkpoint_1x1(str(tmp / "ckpt_1x1"))
    finally:
        torch.set_num_threads(n)
    spec = dict(mesh=MESH, world=WORLD, init=str(tmp / "rendezvous"),
                out=str(tmp), root=str(tmp / "runs"), cfg=CFG,
                ckpt_1x1=str(tmp / "ckpt_1x1"))
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
        jdata = jax_dataset("mnist", n_clients=CFG["n_clients"], scale=0.05,
                            seed=0)
        ref_root = tmp / "reference"
        jax_build_engine(JaxFLConfig(**CFG, strategy="apodotiko",
                                     durability="journal",
                                     checkpoint_dir=str(ref_root)),
                         jax_bench_model("mnist"), jdata,
                         list(jax_fleet(CFG["n_clients"]))).run()
        ref = JaxJournal.read(str(ref_root / JOURNAL_NAME))[0]
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
    return dict(records=records, ref=ref, tmp=tmp, want_1x1=want_1x1)


def _journal(group, *parts) -> bytes:
    return (group["tmp"] / "runs" / Path(*parts) / JOURNAL_NAME).read_bytes()


def _state(rec: dict) -> dict:
    return {k: rec[k] for k in STATE_KEYS if k in rec}


def test_ranks_sit_on_the_mesh_and_rank_0_alone_writes(group):
    for rec in group["records"]:
        assert rec["coords"] == divmod(rec["rank"], 3)
        for case in CASES:
            m = rec[f"{case}_golden"]["metrics"]
            assert m["mesh"] == MESH and m["n_snapshots"] == CFG["rounds"]
            assert m["journal_records"] > 3
            written = m["journal_bytes"] > 0 and m["journal_fsyncs"] > 0
            assert written == (rec["rank"] == 0), (case, rec["rank"], m)
            assert m["mesh_host_bytes"] == 0        # CPU tensors
        assert rec["counters"]["mesh_collectives"] > 0
    gold = group["records"][0]["sched_golden"]
    assert gold["metrics"]["journal_bytes"] == len(_journal(
        group, "sched", "golden"))


def test_journal_equals_the_references_1x1(group):
    """The 2x3 journal rank 0 wrote against the reference's 1x1 journal of
    the same config and seed: every record but ``g["k"]``, and the genesis
    digest, which hashes the mesh."""
    got = Journal.read(str(group["tmp"] / "runs" / "sched" / "golden" /
                           JOURNAL_NAME))[0]
    want = group["ref"]
    assert len(got) == len(want) > 3
    digest = jax_config_digest(JaxFLConfig(**CFG, strategy="apodotiko",
                                           mesh=MESH))
    assert got[0]["k"] == "genesis"
    assert got[0]["p"]["config"] == digest != want[0]["p"]["config"]
    got[0]["p"]["config"] = want[0]["p"]["config"]
    assert _no_gen_key(got) == _no_gen_key(want)
    assert got[-1]["k"] == "run_end"


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_ranks_records_equal_rank_0s(group, case):
    first = group["records"][0][f"{case}_golden"]["records"]
    on_disk = Journal.read(str(group["tmp"] / "runs" / case / "golden" /
                               JOURNAL_NAME))[0]
    assert first == on_disk
    for rec in group["records"][1:]:
        assert rec[f"{case}_golden"]["records"] == first, rec["rank"]


def _resumed(group, case: str, point: str) -> None:
    """The crash at ``point`` resumed on every rank: its journal bytes,
    and on every rank the state of the golden run on the same rank and
    of the resumed run on rank 0, bit for bit."""
    key = f"{case}_{point}"
    assert _journal(group, case, point) == _journal(group, case, "golden")
    first = group["records"][0][key]
    for rec in group["records"]:
        got = rec[key]
        bit_equal(_state(got), _state(rec[f"{case}_golden"]),
               f"rank {rec['rank']} {key}")
        bit_equal(_state(got), _state(first), f"rank {rec['rank']} {key}")
        assert got["replayed"] == first["replayed"]
        assert (got["journal_bytes"] > 0) == (rec["rank"] == 0)


@pytest.mark.parametrize("point", SCHED_POINTS)
def test_a_scheduler_crash_resumes_bit_equal(group, point):
    _resumed(group, "sched", point)
    first = group["records"][0][f"sched_{point}"]
    if point in ("genesis", "before_close", "after_close"):
        assert first["snapshot_round"] == 0      # no snapshot yet
    else:
        assert first["snapshot_round"] >= 1
    assert first["replayed"] >= 1


def test_a_controller_crash_resumes_bit_equal(group):
    _resumed(group, "legacy", "mid_round_2")
    assert group["records"][0]["legacy_mid_round_2"]["snapshot_round"] == 1


def test_a_scaffold_crash_resumes_bit_equal(group):
    """SCAFFOLD's variates are replicated on every rank, saved by rank 0
    and restored on each."""
    _resumed(group, "scaffold", "mid_round_2")
    rec = group["records"][0]["scaffold_mid_round_2"]
    assert rec["snapshot_round"] == 1 and np.abs(rec["c_buf"]).max() > 0


def test_a_mesh_checkpoint_resumes_at_the_mesh(group):
    first = group["records"][0]["ckpt_mesh"]
    assert first["want"]["round"] == 2 and first["want"]["pending"]
    for rec in group["records"]:
        ck = rec["ckpt_mesh"]
        bit_equal(ck["want"], first["want"], f"rank {rec['rank']} want")
        bit_equal(ck["got"], ck["want"], f"rank {rec['rank']} resumed")
        assert ck["rounds_run"] == 1 and ck["final_round"] == 3
        bit_equal(ck["after"], first["after"], f"rank {rec['rank']} after")


def test_a_mesh_checkpoint_resumes_at_1x1(group):
    """The 2x3 checkpoint in this process at 1x1: its rows, saved at the
    2x3 store's width, are trimmed to the 1x1 store's."""
    first = group["records"][0]["ckpt_mesh"]
    model, data, fleet = _setup()
    res = Scheduler.resume(FLConfig(**dict(CFG, rounds=3),
                                    strategy="apodotiko",
                                    checkpoint_dir=str(group["tmp"] / "runs"
                                                       / "ckpt_mesh")),
                           model, data, fleet, device="cpu")
    assert res.mesh is None and res.store.row_width < first["row_width"]
    bit_equal(checkpoint_state(res), first["want"], "1x1 resume")
    m = res.run()
    assert m["rounds"] == 1 and res.db.round == 3
    assert durable_state(res)["trace"] == first["after"]["trace"]


def test_a_1x1_checkpoint_resumes_at_the_mesh(group):
    for rec in group["records"]:
        ck = rec["ckpt_from_1x1"]
        bit_equal(ck["got"], group["want_1x1"], f"rank {rec['rank']}")
        assert ck["rounds_run"] == 1 and ck["final_round"] == 3
        # 3,658 params: 4,096 wide at 1x1, 6,144 (lcm(1024, 3)-aligned)
        assert ck["row_width"] == 6144


def test_a_mesh_journal_is_refused_under_1x1(group):
    model, data, fleet = _setup()
    cfg = FLConfig(**CFG, strategy="apodotiko", durability="journal",
                   checkpoint_dir=str(group["tmp"] / "runs" / "sched" /
                                      "golden"))
    with pytest.raises(ValueError, match="different experiment config"):
        resume_durable(cfg, model, data, fleet, device="cpu")
