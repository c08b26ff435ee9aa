"""The port's checkpoints (``repro_torch.checkpoint`` and the database
checkpoints of ``FLRuntime.checkpoint`` / ``FLRuntime.resume``) against the
reference's, and within the port.

The ten cases of ``tests/test_checkpoint.py`` as twins on torch trees
(atomicity, retention, dtype fidelity with a bfloat16 leaf, the crash-safe
swap, corrupt-step fallback); files crossing packages both ways (the
reference writes and the port reads, the port writes and the reference
reads, bfloat16 leaf and update-store rows included); and the poll loop's
checkpoint and resume (``tests/test_controller.py::test_checkpoint_resume``
as a twin), the saved database equal to the reference's for the same run,
the Scheduler's checkpoint cadence, the live update rows rehydrated at
their ids, and a resume across update planes refused."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import restore_pytree as jax_restore_pytree
from repro.checkpoint import restore_update_store as jax_restore_update_store
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.core.controller import Controller as JaxController
from repro.core.controller import FLConfig as JaxFLConfig
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,
                                    restore_update_store, save_pytree,
                                    save_update_store)
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.services import UPDATE_STORE_DIRNAME, FLConfig
from repro_torch.core.update_store import UpdateStore
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import one_torch_thread  # noqa: F401

N_CLIENTS = 12          # tests/test_controller.py's fleet


def _tree():
    return {
        "dense": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                  "b": torch.ones(4, dtype=torch.bfloat16)},
        "scalars": (np.int32(7), np.float32(0.5)),
        "list": [torch.zeros(2), torch.ones(2)],
    }


def _w(value, n):
    return {"w": torch.full((n,), float(value))}


# ------------------------------------------- tests/test_checkpoint.py twins
def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path / "ckpt"))
    r = restore_pytree(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(r["dense"]["w"], t["dense"]["w"].numpy())
    b = r["dense"]["b"]
    assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
    assert b.device.type == "cpu"
    assert torch.equal(b, t["dense"]["b"])
    assert isinstance(r["scalars"], tuple)
    assert int(r["scalars"][0]) == 7
    assert isinstance(r["list"], list)
    np.testing.assert_array_equal(r["list"][1], np.ones(2, np.float32))


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 5, 9):
        mgr.save(step, _w(step, 3), extra={"round": step})
    assert mgr.steps() == [5, 9]  # step 1 garbage-collected
    assert mgr.latest_step() == 9
    tree, extra, step = mgr.restore()
    assert step == 9 and extra["round"] == 9
    np.testing.assert_array_equal(tree["w"], np.full(3, 9.0, np.float32))


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"w": torch.zeros(2)})
    mgr.save(2, {"w": torch.ones(2)})
    tree, _, step = mgr.restore(1)
    assert step == 1
    np.testing.assert_array_equal(tree["w"], np.zeros(2, np.float32))


def test_no_tmp_dirs_left_behind(tmp_path):
    save_pytree(_tree(), str(tmp_path / "c"))
    save_pytree(_tree(), str(tmp_path / "c"))  # overwrite path
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_missing_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_rename_aside_survives_crash_between_renames(tmp_path):
    """A kill between the two renames of the swap leaves only the ``.old``
    aside copy; restore falls back to it."""
    d = str(tmp_path / "ckpt")
    save_pytree({"w": torch.zeros(3)}, d)
    os.replace(d, d + ".old")
    r = restore_pytree(d)
    np.testing.assert_array_equal(r["w"], np.zeros(3, np.float32))


def test_overwrite_never_leaves_zero_checkpoints(tmp_path):
    d = str(tmp_path / "ckpt")
    save_pytree({"w": torch.zeros(3)}, d)
    save_pytree({"w": torch.ones(3)}, d)
    assert not os.path.exists(d + ".old")  # aside copy cleaned up
    np.testing.assert_array_equal(restore_pytree(d)["w"],
                                  np.ones(3, np.float32))


def test_restore_skips_corrupt_newest_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for step in (1, 2, 3):
        mgr.save(step, _w(step, 2), extra={"round": step})
    # step 3: missing meta.json; step 2: truncated leaves.npz
    os.remove(os.path.join(mgr._step_dir(3), "meta.json"))
    leaves = os.path.join(mgr._step_dir(2), "leaves.npz")
    with open(leaves, "r+b") as f:
        f.truncate(os.path.getsize(leaves) // 2)
    tree, extra, step = mgr.restore()
    assert step == 1 and extra["round"] == 1
    np.testing.assert_array_equal(tree["w"], np.full(2, 1.0, np.float32))


def test_restore_explicit_corrupt_step_still_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"w": torch.zeros(2)})
    mgr.save(2, {"w": torch.ones(2)})
    os.remove(os.path.join(mgr._step_dir(2), "meta.json"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(2)


def test_restore_all_corrupt_reports_count(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"w": torch.zeros(2)})
    os.remove(os.path.join(mgr._step_dir(1), "meta.json"))
    with pytest.raises(FileNotFoundError, match="1 corrupt"):
        mgr.restore()


# ------------------------------------------------- across the two packages
def test_a_reference_checkpoint_reads_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jax_save_pytree({"dense": {"w": jnp.asarray(w),
                               "b": jnp.asarray(b, jnp.bfloat16)},
                     "scalars": (jnp.int32(7), jnp.float32(0.5)),
                     "list": [jnp.zeros(2), jnp.ones(2)]},
                    str(tmp_path / "ref"))
    r = restore_pytree(str(tmp_path / "ref"))
    np.testing.assert_array_equal(r["dense"]["w"], w)
    assert r["dense"]["b"].dtype == torch.bfloat16
    assert torch.equal(r["dense"]["b"],
                       torch.from_numpy(b).to(torch.bfloat16))
    assert isinstance(r["scalars"], tuple) and int(r["scalars"][0]) == 7
    assert isinstance(r["list"], list)
    with open(tmp_path / "ref" / "meta.json") as f:
        assert json.load(f)["dtypes"]["0"] == "bfloat16"


def test_a_port_checkpoint_reads_in_the_reference(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, 4, generator=gen)
    b = torch.randn(5, generator=gen).to(torch.bfloat16)
    save_pytree({"dense": {"w": w, "b": b},
                 "scalars": (np.int32(7), np.float32(0.5)),
                 "list": [torch.zeros(2), torch.ones(2)]},
                str(tmp_path / "port"))
    r = jax_restore_pytree(str(tmp_path / "port"))
    np.testing.assert_array_equal(r["dense"]["w"], w.numpy())
    assert r["dense"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(r["dense"]["b"].astype(np.float32),
                                  b.float().numpy())
    assert isinstance(r["scalars"], tuple) and int(r["scalars"][0]) == 7
    assert isinstance(r["list"], list)


def test_update_store_rows_cross_and_write_back_at_their_ids(tmp_path):
    """Live rows saved by the port's store read in the reference, and back
    in a fresh port store at their original ids (reserved, off the free
    list, the rest of the free list in order)."""
    gen = torch.Generator().manual_seed(1)
    store = UpdateStore(1500, capacity=8, device="cpu")
    ids = store.put(torch.randn(5, 1500, generator=gen))
    store.free([ids[1], ids[3]])
    live = [int(i) for i in store.live_rows()]
    save_update_store(store, live, str(tmp_path / "rows"))
    jids, jrows, jn = jax_restore_update_store(str(tmp_path / "rows"))
    pids, prows, pn = restore_update_store(str(tmp_path / "rows"))
    np.testing.assert_array_equal(jids, pids)
    np.testing.assert_array_equal(jrows, prows)
    assert jn == pn == 1500 and prows.shape == (3, store.row_width)
    fresh = UpdateStore(1500, capacity=8, device="cpu")
    fresh.write_at(pids, prows)
    assert fresh._live == set(live)
    assert fresh._free == [i for i in range(8) if i not in live]
    assert torch.equal(fresh.gather(live), store.gather(live))
    # rows of a wider store are trimmed; narrow rows zero the pad lanes
    wide = np.concatenate([prows, np.zeros((3, 1024), np.float32)], 1)
    fresh.write_at(pids, wide)
    assert torch.equal(fresh.gather(live), store.gather(live))
    fresh.write_at(pids[:1], prows[:1, :1500])
    assert torch.equal(fresh.gather(live[:1]), store.gather(live[:1]))


# ----------------------------------------------- database checkpoints
@pytest.fixture(scope="module")
def data():
    return make_federated_dataset("speech", n_clients=N_CLIENTS, scale=0.08,
                                  seed=0)


def _cfg(**kw):
    base = dict(n_clients=N_CLIENTS, clients_per_round=4, rounds=3,
                local_epochs=1, batch_size=5, base_step_time=0.5,
                round_timeout=200.0, seed=0)
    base.update(kw)
    return base


@pytest.mark.usefixtures("one_torch_thread")
def test_checkpoint_resume(tmp_path, data):
    """``tests/test_controller.py::test_checkpoint_resume``: round counter,
    client records and the global model restored; the run continues."""
    cfg = FLConfig(**_cfg(strategy="apodotiko", rounds=2,
                          checkpoint_dir=str(tmp_path / "fl"),
                          checkpoint_every=1))
    ctl = Controller(cfg, ProxyCNN(35), data, list(paper_fleet(N_CLIENTS)),
                     device="cpu")
    ctl.run()
    ctl.checkpoint()
    cfg2 = FLConfig(**_cfg(strategy="apodotiko", rounds=4,
                           checkpoint_dir=str(tmp_path / "fl")))
    ctl2 = Controller.resume(cfg2, ProxyCNN(35), data,
                             list(paper_fleet(N_CLIENTS)), device="cpu")
    assert ctl2.db.round == 2
    durs = [c for c in ctl2.db.clients.values() if c.durations]
    assert durs  # training history survived the restart
    for name, p in ctl.params.items():
        assert torch.equal(ctl2.params[name], p), name
    m = ctl2.run()
    assert m["rounds"] >= 1  # continues from round 2
    assert ctl2.db.round == 4


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("plane", ["object", "columnar"])
def test_saved_database_equals_the_references(plane, tmp_path, data):
    """The poll loop checkpointing every round writes the reference's
    database for the same run: client records (or fleet columns), results,
    round and global-model keys; the live update rows at the same ids."""
    kw = _cfg(strategy="apodotiko", rounds=2, checkpoint_every=1,
              control_plane=plane)
    jdata = jax_dataset("speech", n_clients=N_CLIENTS, scale=0.08, seed=0)
    JaxController(JaxFLConfig(**kw, checkpoint_dir=str(tmp_path / "ref")),
                  JaxProxyCNN(35), jdata, list(jax_fleet(N_CLIENTS))).run()
    Controller(FLConfig(**kw, checkpoint_dir=str(tmp_path / "port")),
               ProxyCNN(35), data, list(paper_fleet(N_CLIENTS)),
               device="cpu").run()
    dbs = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "db.json") as f:
            dbs.append(json.load(f))
    assert dbs[0] == dbs[1]
    assert dbs[1]["round"] == 2 and dbs[1]["results"]
    if plane == "columnar":
        with np.load(tmp_path / "ref" / "fleet.npz") as a, \
                np.load(tmp_path / "port" / "fleet.npz") as b:
            assert set(a.files) == set(b.files)
            for name in a.files:
                np.testing.assert_array_equal(a[name], b[name], name)
    ids = [restore_update_store(str(tmp_path / side / UPDATE_STORE_DIRNAME))[0]
           for side in ("ref", "port")]
    np.testing.assert_array_equal(*ids)


@pytest.mark.usefixtures("one_torch_thread")
def test_scheduler_checkpoints_on_cadence_and_rehydrates_rows(tmp_path, data):
    """The Scheduler checkpoints at every ``checkpoint_every``-th closed
    round; after the run's stragglers land, a resume reserves the live rows
    at their ids with the saved values, and its pending results point at
    them."""
    root = tmp_path / "fl"
    kw = _cfg(strategy="apodotiko", rounds=3, checkpoint_every=2,
              checkpoint_dir=str(root))
    sched = Scheduler(FLConfig(**kw), ProxyCNN(35), data,
                      list(paper_fleet(N_CLIENTS)), device="cpu")
    saved = []
    checkpoint = sched.checkpoint

    def counted():
        saved.append(sched.db.round)
        checkpoint()

    sched.checkpoint = counted
    sched.run()
    assert saved == [2]
    # land the in-flight stragglers, so the checkpoint holds live rows
    while sched.loop.step():
        pass
    checkpoint()
    ids, rows, _ = restore_update_store(str(root / UPDATE_STORE_DIRNAME))
    assert len(ids)
    res = Scheduler.resume(FLConfig(**dict(kw, rounds=4)), ProxyCNN(35),
                           data, list(paper_fleet(N_CLIENTS)), device="cpu")
    assert res.db.round == 3
    assert set(map(int, res.store.live_rows())) == set(map(int, ids))
    np.testing.assert_array_equal(res.store.gather(ids).numpy(), rows)
    pending = {r.update_row for r in res.db.results if not r.aggregated}
    assert pending == set(map(int, ids))
    res.run()
    assert res.db.round == 4


@pytest.mark.usefixtures("one_torch_thread")
def test_resume_across_update_planes_is_refused(tmp_path, data):
    root = str(tmp_path / "fl")
    kw = _cfg(strategy="apodotiko", rounds=1, checkpoint_dir=root)
    ctl = Controller(FLConfig(**kw), ProxyCNN(35), data,
                     list(paper_fleet(N_CLIENTS)), device="cpu")
    ctl.run()
    while ctl.loop.step():      # land the stragglers: pending results
        pass
    ctl.checkpoint()
    assert any(not r.aggregated for r in ctl.db.results)
    with pytest.raises(ValueError, match="cfg.update_plane='device'"):
        Controller.resume(FLConfig(**dict(kw, update_plane="blob")),
                          ProxyCNN(35), data, list(paper_fleet(N_CLIENTS)),
                          device="cpu")
