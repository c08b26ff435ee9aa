"""The port's mesh plane in one process, with no process group: mesh
specs, alignment and every refusal, against ``repro.sharding.flmesh``
where the reference has the same function. The group itself runs in
``tests/test_torch_mesh_plane.py``."""
import numpy as np
import pytest

from repro.sharding import flmesh as jflmesh
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import build_engine
from repro_torch.core.services import FLConfig, _check_supported
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.proxy_models import ProxyCNN
from repro_torch.sharding import flmesh, rules
from repro_torch.sweep import SweepSpec, run_sweep

GOOD = ("1x1", "2x4", "16X16", "3x2")
BAD = ("", "2", "2x", "x4", "2x4x2", "axb", "0x4", "2x-1", "auto")


class _Shape:
    """Shape-only stand-in: the alignment helpers read only ``.shape``."""

    def __init__(self, d, m):
        self.shape = {"data": d, "model": m}


@pytest.mark.parametrize("spec", GOOD)
def test_parse_mesh_accepts_the_references_specs(spec):
    assert flmesh.parse_mesh(spec) == jflmesh.parse_mesh(spec)


@pytest.mark.parametrize("spec", BAD)
def test_parse_mesh_rejects_the_references_specs(spec):
    with pytest.raises(ValueError):
        jflmesh.parse_mesh(spec)
    with pytest.raises(ValueError, match="mesh spec"):
        flmesh.parse_mesh(spec)


def test_resolve_mesh_reads_no_environment(monkeypatch):
    """``"auto"``, ``None`` and ``""`` are 1x1 without reading
    ``REPRO_MESH`` (the reference reads it); explicit specs pass, bad ones
    raise."""
    monkeypatch.setenv("REPRO_MESH", "2x2")
    for spec in ("auto", None, ""):
        assert flmesh.resolve_mesh(spec) == "1x1"
    monkeypatch.delenv("REPRO_MESH")
    for spec in ("auto", None, "2x4", "1x1"):
        assert flmesh.resolve_mesh(spec) == jflmesh.resolve_mesh(spec)
    with pytest.raises(ValueError):
        flmesh.resolve_mesh("nonsense")


@pytest.mark.parametrize("d, m", [(2, 4), (3, 2), (1, 1)])
def test_alignment_is_the_references(d, m):
    """``row_align`` / ``capacity_align`` at the kernel block and the
    sublane (and the reference test's 128), and the axes a ``DeviceMesh``
    -free rule engine reads off the same shape."""
    mine, ref = _Shape(d, m), jflmesh.build_fl_mesh("1x1")
    for base in (128, 1024):
        assert flmesh.row_align(mine, base) == jflmesh.row_align(
            _Shape(d, m), base) == np.lcm(base, m)
    assert flmesh.capacity_align(mine, 8) == jflmesh.capacity_align(
        _Shape(d, m), 8) == np.lcm(8, d)
    assert flmesh.mesh_axes(mine) == jflmesh.mesh_axes(_Shape(d, m))
    assert rules.mesh_shape(mine) == {"data": d, "model": m}
    assert ref is None and flmesh.build_fl_mesh("1x1") is None
    assert flmesh.mesh_axes(None) == (1, 1)
    assert flmesh.ROW_SPEC == ("data", "model")


def test_a_mesh_without_a_process_group_raises_naming_torchrun():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        flmesh.build_fl_mesh("2x2")
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1, mesh="2x2")
    with pytest.raises(ValueError, match="init_process_group"):
        build_engine(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                     device="cpu")


@pytest.mark.parametrize("over", [dict(update_plane="blob"),
                                  dict(data_plane="host")])
def test_the_oracle_planes_refuse_a_mesh(over):
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1, mesh="2x2",
                   **over)
    with pytest.raises(ValueError, match="requires the device update and "
                                         "data planes"):
        Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                   device="cpu")


@pytest.mark.parametrize("over", [dict(durability="journal"),
                                  dict(checkpoint_every=1,
                                       checkpoint_dir="unused")])
def test_durable_runs_and_checkpoints_under_a_mesh_raise(over):
    """A durable run and database checkpoints pass ``_check_supported``
    under a mesh and reach the process-group check: without a group, the
    ``ValueError`` naming torchrun (the runs themselves are in
    ``tests/test_torch_mesh_durability.py``)."""
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1, mesh="2x1",
                   **over)
    _check_supported(cfg)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        build_engine(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                     device="cpu")


def test_a_meshed_sweep_refuses_worker_threads():
    spec = SweepSpec(name="meshed", datasets=("mnist",),
                     strategies=("fedavg",), meshes=("2x2",))
    calls = []
    with pytest.raises(ValueError, match="one at a time"):
        run_sweep(spec, runner=calls.append, max_workers=2)
    assert not calls
