"""FL mesh plane over ``torch.distributed`` (twin of
``repro.sharding.flmesh``).

One mesh spec, ``"<data>x<model>"``, governs three layouts, as in the
reference:

  * the ``UpdateStore`` ``[capacity, W]`` row buffer is sharded
    ``ROW_SPEC = P("data", "model")``: each rank holds a
    ``[capacity/data, W/model]`` tile, rows dealt cyclically over ``data``
    (row ``r`` on data rank ``r % data``, so a capacity doubling moves no
    row) and the row width cut into ``model`` column stripes;
  * the cohort's lanes are split over ``data`` (``core.client``): data rank
    ``i`` trains lanes ``[i*Kp/data, (i+1)*Kp/data)`` against its own whole
    ``DatasetStore`` (the reference's replicated ``P()`` layout: every rank
    builds its copy, so nothing is placed); ranks that share a data
    coordinate train the same lanes, as the reference's replicated
    ``model`` axis does;
  * aggregation is the ``staleness_agg`` kernel over each rank's tile, an
    all-reduce of the partial sums over ``data`` and an all-gather of the
    column stripes over ``model`` (``kernels.ops.aggregate_rows_psum``).

JAX runs a mesh from one process; the port takes PyTorch's idiom, one
process per rank. Every rank runs the whole host engine (selection, the
database, the simulated platform, traffic) from ``cfg.seed``'s numpy RNG,
so every rank computes the same host trace. The caller starts the process
group (``torchrun --nproc-per-node N``, or ``init_process_group`` itself)
before building an engine: this module never initializes one and never
picks a backend. Rank ``r`` sits at ``(r // model, r % model)``.

``"1x1"`` (the default) is the single-device path: ``build_fl_mesh``
returns ``None``, reads no process group, and every 1x1 trace stays
bit-identical. Wider meshes give the same host traces, not the same
bits: the partial sums reassociate the aggregate, and on a card a data
rank's smaller lane batch rounds near-zero gradients differently, which
Adam's normalized first steps magnify to +-lr.

The collectives live here and nowhere else: ``all_reduce_data``,
``all_gather_data``, ``all_gather_model``, and for durable runs and
database checkpoints (one writer, rank 0) ``barrier`` and
``broadcast_object``. A group whose backend for CUDA tensors is gloo gets
a CUDA tensor through an explicit host copy (gloo does not take CUDA
tensors for every collective); those bytes are counted in
``FLMesh.host_bytes``, as are the bytes of a broadcast object on such a
group (gloo carries them through the host). The route is chosen by the
group's backend, never by a ``try``.
"""
from __future__ import annotations

import math
import os
import pickle
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.rules import P

#: the update-row buffer layout: [capacity over "data", W over "model"]
ROW_SPEC = P("data", "model")


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"<data>x<model>"`` -> ``(data, model)`` with validation."""
    parts = str(spec).lower().split("x")
    try:
        if len(parts) != 2:
            raise ValueError(spec)
        d, m = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"unknown mesh spec {spec!r} (expected '<data>x<model>', "
            "e.g. '1x1', '2x4', or 'auto')") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh spec {spec!r} has a non-positive axis")
    return d, m


def resolve_mesh(spec: str) -> str:
    """'1x1' (``"auto"``, ``None`` and ``""`` too: the single-device path)
    | '<data>x<model>'. Unlike the reference, no environment variable is
    read. Bad specs raise here."""
    if spec in (None, "", "auto"):
        spec = "1x1"
    parse_mesh(spec)
    return spec


def _cuda_backend(group) -> str:
    """The backend a group runs CUDA tensors on: ``"gloo"``, ``"nccl"``,
    or the ``cuda:`` entry of a per-device string such as
    ``"cpu:gloo,cuda:nccl"``."""
    name = str(dist.get_backend(group))
    if ":" not in name:
        return name
    table = dict(part.split(":", 1) for part in name.split(","))
    return table.get("cuda", "")


class FLMesh:
    """This rank's place on a ``(data, model)`` mesh of processes: the axis
    sizes, its coordinates, the two subgroups it belongs to (the ranks
    that share its model coordinate, over which ``data`` collectives run,
    and the ranks that share its data coordinate), its device, and what
    its collectives cost (``host_bytes`` staged through the host,
    ``collective_s`` on the host clock, ``n_collectives``)."""

    axis_names = ("data", "model")

    def __init__(self, spec: str, device: torch.device):
        d, m = parse_mesh(spec)
        self.spec = spec
        self.data, self.model = d, m
        self.rank = dist.get_rank()
        self.data_index, self.model_index = divmod(self.rank, m)
        self.device = device
        self.world = dist.group.WORLD
        # every rank makes every subgroup, in the same order
        self.data_group = self.model_group = None
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)])
            if j == self.model_index:
                self.data_group = g
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)])
            if i == self.data_index:
                self.model_group = g
        self.backend = str(dist.get_backend(self.world))
        self.stages = (device.type == "cuda"
                       and _cuda_backend(self.world) == "gloo")
        self.host_bytes = 0
        self.collective_s = 0.0
        self.n_collectives = 0

    @property
    def shape(self) -> dict:
        """Axis name -> size (what ``sharding.rules.mesh_shape`` reads)."""
        return {"data": self.data, "model": self.model}

    def counters(self) -> dict:
        return {"mesh_host_bytes": self.host_bytes,
                "mesh_collective_s": self.collective_s,
                "mesh_collectives": self.n_collectives}

    def __repr__(self) -> str:
        return (f"FLMesh({self.spec!r}, rank={self.rank} at "
                f"({self.data_index}, {self.model_index}), {self.device}, "
                f"{self.backend})")


_MESHES: dict = {}


def rank_device(device=None) -> torch.device:
    """A mesh rank's device: the one named, or ``cuda:<LOCAL_RANK>``
    (torchrun's variable; the global rank without it), which must exist.
    Nothing falls back to the CPU."""
    if device is not None:
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"mesh rank with LOCAL_RANK {local} has no card ({n} visible): "
            "run one process per card, or pass a device by name")
    return resolve_device(f"cuda:{local}")


def build_fl_mesh(spec: str, device=None) -> Optional[FLMesh]:
    """The mesh for ``spec`` on this rank, or ``None`` for 1x1, which
    constructs nothing and reads no process group. Any other spec needs
    the caller's default process group of exactly ``data * model`` ranks,
    or raises ``ValueError``. One mesh object per (spec, device) for the
    lifetime of the default group, so its subgroups are made once."""
    d, m = parse_mesh(resolve_mesh(spec))
    if (d, m) == (1, 1):
        return None
    n = d * m
    launch = (f"start {n} ranks with `torchrun --nproc-per-node {n}`, or "
              f"call torch.distributed.init_process_group(backend, ...) "
              f"with world_size={n} in each, before building the engine")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"mesh {spec!r} needs a process group of {n} "
                         f"ranks and none is initialized: {launch}")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {spec!r} needs {n} ranks but the process "
                         f"group has {dist.get_world_size()}: {launch}")
    dev = rank_device(device)
    key = (spec, str(dev))
    mesh = _MESHES.get(key)
    if mesh is None or mesh.world is not dist.group.WORLD:
        mesh = _MESHES[key] = FLMesh(spec, dev)
    return mesh


def mesh_axes(mesh: Optional[FLMesh]) -> tuple[int, int]:
    """``(data, model)`` axis sizes of any mesh with a ``.shape`` mapping;
    ``(1, 1)`` for the no-mesh path."""
    if mesh is None:
        return (1, 1)
    return int(mesh.shape["data"]), int(mesh.shape["model"])


def row_align(mesh: Optional[FLMesh], base: int) -> int:
    """Row-width alignment: the kernel block, additionally divisible by the
    ``model`` axis so every rank owns an equal column stripe."""
    d, m = mesh_axes(mesh)
    return math.lcm(base, m)


def capacity_align(mesh: Optional[FLMesh], base: int) -> int:
    """Capacity alignment: the fp32 sublane, additionally divisible by the
    ``data`` axis so every rank owns an equal share of rows."""
    d, m = mesh_axes(mesh)
    return math.lcm(base, d)


# ------------------------------------------------------------ collectives
def _collective(mesh: FLMesh, x: torch.Tensor, run) -> torch.Tensor:
    """Run ``run(host_or_device_tensor) -> tensor`` on ``x``, staged through
    the host when the group's backend cannot take ``x`` on its device, and
    count it. A staged call starts its timer with the card drained, so it
    holds the copies and the exchange, not earlier queued work; an
    unstaged CUDA call's time is its enqueue."""
    staged = mesh.stages and x.is_cuda
    if staged:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    if staged:
        out = run(x.cpu())
        mesh.host_bytes += x.numel() * x.element_size()
        mesh.host_bytes += out.numel() * out.element_size()
        out = out.to(x.device)
    else:
        out = run(x.contiguous())
    mesh.collective_s += time.perf_counter() - t0
    mesh.n_collectives += 1
    return out


def all_reduce_data(x: torch.Tensor, mesh: FLMesh) -> torch.Tensor:
    """The sum of ``x`` over the ``data`` axis, on every rank of it (a new
    tensor; ``x`` is left as it is)."""
    if mesh.data == 1:
        return x

    def run(t):
        t = t.clone()
        dist.all_reduce(t, group=mesh.data_group)
        return t

    return _collective(mesh, x, run)


def _all_gather(x: torch.Tensor, mesh: FLMesh, group, n: int, dim: int
                ) -> torch.Tensor:
    if n == 1:
        return x

    def run(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    return _collective(mesh, x, run)


def all_gather_data(x: torch.Tensor, mesh: FLMesh) -> torch.Tensor:
    """Every data rank's ``x``, concatenated along dim 0 in data order."""
    return _all_gather(x, mesh, mesh.data_group, mesh.data, 0)


def all_gather_model(x: torch.Tensor, mesh: FLMesh) -> torch.Tensor:
    """Every model rank's ``x``, concatenated along the last dim in model
    order: column stripes back into whole rows."""
    return _all_gather(x, mesh, mesh.model_group, mesh.model, -1)


def is_writer(mesh: Optional[FLMesh]) -> bool:
    """Whether this process writes a run's files: always without a mesh,
    rank 0 alone under one."""
    return mesh is None or mesh.rank == 0


def _on_card(mesh: FLMesh) -> bool:
    """Whether the group runs this rank's collectives on its card (NCCL),
    not on the host."""
    return mesh.device.type == "cuda" and _cuda_backend(mesh.world) == "nccl"


def barrier(mesh: FLMesh) -> None:
    """Every rank waits here until all have arrived: no rank passes a
    commit point (a snapshot's manifest, a checkpoint, the journal's last
    record) before rank 0 has made it durable."""
    t0 = time.perf_counter()
    if _on_card(mesh):
        dist.barrier(group=mesh.world, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.world)
    mesh.collective_s += time.perf_counter() - t0
    mesh.n_collectives += 1


def broadcast_object(obj, mesh: FLMesh):
    """Rank 0's ``obj`` (a small picklable host object: a decision, a
    snapshot's sequence number) on every rank; the other ranks' ``obj`` is
    ignored. Carried on the host for gloo (its pickled bytes counted in
    ``host_bytes`` when the mesh stages), on the card for NCCL."""
    t0 = time.perf_counter()
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.world, device=(
        mesh.device if _on_card(mesh) else torch.device("cpu")))
    if mesh.stages:
        mesh.host_bytes += len(pickle.dumps(box[0]))
    mesh.collective_s += time.perf_counter() - t0
    mesh.n_collectives += 1
    return box[0]
