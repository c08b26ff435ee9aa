"""Durable runs: write-ahead journal + coordinated snapshots + resume (twin
of ``repro.durability``).

``FLConfig.durability="journal"`` arms a
:class:`~repro_torch.durability.manager.DurabilityManager` on the engine:
every protocol event is journaled before its effects become visible, and a
coordinated multi-plane snapshot is written at round boundaries. A run
killed at *any* event boundary resumes via :func:`resume_durable` — restore
the newest valid snapshot, re-execute deterministically, validate the
re-emitted records against the journal tail — and continues bit-identically
to the uncrashed run (on the card, the params too under
``torch.use_deterministic_algorithms(True)``: the journal carries no
training floats, so only the params see a non-deterministic kernel).

The off path (default) constructs nothing, draws no RNG, and leaves every
trace byte-identical.
"""
from __future__ import annotations

import os

from repro_torch.core.journal import JOURNAL_NAME, Journal
from repro_torch.core.services import (FLConfig, resolve_durability,
                                       resolve_durability_sync)
from repro_torch.durability.manager import (DurabilityManager,
                                            JournalDivergence,
                                            SimulatedCrash, config_digest)
from repro_torch.durability.snapshot import (find_latest_snapshot,
                                             install_snapshot,
                                             list_snapshots, load_snapshot,
                                             snapshot_dir,
                                             validate_snapshot,
                                             write_snapshot)
from repro_torch.sharding import flmesh

__all__ = [
    "DurabilityManager", "Journal", "JournalDivergence", "SimulatedCrash",
    "config_digest", "find_latest_snapshot", "install_snapshot",
    "list_snapshots", "load_snapshot", "resolve_durability",
    "resolve_durability_sync", "resume_durable", "validate_snapshot",
    "write_snapshot",
]


def resume_durable(cfg: FLConfig, model, data, fleet, device=None):
    """Rebuild a crashed durable run from ``cfg.checkpoint_dir``, on the
    card unless ``device`` says otherwise.

    Sequence: truncate any torn journal tail back to the last consistent
    prefix; refuse a journal written under another experiment config (the
    mesh included: a journal written under ``2x2`` is refused under
    ``1x1``); pick the newest valid snapshot whose journal record survives
    in that prefix (falling back to older snapshots, then to genesis);
    rebuild the engine on the snapshot's database and params; overwrite
    its live state; and arm the manager with the journal tail so
    deterministic re-execution is validated record for record before new
    appends continue.

    Under a mesh every rank of the caller's process group calls this, on
    its rank's device (``flmesh.rank_device``): rank 0 alone truncates the
    journal and picks the snapshot, and broadcasts the pick; every other
    rank then reads the truncated journal, and a barrier holds rank 0's
    next append until all have read it. Every rank restores the pick (its
    own tile of the store) and validates the same tail; rank 0 alone
    appends after it."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.device import resolve_device

    if resolve_durability(cfg.durability) != "journal":
        raise ValueError("resume_durable requires durability='journal'")
    if not cfg.checkpoint_dir:
        raise ValueError("resume_durable requires cfg.checkpoint_dir")
    mesh = flmesh.build_fl_mesh(flmesh.resolve_mesh(cfg.mesh), device)
    device = mesh.device if mesh is not None else resolve_device(device)
    root = cfg.checkpoint_dir
    jpath = os.path.join(root, JOURNAL_NAME)
    plan = None                     # rank 0's: (records, snapshot seq)
    if flmesh.is_writer(mesh) and os.path.exists(jpath):
        records, _ = Journal.truncate_to_consistent(jpath)
        last_seq = records[-1]["q"] if records else -1
        snap = find_latest_snapshot(root, max_seq=last_seq)
        plan = (records, None if snap is None else snap.seq)
    if mesh is not None:
        # rank 0 sends after its truncation; every rank has read the
        # journal before the barrier lets rank 0 append to it again
        found, snap_seq = flmesh.broadcast_object(
            (plan is not None, plan[1] if plan else None), mesh)
        if mesh.rank != 0 and found:
            plan = (Journal.read(jpath)[0], snap_seq)
        flmesh.barrier(mesh)
    if plan is None:
        # crashed before the first record (or never started): fresh run
        return build_engine(cfg, model, data, fleet, device=device)
    records, snap_seq = plan
    if records and records[0]["k"] == "genesis":
        saved = records[0]["p"]["config"]
        if saved != config_digest(cfg):
            raise ValueError(
                "journal was written under a different experiment config "
                f"(digest {saved} != {config_digest(cfg)}); refusing to "
                "resume — point checkpoint_dir elsewhere or restore the "
                "original config")
    if snap_seq is None:
        engine = build_engine(cfg, model, data, fleet, device=device)
        tail, next_seq = records, 0
    else:
        path = snapshot_dir(root, snap_seq)
        state, db, params = load_snapshot(path, device=device)
        engine = build_engine(cfg, model, data, fleet, db=db,
                              init_params=params, device=device)
        install_snapshot(engine, state, path)
        tail = [r for r in records if r["q"] > snap_seq]
        next_seq = snap_seq + 1
    engine.durability = DurabilityManager(engine, expected=tail,
                                          next_seq=next_seq)
    return engine
