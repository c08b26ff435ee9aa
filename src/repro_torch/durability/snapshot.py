"""Coordinated multi-plane snapshots (twin of ``repro.durability.snapshot``).

One snapshot captures *every* RNG stream and every piece of mutable
engine state at a round-close boundary, so ``build_engine`` +
``install_snapshot`` reconstructs a runtime whose subsequent execution
is bit-identical to the uncrashed run:

  * the database (``Database.save``: fleet columns / client records,
    results, blobs, quarantine state, round counter, global-model keys);
  * the global model parameters (``save_pytree`` of the card tensors,
    copied to the host — *not* ``put_global_model``, which would mutate
    the database);
  * the update store: capacity, the exact LIFO free-list order (future
    ``alloc`` calls must pop the same ids), and the live rows — both
    pending-result rows and rows still owned by in-flight payloads
    (which ``FLRuntime.checkpoint`` does not persist);
  * platform state (warm/busy instance clocks, the legacy-noise PCG64
    position, the fault model's RNG, the full invocation log);
  * the in-flight registry in dict-insertion order with each
    invocation's loop-event sequence number (completion events are
    re-scheduled in that order on restore so heap tie-breaks are
    preserved), plus refcounted payloads and un-landed blob payloads;
  * the scheduler extras: the timer heap (tags re-bound to restored
    ``Inflight`` objects; retry tags reconstructed), the timer sequence
    cursor, per-round flags, and event counters;
  * every policy/strategy RNG and adaptation state via their
    ``state_dict``/``load_state`` protocol (selection RNG, adapter
    phase, adaptive CR history, recovery attempts/budget/jitter RNG);
  * the trainer's ``torch.Generator`` state (its full bytes), SCAFFOLD
    variates, traffic cursor, accumulated metrics counters, history, and
    the simulated clock.

Params, SCAFFOLD's ``c_global`` / ``c_buf`` and the store's live rows are
saved as host arrays and come back as tensors on the engine's device; the
columnar fleet's device score state comes back there too
(``FleetStore.from_state``). Blob-plane payloads are host numpy trees and
stay on the host.

Under a mesh (``sharding.flmesh``) rank 0 alone writes a snapshot: the
live rows are gathered whole from every rank's tile first, and every rank
restores its own tile of them (``install_snapshot``). The free list and
live set are global, the same on every rank.

Atomicity: files land in the final ``snap_<seq>`` directory, but the
manifest — with per-file size + CRC32 — is written last (tmp +
``os.replace``). A directory without a valid manifest, or whose files
fail their CRCs, is ignored by ``find_latest_snapshot``; resume then
falls back to the next older snapshot or to genesis.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.core.database import Database, _flatten, _treedef, _unflatten
from repro_torch.core.services import Inflight, _Payload
from repro_torch.core.update_store import UpdateStore
from repro_torch.faas.hardware import HardwareProfile
from repro_torch.sharding import flmesh

SNAP_PREFIX = "snap_"
MANIFEST = "MANIFEST.json"
SNAPSHOT_VERSION = 1


def _rng_state(rng: np.random.Generator) -> dict:
    return rng.bit_generator.state


def _set_rng_state(rng: np.random.Generator, state: dict) -> None:
    rng.bit_generator.state = state


def _profile_tuple(p: HardwareProfile) -> list:
    return [p.name, p.speed, p.vcpus, p.mem_gib, p.is_gpu, p.gpu_fraction,
            p.variability]


def _profile_from(t) -> HardwareProfile:
    name, speed, vcpus, mem, is_gpu, gfrac, var = t
    return HardwareProfile(name, speed=speed, vcpus=vcpus, mem_gib=mem,
                           is_gpu=bool(is_gpu), gpu_fraction=gfrac,
                           variability=var)


# ----------------------------------------------------------------- capture

def capture_state(rt) -> Tuple[dict, dict]:
    """The JSON-serializable runtime state plus a dict of numpy arrays
    (blob-plane in-flight payloads) destined for ``inflight_blobs.npz``."""
    state: dict = {"version": SNAPSHOT_VERSION, "engine": rt.engine_name}
    state["now"] = rt.loop.now
    state["t0"] = getattr(rt, "_t0", 0.0)
    state["acc"] = getattr(rt, "_acc", 0.0)
    state["history"] = [dataclasses.asdict(l) for l in rt.history]
    state["completed"] = sorted(rt._completed_this_round)
    state["counters"] = {
        "n_hedges": rt.n_hedges, "n_hedge_wins": rt.n_hedge_wins,
        "n_cancelled": rt.n_cancelled, "n_retries": rt.n_retries,
        "n_timeouts": rt.n_timeouts, "n_quarantined": rt.n_quarantined,
        "retry_latency_s": rt.retry_latency_s,
        "update_host_bytes": rt.update_host_bytes,
        "data_h2d_bytes": rt.trainer.data_h2d_bytes,
        "n_traffic_joins": rt.n_traffic_joins,
        "n_traffic_leaves": rt.n_traffic_leaves,
    }
    state["traffic_pos"] = rt._traffic_pos
    state["platform"] = rt.platform.state_dict()
    state["trainer_key"] = rt.trainer.generator.get_state().tolist()
    state["c_cap"] = rt._c_cap

    # hardware universe: fleet order + id->position map; profiles of
    # removed clients survive only in _hw_history (metrics need them)
    state["fleet"] = [_profile_tuple(p) for p in rt.fleet]
    state["fleet_pos"] = [[cid, pos] for cid, pos in rt._fleet_pos.items()]
    state["hw_extra"] = [[cid, _profile_tuple(p)]
                         for cid, p in rt._hw_history.items()
                         if cid not in rt._fleet_pos]

    # in-flight registry: dict/list order is behavioural (DatabaseView
    # iteration, hedge-sort stability), so serialize it verbatim; the
    # loop-event seq per invocation orders the re-scheduled completions
    rec_index = {id(r): i for i, r in enumerate(rt.platform.invocations)}
    payload_ids: dict = {}
    payloads: List[dict] = []
    blob_arrays: dict = {}
    inflight_ser: List[list] = []
    inv_gidx: dict = {}
    for cid, invs in rt.inflight.items():
        entries = []
        for inv in invs:
            pid = payload_ids.get(id(inv.payload))
            if pid is None:
                pid = len(payloads)
                payload_ids[id(inv.payload)] = pid
                pay = inv.payload
                payloads.append({"row": pay.row, "refs": pay.refs,
                                 "landed": pay.landed,
                                 "has_blob": pay.blob is not None})
                if pay.blob is not None:
                    leaves, _ = _flatten(pay.blob)
                    for i, leaf in enumerate(leaves):
                        blob_arrays[f"p{pid}|{i}"] = np.asarray(leaf)
                    blob_arrays[f"p{pid}|treedef"] = np.array(
                        json.dumps(_treedef(pay.blob)))
            inv_gidx[id(inv)] = len(inv_gidx)
            entries.append({
                "client_id": inv.client_id, "round": inv.round,
                "steps": inv.steps, "t_invoked": inv.t_invoked,
                "rec": rec_index[id(inv.rec)], "payload": pid,
                "n_samples": inv.n_samples, "loss": inv.loss,
                "is_hedge": inv.is_hedge, "eseq": inv.event.seq})
        inflight_ser.append([cid, entries])
    state["payloads"] = payloads
    state["inflight"] = inflight_ser

    # update store: live rows = pending-result rows + in-flight payload
    # rows (the latter are invisible to the database)
    if rt.store is not None:
        ids: List[int] = []
        seen = set()
        for r in rt.db.results:
            if not r.aggregated and r.update_row >= 0:
                if r.update_row not in seen:
                    seen.add(r.update_row)
                    ids.append(int(r.update_row))
        for p in payloads:
            if p["row"] >= 0 and not p["landed"] and p["row"] not in seen:
                seen.add(p["row"])
                ids.append(int(p["row"]))
        state["store"] = {"capacity": rt.store.capacity,
                          "free": [int(i) for i in rt.store._free],
                          "ids": ids}
    else:
        state["store"] = None

    # policy / strategy state (RNG positions, adapter phase, CR history,
    # recovery attempts) via the state_dict protocol
    if hasattr(rt, "policy"):
        state["policy"] = rt.policy.state_dict()
    else:
        state["policy"] = {"strategy": rt.strategy.state_dict()}

    # scheduler extras: timer heap + cursors. Stale timers (closed round
    # or settled invocation) are dropped here — identical to the lazy
    # purge ``_peek_timer`` would apply before ever firing them.
    if hasattr(rt, "_timers"):
        timers = []
        max_seq = -1
        for (t, seq, round_, tag) in rt._timers:
            max_seq = max(max_seq, seq)
            if round_ < rt.db.round and not _runtime_round(round_):
                continue
            if isinstance(tag, Inflight):
                if tag.done:
                    continue
                ser_tag = {"kind": "inflight", "v": inv_gidx[id(tag)]}
            elif isinstance(tag, str):
                ser_tag = {"kind": "str", "v": tag}
            else:   # _RetryTag
                ser_tag = {"kind": "retry", "client_id": tag.client_id,
                           "t_failed": tag.t_failed}
            timers.append({"t": t, "seq": seq, "round": round_,
                           "tag": ser_tag})
        state["scheduler"] = {
            "timers": timers, "next_timer_seq": max_seq + 1,
            "invoked_this_round": rt._invoked_this_round,
            "n_events": rt.n_events, "n_coalesced": rt.n_coalesced,
            "megastep_rounds": rt.megastep_rounds,
            "megastep_scans": rt.megastep_scans,
            "megastep_fallback_reason": rt.megastep_fallback_reason}
    else:
        state["scheduler"] = None
    return state, blob_arrays


def _runtime_round(round_: int) -> bool:
    return round_ >= (1 << 62)


# ------------------------------------------------------------------ write

def snapshot_dir(root: str, seq: int) -> str:
    return os.path.join(root, f"{SNAP_PREFIX}{seq:010d}")


def write_snapshot(rt, root: str, seq: int, *, keep: int = 2) -> bool:
    """Write the coordinated snapshot for journal seq ``seq``. Returns
    False (untouched) if a manifest already exists for it — a resumed
    run re-reaches the same boundary idempotently.

    Under a mesh every rank calls this at the same boundary: rank 0
    decides whether the manifest exists and broadcasts it, every rank
    joins the gather of the live rows (each holds only its tile), rank 0
    alone writes the files, and all ranks meet at a barrier once the
    manifest is durable."""
    mesh = rt.mesh
    writer = flmesh.is_writer(mesh)
    d = snapshot_dir(root, seq)
    exists = writer and os.path.exists(os.path.join(d, MANIFEST))
    if mesh is not None:
        exists = flmesh.broadcast_object(exists, mesh)
    if exists:
        return False

    rt.db.meta["update_plane"] = rt.update_plane
    with tracing.span("snapshot.gather"):
        state, blob_arrays = capture_state(rt)
        rows = None
        if state["store"] is not None and state["store"]["ids"]:
            rows = rt.store.gather(state["store"]["ids"]).cpu().numpy()
    if writer:
        with tracing.span("snapshot.write"):
            _write_files(rt, d, seq, state, blob_arrays, rows)
            _gc_snapshots(root, keep)
    if mesh is not None:
        flmesh.barrier(mesh)
    return True


def _write_files(rt, d: str, seq: int, state: dict, blob_arrays: dict,
                 rows) -> None:
    """The snapshot's files in ``d``, its manifest last."""
    os.makedirs(d, exist_ok=True)
    rt.db.save(os.path.join(d, "db"))
    save_pytree(rt.params, os.path.join(d, "params"))
    if rt.c_global is not None:
        save_pytree({"c_global": rt.c_global, "c_buf": rt.c_buf},
                    os.path.join(d, "scaffold"))
        state["has_scaffold"] = True
    else:
        state["has_scaffold"] = False
    if blob_arrays:
        with open(os.path.join(d, "inflight_blobs.npz"), "wb") as f:
            np.savez(f, **blob_arrays)
    if rows is not None:
        with open(os.path.join(d, "rows.npz"), "wb") as f:
            np.savez(f, rows=rows, n_params=np.int64(rt.spec.n_params))
    with open(os.path.join(d, "runtime.json"), "w") as f:
        json.dump(state, f)

    # manifest last: its presence is the commit point
    files = {}
    for dirpath, _, names in os.walk(d):
        for name in names:
            if name == MANIFEST:
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, d)
            with open(full, "rb") as f:
                data = f.read()
            files[rel] = {"crc": zlib.crc32(data), "size": len(data)}
    manifest = {"version": SNAPSHOT_VERSION, "seq": seq,
                "round": rt.db.round, "engine": rt.engine_name,
                "files": files}
    tmp = os.path.join(d, ".manifest.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, MANIFEST))


def _gc_snapshots(root: str, keep: int) -> None:
    seqs = list_snapshots(root)
    for seq in seqs[:-keep] if keep else seqs:
        shutil.rmtree(snapshot_dir(root, seq), ignore_errors=True)


def list_snapshots(root: str) -> List[int]:
    out = []
    for name in os.listdir(root):
        if name.startswith(SNAP_PREFIX):
            try:
                out.append(int(name[len(SNAP_PREFIX):]))
            except ValueError:
                continue
    return sorted(out)


# ------------------------------------------------------------------- read

@dataclass
class SnapshotRef:
    seq: int
    path: str


def validate_snapshot(path: str) -> bool:
    """Manifest present and every file matches its recorded size+CRC."""
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for rel, info in manifest["files"].items():
            full = os.path.join(path, rel)
            with open(full, "rb") as f:
                data = f.read()
            if len(data) != info["size"] or zlib.crc32(data) != info["crc"]:
                return False
        return True
    except (OSError, ValueError, KeyError):
        return False


def find_latest_snapshot(root: str, *, max_seq: Optional[int] = None
                         ) -> Optional[SnapshotRef]:
    """Newest *valid* snapshot with seq <= max_seq. A snapshot whose
    journal record is itself past the consistent prefix is unusable:
    the journal is written first, so such a snapshot implies the prefix
    was torn — fall back past it."""
    for seq in reversed(list_snapshots(root)):
        if max_seq is not None and seq > max_seq:
            continue
        d = snapshot_dir(root, seq)
        if validate_snapshot(d):
            return SnapshotRef(seq=seq, path=d)
    return None


def load_snapshot(path: str, device=None) -> Tuple[dict, Database, Any]:
    """(runtime state, database, global params as host arrays) from a
    validated snapshot directory; the columnar fleet's device state goes
    to ``device`` (None: the card)."""
    with open(os.path.join(path, "runtime.json")) as f:
        state = json.load(f)
    db = Database.load(os.path.join(path, "db"), device=device)
    params = restore_pytree(os.path.join(path, "params"))
    return state, db, params


# ---------------------------------------------------------------- install

def install_snapshot(rt, state: dict, path: str) -> None:
    """Overwrite a freshly built engine's live state with the snapshot.
    The engine was constructed with the snapshot's database and params
    already (``build_engine(..., db=..., init_params=...)``); this
    restores everything the constructor derives freshly."""
    if state["engine"] != rt.engine_name:
        raise ValueError(
            f"snapshot was written by engine {state['engine']!r} but the "
            f"resume is configured for {rt.engine_name!r}")
    rt.loop.now = state["now"]
    rt._t0 = state["t0"]
    rt._acc = state["acc"]
    from repro_torch.core.services import RoundLog
    rt.history = [RoundLog(**d) for d in state["history"]]
    rt._completed_this_round = set(int(c) for c in state["completed"])
    c = state["counters"]
    rt.n_hedges = c["n_hedges"]
    rt.n_hedge_wins = c["n_hedge_wins"]
    rt.n_cancelled = c["n_cancelled"]
    rt.n_retries = c["n_retries"]
    rt.n_timeouts = c["n_timeouts"]
    rt.n_quarantined = c["n_quarantined"]
    rt.retry_latency_s = c["retry_latency_s"]
    rt.update_host_bytes = c["update_host_bytes"]
    rt.trainer.data_h2d_bytes = c["data_h2d_bytes"]
    rt.n_traffic_joins = c["n_traffic_joins"]
    rt.n_traffic_leaves = c["n_traffic_leaves"]
    rt._traffic_pos = int(state["traffic_pos"])
    rt.platform.load_state(state["platform"])
    rt.trainer.generator.set_state(
        torch.tensor(state["trainer_key"], dtype=torch.uint8))

    fleet = [_profile_from(t) for t in state["fleet"]]
    rt.fleet = fleet
    rt._fleet_pos = {int(cid): int(pos) for cid, pos in state["fleet_pos"]}
    rt.hw = {cid: fleet[pos] for cid, pos in rt._fleet_pos.items()}
    rt._hw_history = dict(rt.hw)
    for cid, t in state["hw_extra"]:
        rt._hw_history[int(cid)] = _profile_from(t)

    if state["has_scaffold"]:
        sc = restore_pytree(os.path.join(path, "scaffold"))
        rt.c_global = torch.as_tensor(sc["c_global"]).to(rt.device)
        rt.c_buf = torch.as_tensor(sc["c_buf"]).to(rt.device)
        rt._c_cap = int(state["c_cap"])

    # update store: exact capacity and free-list order so future allocs
    # pop the same ids the uncrashed run would; under a mesh each rank
    # writes only its own tile of the saved whole rows
    st = state["store"]
    if st is not None:
        store = UpdateStore(rt.spec.n_params, capacity=st["capacity"],
                            device=rt.device, mesh=rt.mesh)
        if store.capacity != st["capacity"]:
            raise ValueError("update-store capacity mismatch on restore")
        ids = [int(i) for i in st["ids"]]
        if ids:
            with np.load(os.path.join(path, "rows.npz")) as data:
                rows = data["rows"]
            store.write_at(ids, rows)
        store._free = [int(i) for i in st["free"]]
        store._live = set(ids)
        rt.store = store

    # in-flight registry + payloads; completions re-scheduled in saved
    # event-seq order so loop tie-breaks replay identically
    blob_payloads: dict = {}
    bpath = os.path.join(path, "inflight_blobs.npz")
    if os.path.exists(bpath):
        data = np.load(bpath, allow_pickle=False)
        groups: dict = {}
        for name in data.files:
            key, idx = name.rsplit("|", 1)
            groups.setdefault(key, {})[idx] = data[name]
        for key, parts in groups.items():
            tdef = json.loads(str(parts.pop("treedef")))
            leaves = [parts[str(i)] for i in range(len(parts))]
            blob_payloads[int(key[1:])] = _unflatten(tdef, leaves)
    payload_objs = []
    for pid, p in enumerate(state["payloads"]):
        payload_objs.append(_Payload(row=int(p["row"]), refs=int(p["refs"]),
                                     landed=bool(p["landed"]),
                                     blob=blob_payloads.get(pid)))
    rt.inflight = {}
    ordered: List[Tuple[int, Inflight]] = []
    flat_invs: List[Inflight] = []
    for cid, entries in state["inflight"]:
        lst = []
        for e in entries:
            inv = Inflight(
                client_id=int(e["client_id"]), round=int(e["round"]),
                steps=e["steps"], t_invoked=e["t_invoked"],
                rec=rt.platform.invocations[int(e["rec"])],
                payload=payload_objs[int(e["payload"])],
                n_samples=int(e["n_samples"]), loss=e["loss"],
                is_hedge=bool(e["is_hedge"]))
            lst.append(inv)
            ordered.append((int(e["eseq"]), inv))
            flat_invs.append(inv)
        rt.inflight[int(cid)] = lst
    for _, inv in sorted(ordered, key=lambda p: p[0]):
        inv.event = rt.loop.schedule(
            inv.rec.t_completed - rt.loop.now,
            (lambda inv=inv: rt._complete(inv)))

    # policy / strategy
    if hasattr(rt, "policy"):
        rt.policy.load_state(state["policy"])
    else:
        rt.strategy.load_state(state["policy"]["strategy"])

    # scheduler timer heap + cursors
    sch = state["scheduler"]
    if sch is not None:
        import heapq
        import itertools
        from repro_torch.core.scheduler import _RetryTag
        timers = []
        for tm in sch["timers"]:
            tag = tm["tag"]
            if tag["kind"] == "inflight":
                obj = flat_invs[int(tag["v"])]
            elif tag["kind"] == "str":
                obj = tag["v"]
            else:
                obj = _RetryTag(int(tag["client_id"]), tag["t_failed"])
            timers.append((tm["t"], int(tm["seq"]), int(tm["round"]), obj))
        heapq.heapify(timers)
        rt._timers = timers
        rt._timer_seq = itertools.count(int(sch["next_timer_seq"]))
        rt._invoked_this_round = bool(sch["invoked_this_round"])
        rt.n_events = int(sch["n_events"])
        rt.n_coalesced = int(sch["n_coalesced"])
        rt.megastep_rounds = int(sch["megastep_rounds"])
        rt.megastep_scans = int(sch["megastep_scans"])
        rt.megastep_fallback_reason = sch["megastep_fallback_reason"]
