"""FedLess-style database (the paper's external state store).

The real system keeps invocation records, client attributes and model
updates in MongoDB; clients and the controller communicate exclusively
through it (Algorithm 1 lines 6-7, 20-22). Here it is an in-process store
with the same record semantics plus optional persistence (JSON metadata +
NPZ parameter blobs) so the controller can crash and resume — the
fault-tolerance path exercised in tests/test_checkpoint.py.

Two **control planes** back the per-client state (DESIGN.md §10):

* ``object`` — the original dict of :class:`ClientRecord` Python objects.
  Kept verbatim as the equivalence oracle and for direct construction
  (``Database()`` defaults to it, so tests poking records keep working).
* ``columnar`` — a struct-of-arrays :class:`~repro_torch.core.fleet_store.FleetStore`
  (the runtime default via ``REPRO_CONTROL_PLANE``): status/cardinality/
  booster/EMA columns, duration ring buffers, id->slot map. Selection and
  scoring run vectorized over the columns with **bit-identical** results
  to the object plane (tests/test_control_plane.py).

Both planes expose one uniform accessor API (``mark_*``, ``has_client``,
``idle_client_ids``, ``any_idle``, ``recent_durations``, ...) — the
runtime, scheduler, and strategies speak only that API, never the record
objects, so the plane is swappable per run. ``db.clients`` remains as a
dict view: the live dict on the object plane, a materialized *snapshot*
of ClientRecords on the columnar plane (read-only by construction — for
tests and debugging, never on a hot path).

Results, update blobs, and global models are plane-independent: they are
O(clients_per_round) per round, not O(fleet).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.core.fleet_store import IDLE, RUNNING, FleetStore

FLEET_NPZ = "fleet.npz"


@dataclass
class ClientRecord:
    client_id: int
    hardware: str                      # profile name
    data_cardinality: int
    batch_size: int
    local_epochs: int
    booster: float = 1.0
    status: str = "idle"               # idle | running
    invoked_rounds: list = field(default_factory=list)
    durations: list = field(default_factory=list)   # most-recent-LAST
    n_invocations: int = 0
    n_failures: int = 0
    consec_failures: int = 0       # failures since the last landed result
    quarantined_until: int = 0     # benched until this round (exclusive;
    #                                0 = never quarantined)

    @property
    def ever_invoked(self) -> bool:
        return self.n_invocations > 0


@dataclass
class ResultRecord:
    client_id: int
    round: int                         # round the client trained against
    n_samples: int
    train_duration: float
    t_available: float                 # sim time the update landed in the DB
    aggregated: bool = False
    update_key: str = ""               # key into the parameter blob store
    update_row: int = -1               # row handle into the device-resident
    #                                    UpdateStore (update-plane path); -1
    #                                    when the update lives in a blob


class Database:
    """Transactional-enough store: every mutation goes through a method so a
    snapshot/restore pair gives a consistent view (used for FT tests)."""

    def __init__(self, control_plane: str = "object"):
        if control_plane not in ("object", "columnar"):
            raise ValueError(f"unknown control plane {control_plane!r}")
        self.control_plane = control_plane
        self._clients: dict[int, ClientRecord] = {}
        self.fleet: Optional[FleetStore] = (
            FleetStore() if control_plane == "columnar" else None)
        self.results: list[ResultRecord] = []
        self.blobs: dict[str, Any] = {}          # update pytrees (host numpy)
        self.global_models: dict[int, str] = {}  # round -> blob key
        self.round: int = 0
        self.meta: dict[str, Any] = {}

    @property
    def columnar(self) -> bool:
        return self.control_plane == "columnar"

    # ------------------------------------------------------------- clients
    @property
    def clients(self) -> dict:
        """Object plane: the live record dict. Columnar plane: a
        materialized ClientRecord snapshot (reads reflect the columns at
        call time; mutations do NOT write back — use the accessor API)."""
        if not self.columnar:
            return self._clients
        return {cid: self.materialize_client(cid)
                for cid in self.fleet.client_ids()}

    def materialize_client(self, client_id: int) -> ClientRecord:
        fs = self.fleet
        s = fs.slot_of(client_id)
        last = int(fs.last_round[s])
        return ClientRecord(
            client_id=int(client_id), hardware="",
            data_cardinality=int(fs.cardinality[s]),
            batch_size=int(fs.batch_size[s]),
            local_epochs=int(fs.local_epochs[s]),
            booster=float(fs.booster[s]),
            status="running" if fs.status[s] == RUNNING else "idle",
            invoked_rounds=[last] if last >= 0 else [],
            durations=fs.recent_durations(client_id, fs.history),
            n_invocations=int(fs.n_invocations[s]),
            n_failures=int(fs.n_failures[s]),
            consec_failures=int(fs.consec_failures[s]),
            quarantined_until=int(fs.quarantined_until[s]))

    def register_client(self, rec: ClientRecord) -> None:
        if self.columnar:
            self.fleet.add(rec.client_id, rec.data_cardinality,
                           rec.batch_size, rec.local_epochs,
                           booster=rec.booster,
                           status=RUNNING if rec.status == "running"
                           else IDLE)
            if rec.durations or rec.n_invocations or rec.n_failures:
                # pre-populated record (tests/benches seed history this
                # way): replay it into the columns so both planes score
                # the client identically
                self.fleet.install_history(
                    rec.client_id, rec.durations,
                    n_invocations=rec.n_invocations,
                    n_failures=rec.n_failures,
                    last_round=(rec.invoked_rounds[-1]
                                if rec.invoked_rounds else -1))
            if rec.consec_failures or rec.quarantined_until:
                slot = self.fleet.slot_of(rec.client_id)
                self.fleet.consec_failures[slot] = rec.consec_failures
                self.fleet.quarantined_until[slot] = rec.quarantined_until
        else:
            self._clients[rec.client_id] = rec

    def unregister_client(self, client_id: int) -> bool:
        if self.columnar:
            return self.fleet.remove(client_id)
        return self._clients.pop(client_id, None) is not None

    # ------------------------------------------------------ bulk membership
    def register_clients_bulk(self, client_ids, cardinalities, batch_size,
                              local_epochs, hardware=None) -> None:
        """Register fresh clients in one columnar append (the traffic
        plane's entry point, DESIGN.md §13). On the object plane this
        degrades to per-record dict assignment with identical insertion
        order (ids are applied in the given order on both planes)."""
        if self.columnar:
            self.fleet.add_batch(client_ids, cardinalities, batch_size,
                                 local_epochs)
            return
        hw = hardware if hardware is not None else [""] * len(client_ids)
        for cid, card, name in zip(client_ids, cardinalities, hw):
            self._clients[int(cid)] = ClientRecord(
                client_id=int(cid), hardware=name,
                data_cardinality=int(card), batch_size=int(batch_size),
                local_epochs=int(local_epochs))

    def unregister_clients_bulk(self, client_ids) -> list[int]:
        """Remove clients in one columnar scatter; returns the ids that
        were actually registered (unknown ids are skipped)."""
        if self.columnar:
            return self.fleet.remove_batch(client_ids)
        return [int(cid) for cid in client_ids
                if self._clients.pop(int(cid), None) is not None]

    def mark_running(self, client_id: int, round_: int) -> None:
        if self.columnar:
            self.fleet.mark_running(client_id, round_)
            return
        c = self._clients[client_id]
        c.status = "running"
        c.invoked_rounds.append(round_)
        c.n_invocations += 1

    def mark_complete(self, client_id: int, duration: float) -> None:
        if self.columnar:
            self.fleet.mark_complete(client_id, duration)
            return
        c = self._clients[client_id]
        c.status = "idle"
        c.durations.append(duration)
        c.consec_failures = 0           # a landed result heals the streak

    def mark_failed(self, client_id: int) -> None:
        if self.columnar:
            self.fleet.mark_failed(client_id)
            return
        c = self._clients[client_id]
        c.status = "idle"
        c.n_failures += 1
        c.consec_failures += 1

    def incr_failures(self, client_id: int) -> None:
        """Count a failure without touching status (a hedge sibling is
        still racing for this client)."""
        if self.columnar:
            self.fleet.incr_failures(client_id)
        else:
            c = self._clients[client_id]
            c.n_failures += 1
            c.consec_failures += 1

    # ------------------------------------------- recovery / circuit breaker
    def quarantine(self, client_id: int, until_round: int) -> None:
        """Bench the client until ``until_round`` (exclusive): it drops
        out of ``idle_client_ids``/``any_idle`` and every strategy's
        selection mask while ``round < until_round`` (DESIGN.md §12)."""
        if self.columnar:
            self.fleet.quarantine(client_id, until_round)
        else:
            self._clients[client_id].quarantined_until = int(until_round)

    def consecutive_failures(self, client_id: int) -> int:
        if self.columnar:
            return int(self.fleet.consec_failures[
                self.fleet.slot_of(client_id)])
        return self._clients[client_id].consec_failures

    def is_quarantined(self, client_id: int) -> bool:
        if self.columnar:
            return bool(self.fleet.quarantined_until[
                self.fleet.slot_of(client_id)] > self.round)
        return self._clients[client_id].quarantined_until > self.round

    def release_client(self, client_id: int) -> None:
        """Return a running client to idle without recording a duration
        (cancellation path)."""
        if self.columnar:
            self.fleet.set_idle(client_id)
            return
        rec = self._clients.get(client_id)
        if rec is not None and rec.status == "running":
            rec.status = "idle"

    # ------------------------------------------------ uniform fleet queries
    @property
    def n_clients(self) -> int:
        return len(self.fleet) if self.columnar else len(self._clients)

    def has_client(self, client_id: int) -> bool:
        if self.columnar:
            return self.fleet.has(client_id)
        return client_id in self._clients

    def client_ids(self) -> list[int]:
        """Registered client ids in registration order (dict order on the
        object plane, seq order on the columnar one — identical)."""
        if self.columnar:
            return self.fleet.client_ids()
        return list(self._clients)

    def idle_client_ids(self) -> list[int]:
        """Idle, non-quarantined client ids in registration order — the
        shared selection candidate list (both planes produce the identical
        list, so shared downstream ``rng.choice`` draws stay
        bit-identical). Quarantine defaults keep this exactly the old
        idle list when the recovery layer is off."""
        if self.columnar:
            return self.fleet.idle_ids(self.round)
        return [c.client_id for c in self._clients.values()
                if c.status == "idle" and c.quarantined_until <= self.round]

    def any_idle(self) -> bool:
        if self.columnar:
            return self.fleet.any_idle(self.round)
        return any(c.status == "idle" and c.quarantined_until <= self.round
                   for c in self._clients.values())

    def recent_durations(self, client_id: int, k: int) -> list[float]:
        """The client's last <=k training durations, oldest first (empty
        for unknown clients) — ``record.durations[-k:]`` on both planes."""
        if self.columnar:
            return self.fleet.recent_durations(client_id, k)
        rec = self._clients.get(client_id)
        return list(rec.durations[-k:]) if rec is not None else []

    # ------------------------------------------------------------- results
    def put_update(self, rec: ResultRecord, update: Any) -> None:
        key = f"u{rec.client_id}r{rec.round}n{len(self.results)}"
        rec.update_key = key
        self.blobs[key] = update
        self.results.append(rec)

    def put_update_row(self, rec: ResultRecord, row: int) -> None:
        """Update-plane result: the parameters stay on device as a row of
        the controller's UpdateStore; the database records only the handle."""
        rec.update_row = int(row)
        self.results.append(rec)

    def pending_results(self, max_staleness: int, current_round: int):
        """Un-aggregated updates no older than max_staleness rounds."""
        return [r for r in self.results
                if not r.aggregated
                and current_round - r.round <= max_staleness]

    def mark_aggregated(self, recs) -> None:
        for r in recs:
            r.aggregated = True
            # free the blob: aggregated updates are never re-read
            self.blobs.pop(r.update_key, None)

    def put_global_model(self, round_: int, params: Any) -> None:
        key = f"g{round_}"
        self.blobs[key] = params
        self.global_models[round_] = key
        # retain only a short history of globals
        for r in sorted(self.global_models)[:-3]:
            self.blobs.pop(self.global_models.pop(r), None)

    def latest_global(self) -> Any:
        r = max(self.global_models)
        return self.blobs[self.global_models[r]]

    # --------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "round": self.round,
            "meta": self.meta,
            "control_plane": self.control_plane,
            # object plane: full records; columnar plane: the columns live
            # in fleet.npz (no O(fleet) JSON materialization)
            "clients": ({} if self.columnar else
                        {str(k): asdict(v)
                         for k, v in self._clients.items()}),
            "results": [asdict(r) for r in self.results],
            "global_models": {str(k): v for k, v in self.global_models.items()},
        }
        tmp = os.path.join(path, ".db.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "db.json"))
        if self.columnar:
            tmp = os.path.join(path, ".fleet.npz.tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **self.fleet.state_dict())
            os.replace(tmp, os.path.join(path, FLEET_NPZ))
        flat = {}
        for key, tree in self.blobs.items():
            leaves, _ = _flatten(tree)
            for i, leaf in enumerate(leaves):
                flat[f"{key}|{i}"] = np.asarray(leaf)
            flat[f"{key}|treedef"] = np.array(json.dumps(_treedef(tree)))
        # atomic like db.json/fleet.npz: a crash mid-write must never
        # leave a truncated blobs.npz shadowing the previous good one
        tmp = os.path.join(path, ".blobs.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, os.path.join(path, "blobs.npz"))

    @classmethod
    def load(cls, path: str) -> "Database":
        with open(os.path.join(path, "db.json")) as f:
            meta = json.load(f)
        db = cls(control_plane=meta.get("control_plane", "object"))
        db.round = meta["round"]
        db.meta = meta["meta"]
        if db.columnar:
            with np.load(os.path.join(path, FLEET_NPZ)) as data:
                db.fleet = FleetStore.from_state(dict(data))
        else:
            for k, v in meta["clients"].items():
                db._clients[int(k)] = ClientRecord(**v)
        db.results = [ResultRecord(**r) for r in meta["results"]]
        db.global_models = {int(k): v for k, v in meta["global_models"].items()}
        data = np.load(os.path.join(path, "blobs.npz"), allow_pickle=False)
        groups: dict[str, dict] = {}
        for name in data.files:
            key, idx = name.rsplit("|", 1)
            groups.setdefault(key, {})[idx] = data[name]
        for key, parts in groups.items():
            tdef = json.loads(str(parts.pop("treedef")))
            leaves = [parts[str(i)] for i in range(len(parts))]
            db.blobs[key] = _unflatten(tdef, leaves)
        return db


# -- tiny pytree (nested-dict) flatten helpers, no jax dependency ------------


def _flatten(tree):
    leaves = []

    def rec(node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)
        else:
            leaves.append(node)

    rec(tree)
    return leaves, None


def _treedef(tree):
    if isinstance(tree, dict):
        return {k: _treedef(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_treedef(v) for v in tree]
    return None


def _unflatten(tdef, leaves):
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [rec(v) for v in node]
        return next(it)

    return rec(tdef)
