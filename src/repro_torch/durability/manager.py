"""Durability manager: journal hooks, crash injection, resume tail
validation (twin of ``repro.durability.manager``).

The manager sits between the engines and the ``Journal``: every protocol
event (``Scheduler._dispatch`` / the poll loop's ``_emit``) and every round
boundary produces one journal record carrying the simulated clock, the
round, the event payload, and a cheap RNG/cursor fingerprint (platform
PCG64 position, traffic cursor, live recovery-timer count; round markers
add the selection-RNG position and a CRC of the trainer's generator
state).

On resume the manager is armed with the journal tail past the restored
snapshot: re-executed appends are *validated* against the tail record for
record instead of being rewritten — any mismatch raises
``JournalDivergence`` rather than silently forking the trace — and once
the tail is exhausted, new records append as usual, leaving the journal
byte-identical to the uncrashed run's.

Crash injection: the caller sets ``crash_after=k`` to kill the process
right after the k-th record is processed — ``crash_mode="raise"`` unwinds
with ``SimulatedCrash`` for in-process fuzzing; ``"sigkill"`` delivers a
real ``SIGKILL`` for subprocess fuzzing. Unlike the reference, no
environment variable arms it.

Under a mesh (``sharding.flmesh``: one process a rank, each running the
whole host engine, so each emits the same records) rank 0 alone opens the
journal and appends to it. Every rank builds each record, counts it,
validates a resumed tail against it and crashes at the same
``crash_after``, so the ranks stay in step through every collective. In
``"sigkill"`` mode only the calling process dies: its peers would wait in
their next collective, so the launcher (``torchrun``, or whatever started
the group) must tear the group down.

The journal equals the reference's for the same config and seed, record
for record, except the generator fingerprint ``g["k"]``: the reference
records its JAX PRNG key, the port ``zlib.crc32`` of the
``torch.Generator`` state (16 bytes on the card, the mt19937 state on the
CPU).
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import signal
import time
import zlib
from dataclasses import asdict
from typing import Optional, Sequence

from repro_torch import tracing
from repro_torch.core.journal import JOURNAL_NAME, Journal, encode_event
from repro_torch.sharding import flmesh

#: FLConfig fields excluded from the genesis digest: identity of the
#: run, not of the experiment (a resume points at the same directory;
#: golden-vs-crash test runs point at different ones)
_DIGEST_EXCLUDE = ("checkpoint_dir", "checkpoint_every", "durability",
                   "durability_sync", "durability_snap_every")

_U64 = (1 << 64) - 1


def _live_timer_count(rt) -> int:
    """Recovery timers still armed — counted with the same liveness
    predicate the snapshot uses (stale heap entries awaiting their lazy
    ``_peek_timer`` purge are dead state, so a resumed heap legitimately
    omits them; the fingerprint must not see the difference)."""
    timers = getattr(rt, "_timers", None)
    if not timers:
        return 0
    from repro_torch.core.services import Inflight
    n = 0
    for (_, _, round_, tag) in timers:
        if round_ < rt.db.round:
            continue
        if isinstance(tag, Inflight) and tag.done:
            continue
        n += 1
    return n


def generator_crc(generator) -> int:
    """``zlib.crc32`` of a ``torch.Generator``'s full state bytes."""
    return zlib.crc32(generator.get_state().numpy().tobytes())


class SimulatedCrash(RuntimeError):
    """Raised by the in-process crash injector at the armed boundary."""


class JournalDivergence(RuntimeError):
    """A resumed run re-emitted a record that differs from the journal."""


def config_digest(cfg) -> str:
    d = {k: v for k, v in asdict(cfg).items() if k not in _DIGEST_EXCLUDE}
    return hashlib.sha1(
        json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()


class DurabilityManager:
    def __init__(self, runtime, *, expected: Optional[Sequence[dict]] = None,
                 next_seq: int = 0):
        from repro_torch.core.services import resolve_durability_sync
        cfg = runtime.cfg
        if not cfg.checkpoint_dir:
            raise ValueError(
                "durability='journal' requires cfg.checkpoint_dir (the "
                "journal and snapshots live there)")
        self.rt = runtime
        self.root = cfg.checkpoint_dir
        self.sync = resolve_durability_sync(cfg.durability_sync)
        self.snap_every = max(int(cfg.durability_snap_every), 1)
        self.mesh = runtime.mesh
        # the one journal writer: rank 0 under a mesh
        self.journal = (Journal(os.path.join(self.root, JOURNAL_NAME))
                        if flmesh.is_writer(self.mesh) else None)
        self._expected = collections.deque(expected or ())
        self._seq = next_seq
        self.n_records = 0
        self.n_replayed = 0
        self.n_snapshots = 0
        self.snapshot_s = 0.0       # host seconds spent writing snapshots
        self._config_digest = config_digest(cfg)
        self.crash_after: Optional[int] = None
        self.crash_mode = "raise"

    # ------------------------------------------------------------ hooks
    def record_event(self, event) -> None:
        kind, payload = encode_event(event)
        self._record(kind, payload, round_=self.rt.db.round,
                     fsync=self.sync == "event")

    def record_marker(self, kind: str, round_: int) -> None:
        self._record(kind, {}, round_=round_, fsync=self.sync == "event")

    def on_round_closed(self) -> None:
        """Both engines call this right after ``db.round`` advances: the
        round-close marker always fsyncs (it is the boundary the "round"
        sync policy guarantees), and on the snapshot cadence the
        coordinated snapshot is written for this journal position."""
        rt = self.rt
        self._record("round_close", {}, round_=rt.db.round, fsync=True)
        if rt.db.round % self.snap_every == 0:
            from repro_torch.durability.snapshot import write_snapshot
            # one pair of clock reads times snapshot_s and the span
            t0 = time.perf_counter_ns()
            span = tracing.begin("snapshot", at=t0)
            wrote = write_snapshot(rt, self.root, self._seq - 1)
            t1 = time.perf_counter_ns()
            tracing.end(span, at=t1)
            if wrote:
                self.n_snapshots += 1
                self.snapshot_s += (t1 - t0) / 1e9

    def finish(self) -> None:
        self._record("run_end", {}, round_=self.rt.db.round, fsync=True)
        if self.journal is not None:
            self.journal.close()
        if self.mesh is not None:
            flmesh.barrier(self.mesh)   # the whole journal is on disk

    # ---------------------------------------------------------- appends
    def _record(self, kind: str, payload: dict, *, round_: int,
                fsync: bool) -> None:
        if self._seq == 0 and kind != "genesis":
            self._record("genesis",
                         {"config": self._config_digest,
                          "engine": self.rt.engine_name, "version": 1},
                         round_=0, fsync=True)
        rec = self._next_record(kind, payload, round_)
        if self._expected:
            exp = self._expected.popleft()
            if exp != rec:
                raise JournalDivergence(
                    f"resume diverged from the journal at seq {self._seq}:\n"
                    f"  journal: {json.dumps(exp, sort_keys=True)}\n"
                    f"  replay:  {json.dumps(rec, sort_keys=True)}")
            self.n_replayed += 1
        elif self.journal is not None:
            self.journal.append(rec, fsync=fsync)
        self._seq += 1
        self.n_records += 1
        if self.crash_after is not None and self._seq >= self.crash_after:
            self._crash()

    def _next_record(self, kind: str, payload: dict, round_: int) -> dict:
        """The record at ``self._seq``, the same on every rank."""
        return {"q": self._seq, "k": kind, "t": self.rt.loop.now,
                "r": round_, "p": payload, "g": self._fingerprint(kind)}

    def _crash(self) -> None:
        if self.journal is not None:
            self.journal.flush()
            self.journal.close()
        if self.crash_mode == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedCrash(
            f"injected crash after journal seq {self._seq - 1}")

    # ------------------------------------------------------ fingerprint
    def _fingerprint(self, kind: str) -> dict:
        """Cheap per-record RNG/cursor positions — the per-event divergence
        tripwire. Round markers add the selection RNG and the trainer
        generator's CRC (host reads only: a CUDA generator's state lives
        on the host)."""
        rt = self.rt
        g = {"p": rt.platform._rng.bit_generator.state["state"]["state"] & _U64,
             "tc": rt._traffic_pos,
             "tm": _live_timer_count(rt)}
        if rt.platform.faults is not None:
            g["f"] = (rt.platform.faults._rng.bit_generator
                      .state["state"]["state"] & _U64)
        if kind in ("round_close", "run_end", "genesis"):
            g["s"] = rt.strategy.rng.bit_generator.state["state"]["state"] & _U64
            g["k"] = generator_crc(rt.trainer.generator)
        return g

    # ---------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """The journal's and the snapshots' counters. Under a mesh every
        rank reports the same ``journal_records``, ``journal_replayed``
        and ``n_snapshots``; ``journal_bytes`` and ``journal_fsyncs`` are
        the writer's, 0 on every other rank."""
        j = self.journal
        return {
            "durability": "journal",
            "durability_sync": self.sync,
            "journal_records": self.n_records,
            "journal_replayed": self.n_replayed,
            "journal_bytes": j.bytes_written if j is not None else 0,
            "journal_fsyncs": j.n_fsyncs if j is not None else 0,
            "n_snapshots": self.n_snapshots,
            "snapshot_s": self.snapshot_s,
        }
