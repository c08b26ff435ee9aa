"""Append-only write-ahead journal of protocol events (DESIGN.md §14).

The durability layer (``repro_torch.durability``) records every protocol
occurrence — events dispatched through ``_emit``/``_dispatch`` plus
round-boundary markers — as one CRC-framed JSON line *before* its
side effects become externally visible. Because the simulator is fully
deterministic given its seeds, the journal is not replayed to mutate
state; it is the **oracle** a resumed run re-validates itself against:
after restoring the last coordinated snapshot, re-execution must re-emit
the exact journal tail byte for byte, or the resume aborts with a
divergence error instead of silently forking the trace.

Framing: each record is ``<compact-json>|<crc32 hex8>\n``. A torn tail
(the process died mid-``write``) fails the CRC or the newline scan and
defines the *last consistent prefix*; ``read`` reports both the parsed
records and the byte offset of that prefix so the resume path can
truncate the file back to a clean state. Sequence numbers (``q``) are
dense from 0 — a gap means a corrupt middle, which also ends the prefix.

Sync policy: ``append`` always issues the ``os.write`` immediately (an
in-process SIGKILL loses nothing already appended); ``fsync`` is per
record ("event" policy) or only at round boundaries ("round" policy) —
the caller decides per append.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, List, Optional, Tuple

JOURNAL_NAME = "journal.wal"

#: journal record kinds that are markers, not protocol events
MARKER_KINDS = ("genesis", "round_open", "round_close", "run_end")


def encode_line(record: dict) -> bytes:
    body = json.dumps(record, separators=(",", ":"), sort_keys=True)
    return f"{body}|{zlib.crc32(body.encode()):08x}\n".encode()


def decode_line(line: bytes) -> Optional[dict]:
    """Parse one framed line; None if the frame or CRC is bad."""
    body, sep, crc = line.rpartition(b"|")
    if not sep or len(crc) != 8:
        return None
    try:
        if zlib.crc32(body) != int(crc, 16):
            return None
        return json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None


def encode_event(event: Any) -> Tuple[str, dict]:
    """A protocol event as (kind, JSON payload). Nested dataclasses
    (``ResultRecord`` inside ``ResultLanded``) flatten via asdict; the
    event's own ``t`` is carried at the record top level, not here."""
    payload = {}
    for f in dataclasses.fields(event):
        if f.name == "t":
            continue
        v = getattr(event, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = dataclasses.asdict(v)
        elif isinstance(v, tuple):
            v = list(v)
        payload[f.name] = v
    return type(event).__name__, payload


class Journal:
    """Lazy-open append handle over one journal file. Uses raw
    ``os.write`` so bytes reach the kernel the moment ``append``
    returns — a simulated SIGKILL immediately after cannot tear a
    record that the in-process reader already considers written."""

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None
        self.bytes_written = 0
        self.n_fsyncs = 0

    def _open(self) -> int:
        if self._fd is None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fd = os.open(self.path,
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        return self._fd

    def append(self, record: dict, *, fsync: bool) -> None:
        line = encode_line(record)
        fd = self._open()
        os.write(fd, line)
        self.bytes_written += len(line)
        if fsync:
            os.fsync(fd)
            self.n_fsyncs += 1

    def flush(self) -> None:
        if self._fd is not None:
            os.fsync(self._fd)
            self.n_fsyncs += 1

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    # ----------------------------------------------------------- reading
    @staticmethod
    def read(path: str) -> Tuple[List[dict], int]:
        """Parse the journal into (records, consistent_prefix_bytes).

        Scanning stops at the first torn/corrupt line or sequence gap;
        everything before it is the last consistent prefix. A resume
        truncates the file to that offset before appending anything."""
        with open(path, "rb") as f:
            data = f.read()
        records: List[dict] = []
        off = 0
        while True:
            nl = data.find(b"\n", off)
            if nl < 0:
                break                       # torn tail: no newline
            rec = decode_line(data[off:nl])
            if rec is None or rec.get("q") != len(records):
                break                       # bad CRC / frame / seq gap
            records.append(rec)
            off = nl + 1
        return records, off

    @staticmethod
    def truncate_to_consistent(path: str) -> Tuple[List[dict], bool]:
        """Read + repair: drop any torn tail in place. Returns the
        consistent records and whether bytes were discarded."""
        records, good = Journal.read(path)
        size = os.path.getsize(path)
        if good < size:
            os.truncate(path, good)
            return records, True
        return records, False
