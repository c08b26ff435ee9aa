"""Columnar control plane: struct-of-arrays fleet state (host half).

The object control plane keeps one Python ``ClientRecord`` per client and
evaluates Apodotiko's scoring with a per-client Python loop — fine at the
paper's 200 clients, a hard wall at the ROADMAP's millions. ``FleetStore``
is the columnar replacement (DESIGN.md §10), mirroring the conventions of
the device-resident update plane (``update_store.py``): all per-client
control state lives in parallel ``[capacity]`` numpy columns —

    ids / seq         id per slot (-1 free) + registration sequence number
    active / status   membership mask, 0 = idle | 1 = running
    cardinality, batch_size, local_epochs   Client_Update config (Alg. 2)
    booster           Algorithm 3 booster (f64, bit-exact vs the oracle)
    n_invocations / n_failures / last_round   invocation bookkeeping
    durations         [capacity, W] f64 window of the last W training
                      durations, newest FIRST (W = scoring.HISTORY_WINDOW);
                      each result shifts its row right by one — O(W)
                      contiguous — so the scoring read is a plain row
                      gather with no ring-index arithmetic
    ema_num / ema_den O(1) incremental CEF EMA state (scoring.ema_push)
    win_num / win_den cached *windowed* CEF terms, refreshed with an O(W)
                      scalar replay when a result lands — selection-time
                      scoring collapses to three [M] vector ops while
                      staying bit-identical to the oracle's full walk

— with an id->slot map and a LIFO free-list; capacity doubles amortized.
Slot *iteration order* is registration order (``ordered_slots`` sorts by
``seq`` lazily), which reproduces the object plane's dict-iteration order
exactly — the property the bit-identical selection traces rest on: both
planes hand ``np.random.Generator.choice`` identical candidate arrays and
identical probability vectors (see ``scoring.calculate_scores``).

Scoring is vectorized (one ``[M, W]`` window pass, bit-identical to the
Python loop) and the duration ring is updated incrementally on every
``ResultLanded`` instead of growing an unbounded per-client list.

**Device score state / top-k selection.** For fleet-scale cohorts the
store additionally maintains a device-resident score state (f32/bool torch
tensors on ``device``, the CUDA card unless the runtime or caller names
another: EMA num/den, booster, eligibility masks) updated by O(dirty)
scatters, and ``select_topk`` runs one vectorized step over the whole
``[capacity]`` state: score -> mask busy/uninvoked -> masked top-k ->
booster update (``kernels.ops.scored_topk``: one launch of the top-k CUDA
kernel on the card, ``kernels/topk.py``). This path is deterministic (no
sampling) and f32 — it is the *scale* selector behind the
``apodotiko-topk`` strategy, not the bit-exact oracle twin.
"""
from __future__ import annotations

from itertools import repeat
from typing import Optional

import numpy as np
import torch

from repro_torch.core.scoring import (HISTORY_WINDOW, calculate_scores, ema_push,
                                per_round_score, scores_from_terms,
                                window_accumulate, window_terms)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import scored_topk

IDLE, RUNNING = 0, 1


def _grow(arr: np.ndarray, new_cap: int) -> np.ndarray:
    out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
    out[:len(arr)] = arr
    return out


class FleetStore:
    """Free-listed columnar store of per-client control-plane state."""

    #: column name -> dtype; every 1-D [capacity] column (rings are separate)
    COLUMNS = {
        "ids": np.int64, "seq": np.int64, "status": np.int8,
        "active": np.bool_, "cardinality": np.int64, "batch_size": np.int64,
        "local_epochs": np.int64, "booster": np.float64,
        "n_invocations": np.int64, "n_failures": np.int64,
        "last_round": np.int64, "dur_len": np.int32,
        # recovery-layer circuit breaker (DESIGN.md §12): consecutive
        # failures since the last completed result, and the round until
        # which the client is benched (0 = never quarantined — always
        # eligible, so zero-filled legacy checkpoints behave identically)
        "consec_failures": np.int64, "quarantined_until": np.int64,
        "ema_num": np.float64, "ema_den": np.float64,
        "win_num": np.float64, "win_den": np.float64,
        # f32 twins of the EMA terms, folded *in f32 from the start* so the
        # device score state (and the megastep's in-scan score evolution)
        # is reproducible from host state without a f64->f32 cast of an
        # f64 fold — the cast of a fold and a fold of casts differ in ulps,
        # and the fused-round scan carries these exact f32 values
        "ema_num32": np.float32, "ema_den32": np.float32,
        "upd32": np.float32,   # f32(card * E / max(B, 1)), set at add time
    }

    def __init__(self, capacity: int = 0, history: int = HISTORY_WINDOW,
                 decay: float = 0.8, device=None):
        self.history = int(history)
        self.device = device          # device score state's device (lazy)
        self._decay = float(decay)    # EMA decay (1 - rho); runtime sets it
        self.capacity = 0
        for name, dt in self.COLUMNS.items():
            setattr(self, name, np.zeros((0,), dt))
        self.durations = np.zeros((0, self.history), np.float64)
        self._slot: dict[int, int] = {}
        self._free: list[int] = []
        self._next_seq = 0
        self._order: Optional[np.ndarray] = None   # slots sorted by seq
        self._dev = None                           # device score state
        self._dev_dirty: set[int] = set()
        if capacity:
            self._ensure(capacity)

    @property
    def decay(self) -> float:
        return self._decay

    @decay.setter
    def decay(self, value: float) -> None:
        """Changing the decay invalidates every cached score term — both
        the windowed cache and the infinite-horizon EMA are decay-weighted
        sums, so they are rebuilt (window terms exactly; the EMA restarts
        from the retained window, its only recoverable history)."""
        value = float(value)
        if value == self._decay:
            return
        self._decay = value
        slots = self._registered_slots()
        if not len(slots):
            return
        self._rebuild_window_terms(slots)
        self.ema_num[slots] = self.win_num[slots]
        self.ema_den[slots] = self.win_den[slots]
        self._rebuild_mirror32(slots)
        self._dev_dirty.update(slots.tolist())

    # ------------------------------------------------------------ capacity
    def _ensure(self, capacity: int) -> None:
        if capacity <= self.capacity:
            return
        cap = max(int(capacity), 2 * self.capacity, 8)
        for name in self.COLUMNS:
            setattr(self, name, _grow(getattr(self, name), cap))
        self.ids[self.capacity:cap] = -1
        self.durations = _grow(self.durations, cap)
        self._free.extend(range(cap - 1, self.capacity - 1, -1))
        if self._dev is not None:
            self._dev.grow(cap)
        self.capacity = cap

    # ---------------------------------------------------------- membership
    def add(self, client_id: int, cardinality: int, batch_size: int,
            local_epochs: int, *, booster: float = 1.0,
            status: int = IDLE) -> int:
        """Register one client (or overwrite an existing id in place — like
        the object plane's dict assignment, which keeps insertion order)."""
        cid = int(client_id)
        slot = self._slot.get(cid)
        fresh = slot is None
        if fresh:
            if not self._free:
                self._ensure(self.capacity + 1)
            slot = self._free.pop()
            self._slot[cid] = slot
            self.seq[slot] = self._next_seq
            self._next_seq += 1
            self._order = None
        self.ids[slot] = cid
        self.active[slot] = True
        self.status[slot] = status
        self.cardinality[slot] = int(cardinality)
        self.batch_size[slot] = int(batch_size)
        self.local_epochs[slot] = int(local_epochs)
        self.booster[slot] = float(booster)
        self.n_invocations[slot] = 0
        self.n_failures[slot] = 0
        self.consec_failures[slot] = 0
        self.quarantined_until[slot] = 0
        self.last_round[slot] = -1
        self.dur_len[slot] = 0
        self.durations[slot, :] = 0.0
        self.ema_num[slot] = 0.0
        self.ema_den[slot] = 0.0
        self.win_num[slot] = 0.0
        self.win_den[slot] = 0.0
        self.ema_num32[slot] = 0.0
        self.ema_den32[slot] = 0.0
        self.upd32[slot] = np.float32(
            int(cardinality) * int(local_epochs) / max(int(batch_size), 1))
        self._touch(slot, reset_booster=True)
        return slot

    def add_batch(self, client_ids, cardinality, batch_size,
                  local_epochs) -> np.ndarray:
        """Bulk registration without per-client Python objects (the
        fleet-scale entry point). All ids must be fresh."""
        cids = np.asarray(client_ids, np.int64)
        n = len(cids)
        if n == 0:
            return np.empty(0, np.int64)
        if not self._slot.keys().isdisjoint(cids.tolist()):
            raise ValueError("add_batch requires fresh client ids")
        if len(self._free) < n:
            self._ensure(self.capacity + (n - len(self._free)))
        # vectorized LIFO pop: identical slot order to n sequential pops
        slots = np.asarray(self._free[-n:][::-1], np.int64)
        del self._free[len(self._free) - n:]
        self._slot.update(zip(cids.tolist(), slots.tolist()))
        self.seq[slots] = self._next_seq + np.arange(n)
        self._next_seq += n
        self.ids[slots] = cids
        self.active[slots] = True
        self.status[slots] = IDLE
        self.cardinality[slots] = np.asarray(cardinality, np.int64)
        self.batch_size[slots] = np.asarray(batch_size, np.int64)
        self.local_epochs[slots] = np.asarray(local_epochs, np.int64)
        self.booster[slots] = 1.0
        for name in ("n_invocations", "n_failures", "consec_failures",
                     "quarantined_until", "dur_len",
                     "ema_num", "ema_den", "win_num", "win_den",
                     "ema_num32", "ema_den32"):
            getattr(self, name)[slots] = 0
        self.upd32[slots] = (
            (self.cardinality[slots] * self.local_epochs[slots])
            / np.maximum(self.batch_size[slots], 1)).astype(np.float32)
        self.durations[slots, :] = 0.0
        self.last_round[slots] = -1
        self._order = None
        self._dev_dirty.update(slots.tolist())
        if self._dev is not None:
            self._dev.reset_booster(slots)
        return slots

    def remove_batch(self, client_ids) -> list[int]:
        """Bulk removal: one column scatter + one free-list extend,
        free-list-order-identical to sequential ``remove`` calls. Unknown
        ids are skipped; returns the ids actually removed."""
        cids = np.asarray(client_ids, np.int64).tolist()
        # C-speed pop loop: dict.pop is a C method, so map() never enters
        # a Python frame per id
        raw = list(map(self._slot.pop, cids, repeat(None)))
        if None in raw:
            removed = [c for c, s in zip(cids, raw) if s is not None]
            slots = [s for s in raw if s is not None]
        else:
            removed, slots = cids, raw
        if not slots:
            return []
        sl = np.asarray(slots, np.int64)
        self.active[sl] = False
        self.ids[sl] = -1
        self._free.extend(slots)
        self._order = None
        self._dev_dirty.update(slots)
        return removed

    def remove(self, client_id: int) -> bool:
        slot = self._slot.pop(int(client_id), None)
        if slot is None:
            return False
        self.active[slot] = False
        self.ids[slot] = -1
        self._free.append(slot)
        self._order = None
        self._touch(slot)
        return True

    def slot_of(self, client_id: int) -> int:
        return self._slot[int(client_id)]

    def has(self, client_id: int) -> bool:
        return int(client_id) in self._slot

    def __len__(self) -> int:
        return len(self._slot)

    def ordered_slots(self) -> np.ndarray:
        """Active slots in registration order (== object-plane dict order)."""
        if self._order is None:
            act = np.flatnonzero(self.active)
            self._order = act[np.argsort(self.seq[act], kind="stable")]
        return self._order

    def client_ids(self) -> list[int]:
        return self.ids[self.ordered_slots()].tolist()

    # ------------------------------------------------------------- updates
    def _touch(self, slot: int, *, reset_booster: bool = False) -> None:
        self._dev_dirty.add(int(slot))
        if reset_booster and self._dev is not None:
            self._dev.reset_booster(np.array([slot], np.int64))

    def mark_running(self, client_id: int, round_: int) -> None:
        slot = self._slot[int(client_id)]
        self.status[slot] = RUNNING
        self.n_invocations[slot] += 1
        self.last_round[slot] = int(round_)
        self._touch(slot)

    def mark_complete(self, client_id: int, duration: float) -> None:
        """Result landed: shift the duration window (newest first), push
        the O(1) incremental EMA, and replay the O(W) windowed terms for
        THIS client only — selection never walks histories again
        (DESIGN.md §10)."""
        slot = self._slot[int(client_id)]
        self.status[slot] = IDLE
        self.consec_failures[slot] = 0      # a landed result heals the streak
        row = self.durations[slot]
        row[1:] = row[:-1]          # numpy buffers overlapping base-slices
        row[0] = float(duration)
        m = min(int(self.dur_len[slot]) + 1, self.history)
        self.dur_len[slot] = m
        card = int(self.cardinality[slot])
        epochs = int(self.local_epochs[slot])
        batch = int(self.batch_size[slot])
        s = per_round_score(float(duration), card, epochs, batch)
        self.ema_num[slot], self.ema_den[slot] = ema_push(
            float(self.ema_num[slot]), float(self.ema_den[slot]),
            s, self._decay)
        self.win_num[slot], self.win_den[slot] = window_accumulate(
            row[:m].tolist(), card, epochs, batch, self._decay)
        # f32 twin fold (the device-score / megastep-scan evolution): same
        # ema_push structure, every operand and intermediate f32
        dec32 = np.float32(self._decay)
        s32 = np.float32(card) * (
            self.upd32[slot]
            / np.maximum(np.float32(duration), np.float32(1e-9)))
        self.ema_num32[slot] = s32 + dec32 * self.ema_num32[slot]
        self.ema_den32[slot] = np.float32(1.0) + dec32 * self.ema_den32[slot]
        self._touch(slot)

    def mark_failed(self, client_id: int) -> None:
        slot = self._slot[int(client_id)]
        self.status[slot] = IDLE
        self.n_failures[slot] += 1
        self.consec_failures[slot] += 1
        self._touch(slot)

    def incr_failures(self, client_id: int) -> None:
        slot = self._slot[int(client_id)]
        self.n_failures[slot] += 1
        self.consec_failures[slot] += 1

    def quarantine(self, client_id: int, until_round: int) -> None:
        """Bench the client until ``until_round`` (exclusive) — it drops
        out of the idle pool and every selection mask meanwhile."""
        slot = self._slot[int(client_id)]
        self.quarantined_until[slot] = int(until_round)
        self._touch(slot)

    def set_idle(self, client_id: int) -> bool:
        """Return a running client to idle (cancellation path)."""
        slot = self._slot.get(int(client_id))
        if slot is None or self.status[slot] != RUNNING:
            return False
        self.status[slot] = IDLE
        self._touch(slot)
        return True

    # ------------------------------------------------------------- queries
    def any_idle(self, now_round: Optional[int] = None) -> bool:
        """Any active idle client; with ``now_round``, quarantined clients
        (``quarantined_until > now_round``) don't count."""
        mask = self.active & (self.status == IDLE)
        if now_round is not None:
            mask &= self.quarantined_until <= now_round
        return bool(np.any(mask))

    def idle_slots(self, now_round: Optional[int] = None) -> np.ndarray:
        order = self.ordered_slots()
        mask = self.status[order] == IDLE
        if now_round is not None:
            mask &= self.quarantined_until[order] <= now_round
        return order[mask]

    def idle_ids(self, now_round: Optional[int] = None) -> list[int]:
        return self.ids[self.idle_slots(now_round)].tolist()

    def recent_durations(self, client_id: int, k: int) -> list[float]:
        """The last <=k training durations, oldest first — exactly the
        object plane's ``record.durations[-k:]`` (for k <= history)."""
        slot = self._slot.get(int(client_id))
        if slot is None:
            return []
        m = min(int(self.dur_len[slot]), int(k), self.history)
        return self.durations[slot, :m][::-1].tolist()

    def duration_window(self, slots: np.ndarray,
                        window: int) -> tuple[np.ndarray, np.ndarray]:
        """``[len(slots), window]`` durations most-recent-FIRST plus the
        per-row valid lengths (the ``calculate_scores`` input layout) —
        a plain row gather thanks to the newest-first storage."""
        window = min(int(window), self.history)
        durs = self.durations[slots, :window]
        lens = np.minimum(self.dur_len[slots], window)
        return durs, lens

    def window_scores(self, slots: np.ndarray, window: int,
                      decay: float) -> np.ndarray:
        """Bit-exact windowed CEF scores for ``slots`` (oracle twin).

        Fast path: when the request matches the cached configuration (the
        full retained window, the store's decay — the Algorithm 3 defaults)
        the incrementally maintained ``win_num/win_den`` terms answer in
        three vector ops. Any other window/decay recomputes vectorized."""
        if window >= self.history and decay == self._decay:
            return scores_from_terms(self.booster[slots],
                                     self.win_num[slots],
                                     self.win_den[slots],
                                     self.dur_len[slots])
        durs, lens = self.duration_window(slots, window)
        return calculate_scores(self.booster[slots], durs, lens,
                                self.cardinality[slots],
                                self.local_epochs[slots],
                                self.batch_size[slots], decay)

    def _registered_slots(self) -> np.ndarray:
        return np.fromiter(self._slot.values(), np.int64,
                           count=len(self._slot))

    def _rebuild_window_terms(self, slots: np.ndarray) -> None:
        """Vectorized refresh of the cached windowed terms (bulk install /
        decay change) — same math, same bit patterns as the per-result
        scalar replay."""
        durs, lens = self.duration_window(slots, self.history)
        ws, nm = window_terms(durs, lens, self.cardinality[slots],
                              self.local_epochs[slots],
                              self.batch_size[slots], self._decay)
        self.win_num[slots] = ws
        self.win_den[slots] = nm

    def _rebuild_mirror32(self, slots: np.ndarray) -> None:
        """Restart the f32 EMA twins from the retained window (the only
        recoverable history — the same compromise the f64 path makes on a
        decay change), folding oldest -> newest entirely in f32."""
        m = np.minimum(self.dur_len[slots], self.history)
        num32 = np.zeros(len(slots), np.float32)
        den32 = np.zeros(len(slots), np.float32)
        dec32 = np.float32(self._decay)
        card32 = self.cardinality[slots].astype(np.float32)
        u32 = self.upd32[slots]
        for j in range(self.history - 1, -1, -1):   # oldest -> newest
            valid = j < m
            d32 = self.durations[slots, j].astype(np.float32)
            s32 = card32 * (u32 / np.maximum(d32, np.float32(1e-9)))
            num32 = np.where(valid, s32 + dec32 * num32, num32)
            den32 = np.where(valid, np.float32(1.0) + dec32 * den32, den32)
        self.ema_num32[slots] = num32
        self.ema_den32[slots] = den32

    def recent_mean(self, slots: np.ndarray, k: int) -> np.ndarray:
        """Mean of the last <=k durations per slot (0.0 when empty) —
        bit-identical to ``np.mean(record.durations[-k:])``: the masked
        accumulation below is sequential oldest-to-newest, numpy's own
        summation order for these short windows."""
        k = min(int(k), self.history)
        rows = self.durations[slots, :k]            # newest first
        m = np.minimum(self.dur_len[slots], k)
        n = len(slots)
        total = np.zeros(n, np.float64)
        arange = np.arange(n)
        for j in range(k):                          # oldest -> newest
            idx = m - 1 - j
            valid = idx >= 0
            total = total + np.where(
                valid, rows[arange, np.clip(idx, 0, k - 1)], 0.0)
        return np.where(m > 0, total / np.where(m > 0, m, 1), 0.0)

    # ----------------------------------------------------- bulk test/bench
    def bulk_history(self, durations: np.ndarray) -> None:
        """Install a ``[M, h]`` duration history (oldest first) for the
        first M registered clients in one vectorized pass — the bench/test
        seeding path; equivalent to h ``mark_complete`` calls per client
        but without 2*M*h Python scalar ops."""
        durations = np.asarray(durations, np.float64)
        M, h = durations.shape
        slots = self.ordered_slots()[:M]
        keep = min(h, self.history)
        self.durations[slots, :] = 0.0
        # newest-first storage: column j <- the (j+1)-th most recent
        self.durations[slots, :keep] = durations[:, ::-1][:, :keep]
        self.dur_len[slots] = keep
        upd = (self.cardinality[slots] * self.local_epochs[slots]) \
            / np.maximum(self.batch_size[slots], 1)
        num = np.zeros(M, np.float64)
        den = np.zeros(M, np.float64)
        num32 = np.zeros(M, np.float32)
        den32 = np.zeros(M, np.float32)
        dec32 = np.float32(self._decay)
        card32 = self.cardinality[slots].astype(np.float32)
        u32 = self.upd32[slots]
        for i in range(h):          # oldest -> newest, the ema_push order
            s = self.cardinality[slots] * (upd / np.maximum(durations[:, i],
                                                            1e-9))
            num, den = ema_push(num, den, s, self._decay)  # array-safe
            s32 = card32 * (u32 / np.maximum(
                durations[:, i].astype(np.float32), np.float32(1e-9)))
            num32 = s32 + dec32 * num32
            den32 = np.float32(1.0) + dec32 * den32
        self.ema_num[slots] = num
        self.ema_den[slots] = den
        self.ema_num32[slots] = num32
        self.ema_den32[slots] = den32
        self._rebuild_window_terms(slots)
        self.n_invocations[slots] = np.maximum(self.n_invocations[slots], h)
        self._dev_dirty.update(slots.tolist())

    def install_history(self, client_id: int, durations,
                        n_invocations: int = 0, n_failures: int = 0,
                        last_round: int = -1) -> None:
        """Install a pre-existing client history (oldest-first durations,
        counters) — the columnar equivalent of registering a populated
        ``ClientRecord``: the retained window, cached window terms, and
        EMA state are rebuilt so scoring matches the object plane's view
        of the same record."""
        slot = self._slot[int(client_id)]
        durations = [float(d) for d in durations]
        keep = durations[-self.history:]
        m = len(keep)
        self.durations[slot, :] = 0.0
        self.durations[slot, :m] = keep[::-1]          # newest first
        self.dur_len[slot] = m
        card = int(self.cardinality[slot])
        epochs = int(self.local_epochs[slot])
        batch = int(self.batch_size[slot])
        num = den = 0.0
        num32 = den32 = np.float32(0.0)
        dec32 = np.float32(self._decay)
        u32 = self.upd32[slot]
        for d in durations:                            # full history EMA
            num, den = ema_push(num, den,
                                per_round_score(d, card, epochs, batch),
                                self._decay)
            s32 = np.float32(card) * (
                u32 / np.maximum(np.float32(d), np.float32(1e-9)))
            num32 = s32 + dec32 * num32
            den32 = np.float32(1.0) + dec32 * den32
        self.ema_num[slot], self.ema_den[slot] = num, den
        self.ema_num32[slot], self.ema_den32[slot] = num32, den32
        self.win_num[slot], self.win_den[slot] = window_accumulate(
            keep[::-1], card, epochs, batch, self._decay)
        self.n_invocations[slot] = max(int(n_invocations), 0)
        self.n_failures[slot] = max(int(n_failures), 0)
        self.last_round[slot] = int(last_round)
        self._touch(slot)

    # ------------------------------------------------- device score state
    def _device(self):
        if self._dev is None:
            self._dev = _DeviceScores(self.capacity,
                                      resolve_device(self.device))
            self._dev_dirty.update(self._slot.values())
        return self._dev

    def _dirty_columns(self) -> Optional[tuple]:
        """The dirty slots (below capacity) and their device values as host
        arrays ``(idx, num, den, eligible, ever)``, or None when there are
        none; clears the dirty set."""
        idx = np.fromiter((i for i in self._dev_dirty if i < self.capacity),
                          np.int64)
        self._dev_dirty.clear()
        if idx.size == 0:
            return None
        # the f32 twin columns ARE the device values (no cast of an f64
        # fold), as in the reference
        return (idx, self.ema_num32[idx], self.ema_den32[idx],
                self.active[idx] & (self.status[idx] == IDLE),
                self.active[idx] & (self.n_invocations[idx] > 0))

    def _flush_device(self) -> None:
        dev = self._device()
        if not self._dev_dirty:
            return
        cols = self._dirty_columns()
        if cols is not None:
            dev.write(*dev.upload(*cols))

    def select_topk(self, k: int, beta: float,
                    now_round: Optional[int] = None) -> list[int]:
        """Fleet-scale cohort selection: one vectorized step over the
        device-resident score state. Idle uninvoked clients rank first
        (score +inf, the Algorithm 3 bootstrap), then the masked top-k of
        ``booster * ema_num/ema_den``; the booster update (selected -> 1,
        idle-unselected -> * beta) happens in the same step. Returns at
        most k client ids (fewer when fewer clients are eligible).
        ``now_round`` applies the quarantine mask host-side: benched
        clients are filtered from the returned cohort (their device score
        state is untouched, so they rank normally once released)."""
        if not self._slot:
            return []
        self._flush_device()
        dev = self._dev
        k_eff = int(min(int(k), self.capacity))
        if k_eff <= 0:
            return []
        idx, valid, boost = scored_topk(
            dev.num, dev.den, dev.booster, dev.eligible, dev.ever,
            np.float32(beta), k_eff)
        dev.booster = boost
        # one copy to the host: the picks, with -1 where not valid
        picks = torch.where(valid, idx, -1).cpu().numpy()
        return [int(self.ids[s]) for s in picks
                if s >= 0 and (now_round is None
                               or self.quarantined_until[s] <= now_round)]

    # --------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        """Numpy snapshot of every column + allocator state (checkpoint
        contract: ``FleetStore.from_state(state_dict())`` is identity,
        including live EMA/ring buffers and slot assignments)."""
        out = {name: getattr(self, name)[:self.capacity].copy()
               for name in self.COLUMNS}
        out["durations"] = self.durations[:self.capacity].copy()
        out["free"] = np.asarray(self._free, np.int64)
        out["next_seq"] = np.asarray([self._next_seq], np.int64)
        out["decay"] = np.asarray([self.decay], np.float64)
        out["history"] = np.asarray([self.history], np.int64)
        if self._dev is not None:
            # the top-k booster is device-owned state (never mirrored to
            # the host columns) — without it a resumed apodotiko-topk run
            # would restart every booster at 1.0
            out["dev_booster"] = self._dev.booster.cpu().numpy()
        return out

    @classmethod
    def from_state(cls, state: dict, device=None) -> "FleetStore":
        fs = cls(history=int(state["history"][0]),
                 decay=float(state["decay"][0]), device=device)
        cap = len(state["ids"])
        fs.capacity = cap
        for name, dt in cls.COLUMNS.items():
            if name in state:
                setattr(fs, name, np.asarray(state[name]).copy())
            else:
                setattr(fs, name, np.zeros((cap,), dt))
        if "ema_num32" not in state:
            # checkpoint from before the f32 twin columns: rebuild from
            # the retained duration window (the only recoverable history)
            fs.upd32 = ((fs.cardinality * fs.local_epochs)
                        / np.maximum(fs.batch_size, 1)).astype(np.float32)
            fs.durations = np.asarray(state["durations"]).copy()
            live = np.flatnonzero(fs.active)
            if live.size:
                fs._rebuild_mirror32(live)
        fs.durations = np.asarray(state["durations"]).copy()
        fs._free = [int(i) for i in state["free"]]
        fs._next_seq = int(state["next_seq"][0])
        fs._slot = {int(c): int(s) for s, c in enumerate(fs.ids) if c >= 0}
        if "dev_booster" in state:
            dev = fs._device()              # marks every slot dirty
            dev.booster = torch.as_tensor(
                np.asarray(state["dev_booster"], np.float32),
                device=dev.device)
        return fs


class _DeviceScores:
    """Device-resident f32 score state (lazy; see FleetStore docstring).

    ``booster`` is *device-owned*: it evolves inside the top-k step and is
    never overwritten from the host columns — the f64 host booster belongs
    to the bit-exact probabilistic path, this one to the top-k path.
    Everything else mirrors the host columns via dirty scatters."""

    def __init__(self, capacity: int, device: torch.device):
        self.device = device
        self.num = torch.zeros(capacity, dtype=torch.float32, device=device)
        self.den = torch.zeros(capacity, dtype=torch.float32, device=device)
        self.booster = torch.ones(capacity, dtype=torch.float32, device=device)
        self.eligible = torch.zeros(capacity, dtype=torch.bool, device=device)
        self.ever = torch.zeros(capacity, dtype=torch.bool, device=device)

    def grow(self, capacity: int) -> None:
        pad = capacity - self.num.shape[0]
        if pad <= 0:
            return
        dev = self.device
        self.num = torch.cat([self.num, torch.zeros(pad, device=dev)])
        self.den = torch.cat([self.den, torch.zeros(pad, device=dev)])
        self.booster = torch.cat([self.booster, torch.ones(pad, device=dev)])
        self.eligible = torch.cat(
            [self.eligible, torch.zeros(pad, dtype=torch.bool, device=dev)])
        self.ever = torch.cat(
            [self.ever, torch.zeros(pad, dtype=torch.bool, device=dev)])

    def upload(self, idx, num, den, eligible, ever) -> tuple:
        """Host columns of the dirty slots as tensors on the device."""
        return tuple(torch.as_tensor(np.asarray(a), dtype=dt,
                                     device=self.device)
                     for a, dt in ((idx, torch.int64), (num, torch.float32),
                                   (den, torch.float32),
                                   (eligible, torch.bool), (ever, torch.bool)))

    def write(self, i, num, den, eligible, ever) -> None:
        """Write uploaded values at slots ``i``."""
        self.num[i] = num
        self.den[i] = den
        self.eligible[i] = eligible
        self.ever[i] = ever

    def reset_booster(self, idx) -> None:
        self.booster[torch.as_tensor(np.asarray(idx, np.int64),
                                     device=self.device)] = 1.0

