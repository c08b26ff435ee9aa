"""Fused round megastep (twin of ``repro.core.megastep``): runs of
quiescent rounds as one fused loop on the card.

Every plane is card-resident, but the stepwise scheduler still hops through
the event loop between them each round: select, train, aggregate, EMA and
booster bookkeeping, and the protocol choreography around them. For rounds
that are provably *quiescent* (no hedge timer can fire, no churn or
failure can land, no eval or checkpoint boundary, every completion of the
round lands before anything else could happen) this module runs R such
rounds as one loop over device state:

    for each of R rounds:
        scored_topk            (kernels.ops: the op select_topk launches)
        free-stack LIFO pop    (the UpdateStore's row allocation)
        cohort train           (CohortTrainer.train_cohort_rows: the step
                                loop train_cohort_indexed runs)
        f32 EMA fold           (the FleetStore mirror algebra)
        aggregate_rows_traced  (kernels.ops: the weighted_aggregate_rows
                                route on card-resident ids and weights)
        free-stack push

The reference lowers the same body into one jitted ``lax.scan``; here it
is a plain torch loop (no CUDA graph), so it moves the host's work rather
than removing it.

**Bit-identity contract.** The event-driven engine stays the oracle; the
fused path must be bitwise indistinguishable from it. The anchors:

  * selection: the loop carries the FleetStore device score state (the f32
    twin columns, ``_flush_device``) and calls the one ``scored_topk``
    definition ``select_topk`` calls;
  * training: the loop calls the trainer's shared step loop with the same
    padded operands; its ``batch_indices`` draw takes the round's own step
    maximum (one read on the host a round), as the stepwise draw does, so
    the generator advances through the same states;
  * update rows: the loop carries the UpdateStore free stack and replays
    its LIFO pop/push algebra, so row ids equal what ``alloc`` produces;
  * aggregation: all-current-round Eq. 2 weights are integer-valued
    (``s(T,T) = 1``), so the f32 cast-then-normalize in
    ``services.aggregate_round`` does not depend on the order of the sum
    and the loop's on-card ``w / w.sum()`` equals the host one bit for bit;
    the route is ``aggregation.rows_dispatch``'s;
  * landing order: durations are deterministic in the eligible regime
    (variability 0, warm instances), so per-slot completion ranks are
    precomputed and a stable argsort reproduces the event heap's
    (time, schedule-seq) pop order.

After the loop, a **host replay** walks the same R rounds through the REAL
bookkeeping code (``platform.invoke``, ``_launch``, the event loop,
``db.mark_complete``, result records, free-lists) with protocol emission
suppressed and no device work, so every host structure ends equal to the
stepwise run's. Loop-vs-replay cross-checks (row ids, replayed durations
and cold/failed flags, landing order) raise rather than diverge silently.

Under a mesh (``sharding.flmesh``) the loop calls the mesh forms of the
same steps: the cohort trains this rank's lanes and its rows land in the
owned tiles (``train_cohort_rows``), and the aggregation is the psum
route (``aggregate_rows_traced(mesh=)``). Selection, the free stack and
the EMA fold run alike on every rank, so every rank pops the same ids;
``_plan`` refuses a cohort bucket or a store capacity that the ``data``
axis does not divide, with the reference's strings.

``_plan`` is the eligibility check: it admits a run of rounds only when
every condition above is statically provable and otherwise reports why
(``Scheduler.metrics()['megastep_fallback_reason']``, the reference's
strings). Anything it cannot prove falls through to the stepwise engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import rows_dispatch
from repro_torch.core.fleet_store import IDLE
from repro_torch.core.scoring import promotion_rate
from repro_torch.core.services import RoundLog, _Payload
from repro_torch.core.strategies.reactive import LegacyStrategyAdapter
from repro_torch.kernels.ops import (aggregate_rows_traced, scored_topk,
                                     tree_leaves, tree_map)


@dataclass
class MegastepPlan:
    """Everything the fused loop and the host replay need, resolved
    statically."""

    R: int                  # rounds to fuse
    K: int                  # cohort size (= cfg.clients_per_round)
    Kp: int                 # padded cohort bucket
    top: int                # free-stack height at entry
    sparse: bool            # aggregation route (rows_dispatch)
    mesh: Any               # sharding.flmesh mesh (None: single device)
    out_dtype: Any          # model leaf dtype (post-aggregate cast)
    beta32: np.float32      # booster promotion rate (1 + rho)
    dec32: np.float32       # EMA decay (1 - rho)
    # [capacity] per-slot columns (host); device copies are made at launch
    ids_col: np.ndarray     # client id (= dataset index), int64
    n_col: np.ndarray       # data.n[id]
    n32_col: np.ndarray     # f32 cast of n (aggregation weights)
    steps_col: np.ndarray   # step budget, int64
    card32_col: np.ndarray  # f32 cardinality (EMA operand)
    upd32_col: np.ndarray   # FleetStore.upd32 (EMA operand)
    d64_col: np.ndarray     # deterministic invocation duration, f64
    d32_col: np.ndarray     # f32 cast (the mark_complete EMA operand)
    rank_col: np.ndarray    # dense duration rank (landing-order key)


def _plan(sched) -> tuple[Optional[MegastepPlan], str]:
    """Prove a run of rounds quiescent, or say why not (side-effect free
    apart from reading — and thereby purging — the stale-timer heap)."""
    cfg = sched.cfg
    db = sched.db
    # config-level refusals first: they name the *user-set* knob even when
    # a knob also changes the policy object (RecoveryPolicy wrapping)
    if getattr(sched, "durability", None) is not None:
        # fused rounds dispatch no per-event Python, so a write-ahead
        # journal would record nothing at their boundaries
        return None, "durability journal active"
    if cfg.invocation_timeout or cfg.retry_budget or cfg.quarantine_threshold:
        return None, "retry/timeout recovery enabled"
    if cfg.quorum_fraction < 1.0:
        return None, "partial-cohort quorum enabled"
    if type(sched.policy) is not LegacyStrategyAdapter \
            or sched.policy.strategy.name != "apodotiko-topk":
        return None, "strategy is not adapter-wrapped apodotiko-topk"
    if not db.columnar:
        return None, "object control plane"
    if sched.update_plane != "device" or sched.store is None:
        return None, "blob update plane"
    if sched.data_plane != "device" or sched.dataset is None:
        return None, "host data plane"
    if cfg.eval_every:
        return None, "per-round evaluation enabled"
    if cfg.checkpoint_every:
        return None, "checkpointing enabled"
    if cfg.target_accuracy:
        return None, "target-accuracy early stop enabled"
    if cfg.failure_rate != 0.0:
        return None, "nonzero failure rate"
    faults = sched.platform.faults
    if faults is not None and faults.active and faults.stochastic:
        # stochastic faults perturb any round; outage windows are handled
        # below by shrinking the horizon to stop short of the window
        return None, "stochastic fault schedule active"
    if sched.strategy.needs_scaffold:
        return None, "scaffold variates"
    K = int(cfg.clients_per_round)
    if K <= 0:
        return None, "empty cohort"
    if sched.strategy.results_needed() < K:
        return None, "CR gate closes rounds before all K land"
    if any(not r.aggregated for r in db.results):
        return None, "un-aggregated results pending"
    if sched.inflight:
        return None, "invocations in flight"
    if sched._peek_timer() is not None:
        return None, "timer armed"
    if sched._progress is not None:
        return None, "progress callback installed (may mutate mid-run)"
    if sched.loop.peek() is not None:
        return None, "event loop not quiescent"

    fleet = db.fleet
    slots = np.flatnonzero(fleet.active)
    if slots.size == 0:
        return None, "no active clients"
    if np.any(fleet.status[slots] != IDLE):
        return None, "clients not idle"
    if np.any(fleet.n_invocations[slots] <= 0):
        return None, "bootstrap rounds remain (uninvoked clients)"
    if np.any(fleet.quarantined_until[slots] > db.round):
        return None, "clients quarantined"
    if slots.size < K:
        return None, "K exceeds idle-client count"
    ids = fleet.ids[slots].astype(np.int64)
    if int(ids.max()) >= sched.dataset.n_clients:
        return None, "client id outside resident dataset"
    for cid in ids:
        hw = sched.hw.get(int(cid))
        if hw is None or hw.variability != 0.0:
            return None, "client hardware has nonzero variability"
        if int(cid) not in sched.platform._instances:
            return None, "client has no platform instance"

    stack = sched.store.free_stack()
    leaves = tree_leaves(sched.params)
    if len({l.dtype for l in leaves}) != 1:
        return None, "mixed model leaf dtypes (scan carry instability)"
    out_dtype = leaves[0].dtype

    # deterministic per-slot durations: warm startup (0.15, no uniform
    # draw), speed = hw.speed * exp(N(0, 0)) = hw.speed exactly, no
    # failure — the exact f64 expression platform.invoke evaluates
    platform = sched.platform
    n_all = np.asarray(sched.data.n)
    cap = fleet.capacity
    ids_col = np.zeros(cap, np.int64)
    n_col = np.ones(cap, n_all.dtype)
    steps_col = np.ones(cap, np.int64)
    d64_col = np.zeros(cap, np.float64)
    ids_col[slots] = ids
    n_col[slots] = n_all[ids]
    steps_col[slots] = np.maximum(
        np.ceil(n_col[slots] / cfg.batch_size).astype(np.int64)
        * cfg.local_epochs, 1)
    for s in slots:
        hw = sched.hw[int(ids_col[s])]
        d64_col[s] = ((0.15 + platform.model_load_s)
                      + float(steps_col[s]) * cfg.base_step_time / hw.speed
                      ) + platform.upload_s
    if float(np.sum(n_col[slots].astype(np.float64))) >= float(2 ** 24):
        return None, "sample counts too large for exact f32 weights"

    # horizon: every invocation must hit a warm instance and every round
    # must close inside the sim budget, under the conservative per-round
    # advance bound D = max duration over active clients
    t0 = float(sched.loop.now)
    D = float(d64_col[slots].max())
    warm_min = min(platform._instances[int(c)].warm_until for c in ids)
    R = int(cfg.rounds) - int(db.round)
    if D > 0:
        if warm_min < t0:
            R = 0
        else:
            R = min(R, int(np.floor((warm_min - t0) / D)) + 1)
        R = min(R, max(int(np.ceil((cfg.max_sim_time - t0) / D)) - 1, 0))
    while R > 0 and (t0 + (R - 1) * D > warm_min
                     or t0 + R * D >= cfg.max_sim_time):
        R -= 1
    if R < 1:
        return None, "no quiescent horizon (keep-warm or sim budget)"
    if faults is not None and faults.active:
        # deterministic outage windows: fused launches happen at t0 + r*D,
        # so shrink the horizon to stop strictly before any window that
        # overlaps it. A window already behind us (end <= t0) is ignored.
        for w in faults.outage_windows():
            if w.end <= t0 or w.start >= t0 + R * D:
                continue
            if w.start > t0 and D > 0:
                R = min(R, int(np.floor((w.start - t0) / D + 1e-12)))
            else:
                R = 0
        if R < 1:
            return None, "fault window overlaps horizon"
    traffic = sched.traffic
    if traffic is not None:
        if traffic.stochastic:
            return None, "stochastic traffic profile active"
        nb = sched._traffic_boundary()
        if nb is not None:
            # deterministic segment boundaries work like outage windows:
            # the horizon stops before the next unapplied boundary
            if nb <= t0:
                return None, "traffic boundary overlaps horizon"
            if D > 0:
                R = min(R, int(np.ceil((nb - t0) / D - 1e-12)))
            if R < 1 or t0 + (R - 1) * D >= nb:
                return None, "traffic boundary overlaps horizon"

    Kp = sched.trainer.cohort_bucket(K)
    if stack.size < Kp:
        return None, "update-store free list too small (would grow)"
    sparse = rows_dispatch(sched.store.capacity, K)
    # the lane split and the row tiles need the data axis to divide both;
    # the trainer's lcm'd floor and the store's alignment guarantee it,
    # and a future geometry change degrades to stepwise here
    mesh = sched.mesh
    if mesh is not None:
        if Kp % mesh.data:
            return None, "cohort bucket not divisible by mesh data axis"
        if sched.store.capacity % mesh.data:
            return None, "store capacity not divisible by mesh data axis"

    _, rank_col = np.unique(d64_col, return_inverse=True)
    return MegastepPlan(
        R=R, K=K, Kp=Kp, top=int(stack.size), sparse=sparse, mesh=mesh,
        out_dtype=out_dtype,
        beta32=np.float32(promotion_rate(cfg.adjustment_rate)),
        dec32=np.float32(fleet.decay),
        ids_col=ids_col, n_col=n_col,
        n32_col=n_col.astype(np.float32), steps_col=steps_col,
        card32_col=fleet.cardinality[:cap].astype(np.float32),
        upd32_col=fleet.upd32[:cap].copy(),
        d64_col=d64_col, d32_col=d64_col.astype(np.float32),
        rank_col=rank_col.astype(np.int64)), "eligible"


def _fused_rounds(sched, plan: MegastepPlan, dev):
    """The R-round body on the card, over ``dev`` (the FleetStore's device
    score state, flushed). The update-store buffer and the trainer's
    generator advance in place; ``num`` / ``den`` evolve in copies.
    Returns ``(sel [R, K], ids [R, Kp], losses [R, K])`` as host arrays
    and the final ``(params, booster)``."""
    R, K, Kp, top = plan.R, plan.K, plan.Kp, plan.top
    on = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=dev.device)
    ids_col = on(plan.ids_col, torch.int64)
    n_col = on(plan.n_col, torch.int64)
    n32_col = on(plan.n32_col, torch.float32)
    steps_col = on(plan.steps_col, torch.int32)
    card32_col = on(plan.card32_col, torch.float32)
    upd32_col = on(plan.upd32_col, torch.float32)
    d32_col = on(plan.d32_col, torch.float32)
    rank_col = on(plan.rank_col, torch.int64)
    dec32 = on(plan.dec32, torch.float32)
    stack = on(sched.store.free_stack(), torch.int64)
    num, den, booster = dev.num.clone(), dev.den.clone(), dev.booster
    buffer, spec, params = sched.store.buffer, sched.spec, sched.params
    # cohort-bucket pad lanes repeat lane K-1's client and run 0 steps —
    # the values train_cohort_indexed's padding produces
    pad_steps = torch.zeros(Kp - K, dtype=torch.int32, device=dev.device)
    out_sel, out_ids, out_loss = [], [], []
    for _ in range(R):
        # -- selection: the exact select_topk step ------------------------
        sel, _, booster = scored_topk(num, den, booster, dev.eligible,
                                      dev.ever, plan.beta32, K)
        # -- update rows: the UpdateStore LIFO pop sequence ---------------
        ids = stack[top - Kp:top].flip(0)
        # -- cohort train: the shared step loop, rows written in place ----
        sel_p = torch.cat([sel, sel[-1:].repeat(Kp - K)])
        steps_p = torch.cat([steps_col[sel], pad_steps])
        losses = sched.trainer.train_cohort_rows(
            params, sched.dataset, ids_col[sel_p], n_col[sel_p], steps_p,
            buffer, ids)
        # -- f32 EMA fold per landing (the mark_complete twin) ------------
        s32 = card32_col[sel] * (upd32_col[sel]
                                 / torch.clamp_min(d32_col[sel], 1e-9))
        num[sel] = s32 + dec32 * num[sel]
        den[sel] = 1.0 + dec32 * den[sel]
        # -- aggregation in landing order ---------------------------------
        perm = torch.argsort(rank_col[sel], stable=True)
        rows_land = ids[:K][perm]
        w = n32_col[sel][perm]
        w = w / w.sum()
        flat = aggregate_rows_traced(buffer, rows_land, w,
                                     sparse=plan.sparse, mesh=plan.mesh)
        params = tree_map(lambda x: x.to(plan.out_dtype),
                          spec.unravel(flat[:spec.n_params],
                                       restore_dtype=False))
        # -- free-stack push algebra (pad frees, then landing frees) ------
        stack[top - Kp:top] = torch.cat([ids[K:], rows_land])
        out_sel.append(sel)
        out_ids.append(ids)
        out_loss.append(losses[:K])
    host = lambda xs: torch.stack(xs).cpu().numpy()
    return host(out_sel), host(out_ids), host(out_loss), params, booster


def run_megastep(sched, plan: MegastepPlan) -> None:
    """Run the fused rounds, then replay them through the REAL host
    bookkeeping (platform, event loop, database, free-lists) with protocol
    emission suppressed and no device work: the end state equals the
    stepwise run's. Cross-checks against the fused rounds raise on a
    mismatch."""
    cfg = sched.cfg
    db = sched.db
    fleet = db.fleet
    store = sched.store
    R, K, Kp = plan.R, plan.K, plan.Kp

    fleet._flush_device()               # fold pre-loop dirt into the state
    dev = fleet._device()
    sel_np, ids_np, losses_np, params_f, booster_f = _fused_rounds(
        sched, plan, dev)

    # ---- host replay: the real code paths, no device work ----------------
    strat = sched.strategy
    sched._emit = lambda ev: None       # instance attr shadows the method
    try:
        for r in range(R):
            round_ = db.round
            sched._t0 = sched.loop.now
            sched._invoked_this_round = True
            sched._completed_this_round = set()
            sel = sel_np[r]
            ids = store.alloc(Kp)
            if not np.array_equal(ids, ids_np[r]):
                raise RuntimeError("megastep: scan/alloc row-id mismatch")
            if Kp > K:
                store.free(ids[K:])
            for k in range(K):
                slot = int(sel[k])
                cid = int(plan.ids_col[slot])
                payload = _Payload(row=int(ids[k]))
                inv = sched._launch(cid, round_, float(plan.steps_col[slot]),
                                    payload, int(plan.n_col[slot]),
                                    float(losses_np[r, k]))
                if inv.rec.cold or inv.rec.failed \
                        or inv.rec.duration != plan.d64_col[slot]:
                    raise RuntimeError(
                        "megastep: replayed invocation diverged from plan")
            for _ in range(K):          # drain exactly this round's landings
                sched.loop.step()
            pending = [p for p in db.pending_results(cfg.max_staleness,
                                                     round_)
                       if strat.usable(p, round_)]
            perm = np.argsort(plan.rank_col[sel], kind="stable")
            rows_land = ids[:K][perm]
            if [p.update_row for p in pending] != rows_land.tolist():
                raise RuntimeError("megastep: landing-order mismatch")
            # aggregate_round's exact close sequence (params came from the
            # fused rounds): free landing rows, then mark aggregated
            store.free(rows_land.tolist())
            db.mark_aggregated(pending)
            log = RoundLog(round=round_, t_start=sched._t0,
                           t_end=sched.loop.now, accuracy=sched._acc,
                           n_aggregated=K, n_stale=0, mean_loss=0.0)
            sched.history.append(log)   # _plan refused if _progress was set
            db.round = round_ + 1
    finally:
        vars(sched).pop("_emit", None)  # restore the class method

    # ---- device-state handoff -------------------------------------------
    # the buffer rows and the trainer's generator advanced in place
    sched.params = params_f
    dev.booster = booster_f
    # num/den are NOT written back: the replayed mark_complete calls marked
    # every touched slot dirty, and the next _flush_device rebuilds them
    # from the f32 mirror columns, which the loop evolved with the exact
    # same algebra
    sched.megastep_scans += 1
    sched.megastep_rounds += R


def try_megastep(sched) -> bool:
    """Scheduler hook: plan, and if eligible run, one fused run of rounds.
    Returns True when rounds were executed (the caller re-checks
    termination and may re-enter — completions extend keep-warm
    windows)."""
    plan, reason = _plan(sched)
    sched.megastep_fallback_reason = reason
    if plan is None:
        return False
    run_megastep(sched, plan)
    return True
