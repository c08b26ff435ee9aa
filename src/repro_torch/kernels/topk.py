"""Top-k selection: wrappers around ``csrc/topk.cu``.

- ``block_topk(scores, k, block)``: each block's k largest scores and their
  indices into ``scores``, ``(vals [G, k] fp32, idx [G, k] int64)``,
  G = ceil(M / block), positions past M acting as -inf scores (the
  reference's per-block candidates);
- ``masked_topk(scores, k)``: the top k of the whole vector, ``(vals [k],
  idx [k])``, in one launch;
- ``scored_topk(num, den, booster, eligible, ever, beta, k)``: the
  Algorithm-3 selection step (score, masks, top-k, booster update) in one
  launch, ``(idx [k], valid [k], new_booster [M])``.

The order is ``lax.top_k``'s: larger first, equal scores by ascending index,
no index twice. A CPU tensor takes the plain torch version in ``ref``; a
CUDA tensor launches the kernel or raises; a ``meta`` tensor runs nothing
and reports the kernel's traffic to ``_build.meta_launch``.
``block_topk.launches`` counts
every launch of the source, by all three wrappers.

The kernel takes k <= ``MAX_K``. For a larger k the reference's
``ops.masked_topk`` leaves its Pallas kernel for ``jax.lax.top_k``, an XLA
op; ``masked_topk`` and ``scored_topk`` route such a k by k alone to that
route's counterpart, ``sorted_topk`` / ``sorted_scored_topk`` (torch ops on
the tensors' own device), and ``masked_topk.sorts`` counts those calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

BLOCK_TOPK = 1024   # scores per block (one CTA each); also the largest block
MAX_K = 1024        # the largest k the kernel takes
TILE = 8192         # scores per CTA of masked_topk / scored_topk (topk.cu)

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_TICKETS: dict = {}   # (device index, stream) -> the merge's ticket


def _merge(t: torch.Tensor, M: int, k: int, stream: int
           ) -> tuple[torch.Tensor, int]:
    """The merge's buffers for a top-k over [M]: the scratch of the
    tiles' packed candidates ([G, k] int64, G = ceil(M / TILE)) and the
    address of the uint32 counter whose last ticket elects the merging CTA
    (one per device and stream, so two streams never share one; the kernel
    leaves it at 0). One tile (M <= TILE) needs neither: an empty scratch
    and a null ticket. The counter is made by an eager call: a first
    multi-tile call on a stream under CUDA-graph capture raises, as the
    counter would come from the graph's memory pool with its zero-fill
    captured into the graph. (A graph keeps its capture stream's ticket:
    do not replay it beside an eager call on that stream.)"""
    if M >= 2 ** 31:
        raise ValueError(f"the top-k kernel takes M < 2^31, got {M}")
    G = -(-M // TILE)
    if G == 1:
        return torch.empty(0, dtype=torch.int64, device=t.device), 0
    key = (t.device.index, stream)
    tk = _TICKETS.get(key)
    if tk is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the top-k merge's ticket for this stream is made on its "
                "first call: call masked_topk or scored_topk once on the "
                "capture stream before capturing a CUDA graph")
        tk = torch.zeros(1, dtype=torch.int32, device=t.device)
        _TICKETS[key] = tk
    return (torch.empty(G * k, dtype=torch.int64, device=t.device),
            tk.data_ptr())


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check_k(M: int, k: int) -> None:
    if not 1 <= k <= M:
        raise ValueError(f"need 1 <= k <= M, got k={k}, M={M}")


def _card_tensor(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _meta_picks(name: str, scores: torch.Tensor, shape: tuple) -> tuple:
    """``meta`` (vals, idx) of ``shape``; the scores read once, the picks
    written once."""
    vals = torch.empty(shape, dtype=torch.float32, device="meta")
    idx = torch.empty(shape, dtype=torch.int64, device="meta")
    _build.meta_launch(name, _build.nbytes(scores), _build.nbytes(vals, idx))
    return vals, idx


def block_topk(scores: torch.Tensor, k: int, block: int = BLOCK_TOPK
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """scores [M] -> (vals [G, k] fp32, idx [G, k] int64);
    1 <= k <= block <= 1024. On CUDA: fp32 and contiguous."""
    if scores.dim() != 1 or scores.shape[0] < 1:
        raise ValueError(f"scores must be a non-empty [M], got "
                         f"{tuple(scores.shape)}")
    if not 1 <= k <= block <= BLOCK_TOPK:
        raise ValueError(f"need 1 <= k <= block <= {BLOCK_TOPK}, got "
                         f"k={k}, block={block}")
    if scores.device.type == "cpu":
        return ref.block_topk(scores, k, block)
    if scores.device.type == "meta":
        G = -(-scores.shape[0] // block)
        return _meta_picks("block_topk", scores, (G, k))
    _card_tensor(scores, torch.float32, "scores")
    M = scores.shape[0]
    G = -(-M // block)
    vals = torch.empty((G, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((G, k), dtype=torch.int64, device=scores.device)
    fn = _build.function("topk", "block_topk_f32", _INT,
                         [_P, _I64, _INT, _INT, _P, _P, _P])
    _check(fn(scores.data_ptr(), M, block, k, vals.data_ptr(),
              idx.data_ptr(), _build.stream(scores)), "block_topk")
    block_topk.launches += 1
    return vals, idx


block_topk.launches = 0


def masked_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores [M]`` -> ``(vals [k] fp32, idx [k] int64)``,
    descending, ties to the lowest index, no index twice; masked entries are
    -inf scores, which the caller filters by value. One launch on the card
    for 1 <= k <= 1024, ``sorted_topk`` there for a larger k; the plain
    version (a stable descending sort) on a CPU tensor."""
    M = scores.shape[0]
    _check_k(M, k)
    if scores.device.type == "cpu":
        return ref.masked_topk(scores, k)
    if k > MAX_K:
        return sorted_topk(scores, k)
    if scores.device.type == "meta":
        return _meta_picks("masked_topk", scores, (k,))
    _card_tensor(scores, torch.float32, "scores")
    stream = _build.stream(scores)
    scratch, ticket = _merge(scores, M, k, stream)
    vals = torch.empty(k, dtype=torch.float32, device=scores.device)
    idx = torch.empty(k, dtype=torch.int64, device=scores.device)
    fn = _build.function("topk", "masked_topk_f32", _INT,
                         [_P, _I64, _INT, _P, _P, _P, _P, _P])
    _check(fn(scores.data_ptr(), M, k, scratch.data_ptr(), ticket,
              vals.data_ptr(), idx.data_ptr(), stream), "masked_topk")
    block_topk.launches += 1
    return vals, idx


def scored_topk(num: torch.Tensor, den: torch.Tensor, booster: torch.Tensor,
                eligible: torch.Tensor, ever: torch.Tensor, beta, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Algorithm-3 top-k selection step over [M] slots: score
    ``booster * (num / max(den, 1e-12))`` (NaN kept), +inf where never
    invoked, then -inf where ineligible; its top k as ``masked_topk``;
    ``valid = vals > -inf``; the new booster (out of place) 1 at every valid
    pick, ``booster * beta`` where eligible and unpicked, else unchanged.
    All fp32 (``beta`` rounded to fp32). Returns ``(idx [k] int64,
    valid [k] bool, new_booster [M] fp32)``. One launch on the card for
    k <= 1024, ``sorted_scored_topk`` there for a larger k; the plain
    composition ``ref.scored_topk`` on CPU tensors."""
    M = booster.shape[0]
    _check_k(M, k)
    if booster.device.type == "cpu":
        return ref.scored_topk(num, den, booster, eligible, ever, beta, k)
    if k > MAX_K:
        return sorted_scored_topk(num, den, booster, eligible, ever, beta, k)
    if booster.device.type == "meta":
        idx = torch.empty(k, dtype=torch.int64, device="meta")
        valid = torch.empty(k, dtype=torch.bool, device="meta")
        new_booster = torch.empty_like(booster)
        _build.meta_launch(
            "scored_topk", _build.nbytes(num, den, booster, eligible, ever),
            _build.nbytes(idx, valid, new_booster))
        return idx, valid, new_booster
    for name, t, dtype in (("num", num, torch.float32),
                           ("den", den, torch.float32),
                           ("booster", booster, torch.float32),
                           ("eligible", eligible, torch.bool),
                           ("ever", ever, torch.bool)):
        _card_tensor(t, dtype, name)
        if t.shape != (M,) or t.device != booster.device:
            raise ValueError(f"{name} must be [{M}] on {booster.device}")
    stream = _build.stream(booster)
    scratch, ticket = _merge(booster, M, k, stream)
    vals = torch.empty(k, dtype=torch.float32, device=booster.device)
    idx = torch.empty(k, dtype=torch.int64, device=booster.device)
    valid = torch.empty(k, dtype=torch.bool, device=booster.device)
    new_booster = torch.empty_like(booster)
    fn = _build.function("topk", "scored_topk_f32", _INT, [
        _P, _P, _P, _P, _P, ctypes.c_float, _I64, _INT, _P, _P, _P, _P, _P,
        _P, _P])
    _check(fn(num.data_ptr(), den.data_ptr(), booster.data_ptr(),
              eligible.data_ptr(), ever.data_ptr(), ref.fp32(beta), M, k,
              scratch.data_ptr(), ticket, vals.data_ptr(),
              idx.data_ptr(), valid.data_ptr(), new_booster.data_ptr(),
              stream), "scored_topk")
    block_topk.launches += 1
    return idx, valid, new_booster


masked_topk.sorts = 0


def sorted_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``masked_topk`` for a k the kernel does not take: the counterpart of
    the reference's ``jax.lax.top_k`` route (``repro/kernels/ops.py:295``,
    an XLA op, no Pallas kernel), as torch ops on ``scores``' device. A
    stable descending sort of the int32 order keys (``ref.order_key``:
    -NaN < -inf < -0 < +0 < +inf < +NaN; the floats themselves would tie
    -0 with +0) cut to k, so equal scores go to the lowest index. Counted
    in ``masked_topk.sorts``."""
    masked_topk.sorts += 1
    s = scores.to(torch.float32)
    idx = torch.sort(ref.order_key(s), descending=True, stable=True
                     ).indices[:k]
    return s[idx], idx


def sorted_scored_topk(num, den, booster, eligible, ever, beta, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``scored_topk`` for a k the kernel does not take: the reference's
    jnp composition (``repro/kernels/ops.py:308``) around its
    ``lax.top_k`` route, as torch ops: the score ``booster * (num /
    clamp_min(den, 1e-12))`` (NaN kept, bit for bit the kernel's), +inf
    where never invoked, -inf where ineligible, ``sorted_topk``, then the
    booster update (1 at every valid pick, ``booster * beta`` where
    eligible and unpicked, else unchanged)."""
    score = booster * (num / torch.clamp_min(den, 1e-12))
    score = torch.where(ever, score, float("inf"))
    score = torch.where(eligible, score, float("-inf"))
    vals, idx = sorted_topk(score, k)
    valid = vals > float("-inf")
    chosen = torch.zeros_like(eligible)
    chosen[idx] = valid
    boost = torch.where(chosen, 1.0, torch.where(
        eligible, booster * ref.fp32(beta), booster))
    return idx, valid, boost
