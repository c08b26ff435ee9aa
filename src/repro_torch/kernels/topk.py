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
CUDA tensor launches the kernel or raises. ``block_topk.launches`` counts
every launch of the source, by all three wrappers.
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


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device as a raw handle, without the
    ``torch.cuda.Stream`` object that ``torch.cuda.current_stream`` builds
    (host time that a one-CTA selection would otherwise be bound by)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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
    _card_tensor(scores, torch.float32, "scores")
    M = scores.shape[0]
    G = -(-M // block)
    vals = torch.empty((G, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((G, k), dtype=torch.int64, device=scores.device)
    fn = _build.function("topk", "block_topk_f32", _INT,
                         [_P, _I64, _INT, _INT, _P, _P, _P])
    _check(fn(scores.data_ptr(), M, block, k, vals.data_ptr(),
              idx.data_ptr(), _stream(scores)), "block_topk")
    block_topk.launches += 1
    return vals, idx


block_topk.launches = 0


def masked_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``scores [M]`` -> ``(vals [k] fp32, idx [k] int64)``,
    descending, ties to the lowest index, no index twice; masked entries are
    -inf scores, which the caller filters by value. One launch on the card
    for 1 <= k <= 1024 (a larger k raises ``NotImplementedError`` there);
    the plain version (a stable descending sort) on a CPU tensor."""
    M = scores.shape[0]
    _check_k(M, k)
    if scores.device.type == "cpu":
        return ref.masked_topk(scores, k)
    if k > MAX_K:
        raise NotImplementedError(
            f"the top-k kernel takes k <= {MAX_K}; k={k} has no kernel")
    _card_tensor(scores, torch.float32, "scores")
    stream = _stream(scores)
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
    valid [k] bool, new_booster [M] fp32)``. One launch on the card; the
    plain composition ``ref.scored_topk`` on CPU tensors."""
    M = booster.shape[0]
    _check_k(M, k)
    if booster.device.type == "cpu":
        return ref.scored_topk(num, den, booster, eligible, ever, beta, k)
    if k > MAX_K:
        raise NotImplementedError(
            f"the top-k kernel takes k <= {MAX_K}; k={k} has no kernel")
    for name, t, dtype in (("num", num, torch.float32),
                           ("den", den, torch.float32),
                           ("booster", booster, torch.float32),
                           ("eligible", eligible, torch.bool),
                           ("ever", ever, torch.bool)):
        _card_tensor(t, dtype, name)
        if t.shape != (M,) or t.device != booster.device:
            raise ValueError(f"{name} must be [{M}] on {booster.device}")
    stream = _stream(booster)
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
