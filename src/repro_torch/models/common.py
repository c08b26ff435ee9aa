"""Shared model primitives (twin of ``repro.models.common``): the
parameter factory and its initializers, the stacked-layer initializer,
norms, the SwiGLU activation, rotary embeddings and the classifier loss.

Parameters are plain nested dicts of tensors, named under nested scopes as
in the reference. The reference's factory also records logical sharding
axes per leaf; the port has no sharding yet, so it keeps only the values.
Values are drawn from a ``torch.Generator`` and differ from the reference's
``jax.random`` draws: tests that compare the two packages start the port
from the reference's params (``models.convert``). A factory on the ``meta``
device draws nothing and allocates nothing: it gives every leaf's shape and
dtype, the twin of the reference's ``jax.eval_shape`` over ``init``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import tree_leaves, tree_map

Params = Any


class ParamFactory:
    """Accumulates a nested dict of initialized parameters under nested
    scopes, drawn in creation order from one generator on ``device`` (the
    generator's device by default). With ``into`` (a tree of preallocated
    tensors of the same names and shapes) each leaf is drawn into its
    tensor there, which ``params`` then holds."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype=torch.float32, device=None,
                 into: Optional[dict] = None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(
            device if device is not None
            else generator.device if generator is not None else "cpu")
        self.params: dict = {}
        self._path: list[str] = []
        self._into = into

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        self._path.append(name)
        try:
            yield
        finally:
            self._path.pop()

    def param(self, name: str, shape: tuple[int, ...], init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        node = self.params
        for p in self._path:
            node = node.setdefault(p, {})
        if name in node:
            raise ValueError(
                f"duplicate param {'/'.join(self._path + [name])}")
        out = None
        if self._into is not None:
            out = self._into
            for key in self._path + [name]:
                out = out[key]
        value = _initialize(self.generator, shape, self.dtype, init, scale,
                            self.device, out)
        node[name] = value
        return value


def _initialize(gen: Optional[torch.Generator], shape, dtype, init: str,
                scale: Optional[float], device=None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One leaf, drawn into ``out`` when it is given. A normal leaf is drawn
    in fp32 (into ``out`` itself when it is fp32) and scaled in place, so
    the draw holds one fp32 copy of the leaf beside its cast."""
    device = torch.device("cpu" if device is None else device)
    if init not in ("zeros", "ones", "normal", "embed"):
        raise ValueError(f"unknown init {init}")
    if device.type == "meta":
        return (out if out is not None
                else torch.empty(shape, dtype=dtype, device=device))
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if init in ("zeros", "ones"):
        return out.fill_(0.0 if init == "zeros" else 1.0)
    x = (out if out.dtype == torch.float32
         else torch.empty(shape, dtype=torch.float32, device=device))
    if init == "normal":
        # fan-in scaled truncated normal, as the reference: fan_in = prod
        # of all but the last dim (conv HWIO, fused [in, heads, hd])
        fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (
            shape[-1] if shape else 1)
        std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    else:
        # "embed": a plain (not truncated) normal, as the reference's
        std = scale if scale is not None else 0.02
        x.normal_(0.0, 1.0, generator=gen)
    x.mul_(std)
    return out if x is out else out.copy_(x)


def init_stacked(init_fn: Callable, generator: Optional[torch.Generator],
                 n: int, dtype, *args, device=None) -> dict:
    """``n`` copies of a block stacked on a leading layers axis.

    ``init_fn(pf, *args)`` registers one block's params on a
    :class:`ParamFactory`; the ``n`` blocks draw one after another from
    ``generator`` (the reference splits one key per block). Each stacked
    leaf is allocated once, and every block's leaf is drawn into its slot,
    so the stack is never held twice."""
    meta = ParamFactory(None, dtype, "meta")
    init_fn(meta, *args)
    device = torch.device(device if device is not None
                          else generator.device if generator is not None
                          else "cpu")
    stack = tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=dtype,
                                           device=device), meta.params)
    if device.type != "meta":
        for i in range(n):
            init_fn(ParamFactory(generator, dtype, device,
                                 into=tree_map(lambda t: t[i], stack)), *args)
    return stack


# ----------------------------------------------------------------------------
# Norms / activations
# ----------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim, in fp32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               has_heads: bool = True) -> torch.Tensor:
    """x: [..., S, H, hd] (has_heads) or [..., S, hd]; positions [S] or
    [B, S]. Rotary embedding over the last dim (split-half convention), the
    angles and the rotation in fp32, cast back to ``x``'s dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    if has_heads:
        angles = angles[..., :, None, :]  # broadcast over the heads axis
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Losses / metrics
# ----------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy, fp32. logits [..., V], integer labels [...]."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def later_slice(name: str, slice_name: str) -> Callable:
    """A stand-in for the reference's function ``name``, which a later slice
    of the port brings: calling it raises ``NotImplementedError`` naming
    that slice."""
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} comes with a later slice of the port ({slice_name})")
    fn.__name__ = name
    return fn
