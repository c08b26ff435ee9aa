"""Step-function builders for training and serving cells, with their
sharding specs (twin of ``repro.launch.steps``).

Everything needed to run or count one (arch x shape x mesh) cell:
  - ``build_cell``: the step function, its arguments as ``meta`` tensors
    (the reference's ``ShapeDtypeStruct``s) and the in / out specs derived
    from the logical-axes trees, the reference's ``NamedSharding``s as
    ``sharding.rules.P`` trees;
  - the steps: train (``launch.train.train_step``: forward, backward, the
    config's optimizer), prefill (logits tail + cache build), serve (one
    decode token against a full cache) and the FL round's aggregation (the
    cohort's K updates weighted and summed).

Variants are config transforms applied before building, as in the
reference: remat on/off, ZeRO-1 on/off, the optimizer, alternative rule
tables, and ``variant="scatter_bf16"`` for the FL round.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config
from repro_torch.kernels.ops import tree_leaves, tree_map
from repro_torch.launch import train as train_mod
from repro_torch.launch.roofline import MetaTrace
from repro_torch.models import build_model, input_specs
from repro_torch.models.api import param_axes
from repro_torch.models.common import map_axes
from repro_torch.optim import build_optimizer, optimizers
from repro_torch.sharding import flmesh
from repro_torch.sharding.rules import (DECODE_RULES, DEFAULT_RULES,
                                        LONGCTX_RULES, P, _zip_map,
                                        logical_spec, mesh_shape,
                                        zero1_extend)

Params = Any


def rules_for(shape: ShapeConfig) -> dict:
    if shape.kind != "decode":
        return dict(DEFAULT_RULES)
    if shape.global_batch == 1:
        return dict(LONGCTX_RULES)
    return dict(DECODE_RULES)


def opt_state_axes(opt_name: str, axes_tree: Params) -> Params:
    """Logical axes for the optimizer state, mirroring the param axes."""
    if opt_name == "sgd":
        return {}
    if opt_name == "momentum":
        return {"m": axes_tree}
    if opt_name == "adam":
        return {"m": axes_tree, "v": axes_tree, "t": ()}
    if opt_name == "adafactor":
        def one(a):
            a = tuple(a)
            if len(a) >= 2:
                return {"row": a[:-1], "col": a[:-2] + a[-1:]}
            return {"v": a}
        return {"s": map_axes(axes_tree, one), "t": ()}
    raise ValueError(opt_name)


def specs_from_axes(axes_tree: Params, shapes_tree: Params, mesh,
                    rules: dict, *, zero1: bool = False) -> Params:
    """A ``P`` for every leaf of ``shapes_tree`` (tensors, ``meta`` ones
    too) from its logical names in ``axes_tree``; ``zero1`` also shards
    each over the data axis where a free dim divides."""
    def one(names, arr):
        spec = logical_spec(names, tuple(arr.shape), mesh, rules)
        if zero1:
            spec = zero1_extend(spec, tuple(arr.shape), mesh, "data")
        return spec

    return _zip_map(one, axes_tree, shapes_tree)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass
class Cell:
    """One (arch x shape x mesh) combination, built and not yet run.

    ``fn(*in_args)`` is the step. ``in_args`` are ``meta`` tensors (a
    decode step's write index ``pos`` is a host int32 scalar, as
    ``decode_step`` reads it on the host), laid out as the port's step
    takes them. ``in_shardings`` / ``out_shardings`` are the reference's
    specs, trees of ``P`` over ``logical_args``, the reference's argument
    layout: the same arrays, except the fused Adam's moments, which the
    port keeps as one fp32 row each (``optim.adam_fused``: the logical
    tree's leaves packed in ``RavelSpec`` order) where the reference keeps
    a tree shaped as the params."""

    arch: str
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    rules: dict
    fn: Any
    in_args: tuple
    in_shardings: tuple
    out_shardings: Any
    kind: str
    logical_args: tuple
    model: Any
    opt: Any = None
    variant: str = "baseline"

    def trace(self, args: Optional[tuple] = None) -> MetaTrace:
        """One run of ``fn`` under a ``MetaTrace`` (on ``in_args`` unless
        ``args`` are given): its FLOPs, bytes and hand-kernel launches."""
        with MetaTrace() as t:
            self.fn(*(self.in_args if args is None else args))
        return t

    def total_params(self) -> int:
        """Elements of the params (the FL round's: of the [K, ...] stack),
        as the reference's ``dryrun`` counts ``in_args[0]``."""
        return sum(t.numel() for t in tree_leaves(self.logical_args[0]))

    def argument_bytes_per_device(self) -> int:
        """Bytes of the arguments one device holds as the specs divide
        them (each logical array over the product of its spec's axes)."""
        sizes = mesh_shape(self.mesh)
        total = []

        def one(spec, arr):
            n = 1
            for part in spec:
                for a in (() if part is None else (part,)
                          if isinstance(part, str) else part):
                    n *= sizes[a]
            total.append(arr.numel() * arr.element_size() // n)

        for specs, args in zip(self.in_shardings, self.logical_args):
            _spec_map(one, specs, args)
        return int(sum(total))

    def make_args(self, device, params: Optional[Params] = None,
                  seed: int = 0) -> tuple:
        """Real arguments on ``device``: params from ``model.init`` on it
        (``torch.Generator`` seed ``seed``) unless ``params`` are given
        (e.g. converted reference params, ``models.convert``); the opt
        state from ``opt.init``; the batch from ``launch.train.step_batch``
        (``numpy.random.default_rng(seed)``); caches as zeros; the FL
        round's K updates normal draws in each leaf's dtype and its
        weights uniform in [0.5, 1.5), normalized."""
        device = torch.device(device)
        rng = np.random.default_rng(seed)
        B, S = self.shape.global_batch, self.shape.seq_len
        if self.kind == "flround":
            gen = torch.Generator(device=device).manual_seed(seed)
            upd = tree_map(lambda t: torch.randn(
                t.shape, generator=gen, device=device, dtype=t.dtype),
                self.in_args[0])
            w = rng.uniform(0.5, 1.5, size=B)
            w = torch.as_tensor(w / w.sum(), dtype=torch.float32).to(device)
            return upd, w
        if params is None:
            params = self.model.init(
                torch.Generator(device=device).manual_seed(seed))
        if self.kind == "train":
            batch = train_mod.step_batch(rng, self.cfg, B, S + 1, device)
            return params, self.opt.init(params), batch
        if self.kind == "prefill":
            batch = train_mod.step_batch(rng, self.cfg, B, S + 1, device)
            batch.pop("targets")
            return params, batch
        caches = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                device=device),
                          self.in_args[1])
        tokens = torch.as_tensor(rng.integers(
            0, self.cfg.vocab_size, (B, 1), dtype=np.int32)).to(device)
        return params, caches, tokens, self.in_args[3].clone()


def _spec_map(fn, specs, args) -> None:
    """``fn(spec, arr)`` over a tree of ``P`` and the tree it describes."""
    if isinstance(specs, P):
        fn(specs, args)
    elif isinstance(specs, dict):
        for k, v in specs.items():
            _spec_map(fn, v, args[k])
    elif isinstance(specs, list):
        for s, a in zip(specs, args):
            _spec_map(fn, s, a)
    else:
        raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _logical_opt_state(opt_name: str, params: Params, lr: float) -> Params:
    """The reference's optimizer state of ``params`` as ``meta`` tensors:
    its pytree form (``adam``: moments shaped as the params), the step
    count an int32 scalar."""
    plain = optimizers.adam(lr) if opt_name == "adam" else \
        build_optimizer(opt_name, lr)
    state = plain.init(params)
    if "t" in state:
        state = dict(state, t=_meta((), torch.int32))
    return state


def _build_cache(model, cfg: ModelConfig, B: int, S: int):
    if cfg.family == "encdec":
        return model.cache_struct(B, S, S)
    return model.cache_struct(B, S)


def _batch(cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    specs, axes = input_specs(cfg, shape)
    return {k: _meta(*v) for k, v in specs.items()}, axes


def fl_aggregate(updates: Params, weights: torch.Tensor) -> Params:
    """The FL round's aggregation, the reference's: each leaf's K updates
    times their weights, summed over the cohort axis in fp32 and cast to
    the leaf's dtype. Plain torch, as the reference's is plain XLA."""
    wf = weights.to(torch.float32)

    def one(x):
        wshape = (x.shape[0],) + (1,) * (x.dim() - 1)
        out = torch.sum(x.to(torch.float32) * wf.reshape(wshape), dim=0)
        return out.to(x.dtype)

    return tree_map(one, updates)


def _scatter_bf16(mesh):
    """The reference's ``scatter_bf16`` variant: local fp32 partial sums,
    then a bf16-wire psum over the data axis. On a process-group mesh
    (``sharding.flmesh.FLMesh``) each rank sums its data rank's slice of
    the cohort, ``[i*K/d, (i+1)*K/d)``, in fp32 and the bf16 partials meet
    in an all-reduce over ``data``; the result is the rounded sum on every
    rank. On 1x1, and on an ``AbstractMesh`` (the dry run's ``meta``
    tensors: the traffic is recorded, nothing is launched or exchanged),
    it is the whole cohort's sum rounded through bf16."""
    group = isinstance(mesh, flmesh.FLMesh)
    d = mesh_shape(mesh).get("data", 1)

    def fn(updates, weights):
        wf = weights.to(torch.float32)
        if group and wf.shape[0] % d:
            raise ValueError(f"a cohort of {wf.shape[0]} does not split "
                             f"over the data axis of {d}")
        share = wf.shape[0] // d if group else wf.shape[0]
        lo = mesh.data_index * share if group else 0
        wl = wf[lo:lo + share]

        def one(x):
            xl = x[lo:lo + share]
            wshape = (xl.shape[0],) + (1,) * (xl.dim() - 1)
            part = torch.sum(xl.to(torch.float32) * wl.reshape(wshape),
                             dim=0).to(torch.bfloat16)
            if group:
                part = flmesh.all_reduce_data(part, mesh)
            return part.to(x.dtype)

        return tree_map(one, updates)

    return fn


def build_cell(arch: str, shape: ShapeConfig, mesh, *,
               overrides: Optional[dict] = None,
               rules_override: Optional[dict] = None,
               variant: str = "baseline") -> Cell:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    model = build_model(cfg)
    rules = rules_override or rules_for(shape)
    params = model.init(None, device="meta")
    p_axes = param_axes(cfg)
    p_shard = specs_from_axes(p_axes, params, mesh, rules)
    B, S = shape.global_batch, shape.seq_len
    common = dict(arch=arch, cfg=cfg, shape=shape, mesh=mesh, model=model,
                  variant=variant)

    if shape.kind == "flround":
        # the paper's aggregation step on the mesh: K client updates
        # stacked on a 'cohort' axis sharded over data -> the weighted
        # global model
        K = shape.global_batch
        rules = dict(rules)
        rules["cohort"] = "data"
        upd = tree_map(lambda t: _meta((K,) + tuple(t.shape), t.dtype),
                       params)
        u_axes = map_axes(p_axes, lambda a: ("cohort",) + tuple(a))
        u_shard = specs_from_axes(u_axes, upd, mesh, rules)
        w = _meta((K,), torch.float32)
        if variant == "scatter_bf16":
            fn, w_shard, out_shard = _scatter_bf16(mesh), P("data"), p_shard
        else:
            # the aggregated model ZeRO-sharded over data as well
            fn, w_shard = fl_aggregate, P()
            out_shard = specs_from_axes(p_axes, params, mesh, rules,
                                        zero1=True)
        return Cell(rules=rules, fn=fn, in_args=(upd, w),
                    in_shardings=(u_shard, w_shard), out_shardings=out_shard,
                    kind="flround", logical_args=(upd, w), **common)

    if shape.kind == "train":
        opt = build_optimizer(cfg.optimizer, cfg.learning_rate)
        opt_state = opt.init(params)
        logical_state = _logical_opt_state(cfg.optimizer, params,
                                           cfg.learning_rate)
        o_axes = opt_state_axes(cfg.optimizer, p_axes)
        o_shard = specs_from_axes(o_axes, logical_state, mesh, rules,
                                  zero1=cfg.zero1)
        batch, b_axes = _batch(cfg, shape)
        b_shard = specs_from_axes(b_axes, batch, mesh, rules)
        fn = functools.partial(train_mod.train_step, model, opt)
        return Cell(rules=rules, fn=fn, in_args=(params, opt_state, batch),
                    in_shardings=(p_shard, o_shard, b_shard),
                    out_shardings=(p_shard, o_shard, P()), kind="train",
                    logical_args=(params, logical_state, batch), opt=opt,
                    **common)

    if shape.kind == "prefill":
        batch, b_axes = _batch(cfg, shape)
        b_shard = specs_from_axes(b_axes, batch, mesh, rules)
        cache = _build_cache(model, cfg, B, S)
        c_shard = specs_from_axes(model.cache_axes(), cache, mesh, rules)

        def prefill(params, batch):
            logits, caches, _ = model.apply(params, batch, make_cache=True)
            return logits[:, -1:, :], caches

        return Cell(rules=rules, fn=prefill, in_args=(params, batch),
                    in_shardings=(p_shard, b_shard),
                    out_shardings=(P(), c_shard), kind="prefill",
                    logical_args=(params, batch), **common)

    # decode: one new token against a cache of length S
    cache = _build_cache(model, cfg, B, S)
    c_shard = specs_from_axes(model.cache_axes(), cache, mesh, rules)
    tokens = _meta((B, 1), torch.int32)
    t_shard = specs_from_axes(("batch", None), tokens, mesh, rules)
    pos = torch.tensor(S - 1, dtype=torch.int32)     # the cache's last slot

    def serve_step(params, caches, tokens, pos):
        return model.decode_step(params, caches, tokens, pos)

    return Cell(rules=rules, fn=serve_step, in_args=(params, cache, tokens,
                                                     pos),
                in_shardings=(p_shard, c_shard, t_shard, P()),
                out_shardings=(P(), c_shard), kind="decode",
                logical_args=(params, cache, tokens, _meta((), torch.int32)),
                **common)
