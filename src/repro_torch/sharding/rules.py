"""Logical-axis -> mesh-axis sharding rules (twin of ``repro.sharding.rules``).

Model code never names mesh axes. It tags parameters and caches with
*logical* axis names ("batch", "ffn", "heads", "experts", ...;
``models.common.ParamFactory`` records them). A rules table maps logical
names to mesh axes; specs are derived with divisibility checks, so a rule
degrades to replication when a dim does not divide (e.g. GQA kv=8 over a
16-way model axis) instead of relying on uneven-shard padding.

A spec is a ``P``: a tuple with one entry a dim (None, a mesh axis name,
or a tuple of names), trailing Nones trimmed, so ``tuple(port_spec) ==
tuple(reference_spec)`` compares it with the reference's ``PartitionSpec``.
The rules read a mesh's axis names and sizes through ``mesh_shape`` alone:
an ``AbstractMesh`` (names and sizes, no devices: the production meshes
are 256 or 512 devices, the card is one), a ``.shape`` mapping, or a
``torch.distributed`` ``DeviceMesh`` (or the FL mesh plane's
``flmesh.FLMesh``). Specs are derived, never applied: the FL mesh plane
lays out its update store and cohort itself (``flmesh.ROW_SPEC``), and
the LM cells' specs name a layout no tensor is placed by.

The active (mesh, rules) pair is installed with the ``axis_rules`` context
manager; ``shard_act`` is the identity outside it, and inside it derives
and checks the activation's spec and returns the tensor as it is.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Optional, Sequence, Union

Rule = Union[None, str, tuple]

# Logical axis -> preferred mesh axes (tuples try to use all listed axes).
DEFAULT_RULES: dict[str, Rule] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,          # decode KV caches: overridden per shape
    "d_model": None,
    "head_dim": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "expert_cap": None,
    "vocab": "model",
    "state": None,           # SSM state dim
    "ssm_heads": "model",
    "layers": None,
    "lora": None,
    "patches": None,
    "frames": None,
    "stats": None,
}

# Shape-kind specific overrides (see launch/steps.py ``rules_for``):
#  - long-context decode (global_batch=1): shard the cache sequence instead of batch
#  - decode: shard KV cache sequence over the model axis (kv heads rarely divide)
DECODE_RULES = dict(DEFAULT_RULES, kv_seq="model")
LONGCTX_RULES = dict(DEFAULT_RULES, batch=None, kv_seq=("data", "model"),
                     seq=("data", "model"))


class P(tuple):
    """A partition spec: one entry a dim, None (replicated), a mesh axis
    name or a tuple of names (the dim split over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """A mesh's axis names and sizes, no devices: what the rules read."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the reference's record names."""
        return "x".join(str(v) for v in self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> dict:
    """Axis name -> size of ``mesh``: the one place the rules read it."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


_ctx = threading.local()


@contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, dict(rules or DEFAULT_RULES)) if mesh is not None \
        else None
    try:
        yield
    finally:
        _ctx.state = prev


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def _mesh_axis_size(shape: dict, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _resolve_rule(rule: Rule, shape: dict, dim: int, used: set):
    """Return a tuple of mesh axes for one dim, or None (replicate)."""
    if rule is None:
        return None
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    axes = [a for a in axes if a in shape and a not in used]
    # Greedy: drop leading axes until the product divides the dim.
    while axes and (dim % _mesh_axis_size(shape, axes) != 0):
        axes = axes[1:]
    if not axes:
        return None
    used.update(axes)
    return tuple(axes) if len(axes) > 1 else axes[0]


def logical_spec(names: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: dict) -> P:
    """Build a ``P`` for one array from logical dim names."""
    sizes = mesh_shape(mesh)
    used: set = set()
    parts = []
    for name, dim in zip(names, shape):
        rule = rules.get(name) if name else None
        parts.append(_resolve_rule(rule, sizes, dim, used))
    # trim trailing Nones (cosmetic)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def shard_act(x, names: Sequence[Optional[str]]):
    """The identity outside ``axis_rules``; inside, derives ``x``'s spec
    from its logical names, checks that every sharded dim divides by its
    axes' product, and returns ``x`` as it is (the port applies no
    placement by a spec)."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return x
    mesh, rules = st
    if len(names) != x.dim():
        raise ValueError(f"{len(names)} logical names for a {x.dim()}-d "
                         "tensor")
    sizes = mesh_shape(mesh)
    spec = logical_spec(names, x.shape, mesh, rules)
    for part, dim in zip(spec, x.shape):
        axes = () if part is None else (part,) if isinstance(part, str) \
            else part
        if dim % _mesh_axis_size(sizes, axes):
            raise AssertionError(f"spec {spec} does not divide {x.shape}")
    return x


# ----------------------------------------------------------------------------
# Parameter / optimizer-state shardings
# ----------------------------------------------------------------------------


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _zip_map(fn, axes_tree: Any, shapes_tree: Any):
    """``fn(names, leaf)`` over an axes tree (tuples are leaves) and the
    tree of tensors (or shapes) it describes."""
    if _is_axes(axes_tree):
        return fn(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: _zip_map(fn, v, shapes_tree[k])
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [_zip_map(fn, a, s) for a, s in zip(axes_tree, shapes_tree)]
    raise TypeError(f"not an axes tree: {type(axes_tree).__name__}")


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_specs(axes_tree: Any, shapes_tree: Any, mesh,
                rules: Optional[dict] = None) -> Any:
    """axes_tree: tuples-of-names tree (see ``models.common.ParamFactory``).
    shapes_tree: matching tree of tensors (``meta`` ones too) or shapes."""
    rules = dict(rules or DEFAULT_RULES)
    return _zip_map(lambda names, arr: logical_spec(names, _shape(arr),
                                                    mesh, rules),
                    axes_tree, shapes_tree)


def make_param_sharding(axes_tree: Any, shapes_tree: Any, mesh,
                        rules: Optional[dict] = None) -> dict:
    """The params' specs keyed by the mesh they are for, ``{"mesh": mesh,
    "specs": tree of P}``: the port has no ``NamedSharding``."""
    return {"mesh": mesh,
            "specs": param_specs(axes_tree, shapes_tree, mesh, rules)}


def zero1_extend(spec: P, shape: Sequence[int], mesh,
                 axis: str = "data") -> P:
    """ZeRO-1: additionally shard an optimizer-state array over the data axis.

    Picks the largest dim not already sharded whose size divides the data-axis
    extent; replicates (returns spec unchanged) if none qualifies.
    """
    sizes = mesh_shape(mesh)
    if axis not in sizes:
        return spec
    n = sizes[axis]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for p in parts if p for a in ((p,) if isinstance(p, str) else p)}
    if axis in used:
        return spec
    best, best_dim = -1, 0
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if p is None and dim % n == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return spec
    parts[best] = axis
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)
