"""The port's sharding rules against the reference's: twins of the rule
tests in ``tests/test_sharding.py`` and of the hypothesis properties in
``tests/test_sharding_props.py``. Every case also derives the same spec
with the reference's ``logical_spec`` / ``zero1_extend`` on a
``jax.sharding.AbstractMesh`` of the same axes and holds the two equal
(``tuple(port) == tuple(reference)``)."""
import pytest
import torch

from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.sharding import rules as jrules
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding.rules import (DECODE_RULES, DEFAULT_RULES,
                                        LONGCTX_RULES, AbstractMesh, P,
                                        axis_rules, current_mesh,
                                        logical_spec, make_param_sharding,
                                        mesh_shape, param_specs, shard_act,
                                        zero1_extend)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

PROP = dict(max_examples=60, deadline=None)
AXES = st.fixed_dictionaries({"data": st.sampled_from([1, 2, 4, 8, 16]),
                              "model": st.sampled_from([1, 2, 4, 8, 16])})


def _meshes(shape: dict):
    """The port's abstract mesh and the reference's, same axes."""
    names, sizes = tuple(shape), tuple(shape.values())
    return AbstractMesh(sizes, names), JaxAbstractMesh(sizes, names)


def _spec(names, dims, shape, rules=DEFAULT_RULES):
    """The port's spec, held equal to the reference's."""
    mesh, jmesh = _meshes(shape)
    got = logical_spec(names, dims, mesh, rules)
    want = jrules.logical_spec(names, dims, jmesh, rules)
    assert isinstance(got, P)
    assert tuple(got) == tuple(want), (names, dims, shape)
    return got


def _zero1(spec, dims, shape, axis="data"):
    mesh, jmesh = _meshes(shape)
    got = zero1_extend(spec, dims, mesh, axis)
    want = jrules.zero1_extend(JP(*spec), dims, jmesh, axis)
    assert tuple(got) == tuple(want), (spec, dims, shape)
    return got


def test_rule_tables_are_the_references():
    assert DEFAULT_RULES == jrules.DEFAULT_RULES
    assert DECODE_RULES == jrules.DECODE_RULES
    assert LONGCTX_RULES == jrules.LONGCTX_RULES


def test_divisible_dims_shard():
    assert _spec(("batch", "seq", "ffn"), (256, 4096, 14336),
                 {"data": 16, "model": 16}) == P("data", None, "model")


def test_non_divisible_falls_back_to_replication():
    # kv_heads = 8 does not divide 16 -> replicated, never padded
    assert _spec(("batch", "kv_heads", None), (128, 8, 128),
                 {"data": 16, "model": 16}) == P("data")


def test_multi_axis_rule_greedy_drop():
    shape = {"pod": 2, "data": 16, "model": 16}
    assert _spec(("batch",), (16,), shape) == P("data")
    assert _spec(("batch",), (32,), shape) == P(("pod", "data"))


def test_axis_never_used_twice():
    assert _spec(("ffn", "ffn"), (64, 64), {"data": 4, "model": 4}) \
        == P("model")


def test_zero1_extends_largest_free_dim():
    assert _zero1(P(None, "model"), (4096, 14336),
                  {"data": 16, "model": 16}) == P("data", "model")


def test_zero1_skips_when_nothing_divides():
    assert _zero1(P(), (7, 9), {"data": 16}) == P()
    assert _zero1(P("model"), (64,), {"model": 4}) == P("model")  # no data


def test_tuple_rule_resolves_multiple_axes():
    shape = {"data": 4, "model": 2}
    assert _spec(("batch",), (8,), shape) == P("data")
    rules = dict(DEFAULT_RULES, batch=("data", "model"))
    assert _spec(("batch",), (8,), shape, rules) == P(("data", "model"))
    assert _spec(("batch",), (4,), shape, rules) == P("model")


def test_shard_act_is_the_identity_outside_axis_rules():
    x = torch.arange(12.0).reshape(3, 4)
    assert shard_act(x, ("batch", "ffn")) is x
    assert current_mesh() is None


def test_shard_act_checks_its_spec_inside_axis_rules():
    """Inside ``axis_rules`` the spec is derived and checked and the
    tensor comes back as it is (no placement until the mesh slice); the
    spec is the rule table's, as the reference's resolves it on its mesh;
    a name count that is not the tensor's rank raises."""
    mesh = mesh_mod.make_debug_mesh(8)            # (2, 4)
    x = torch.arange(32.0).reshape(8, 4)
    with axis_rules(mesh):
        assert current_mesh() is mesh
        assert shard_act(x, ("batch", "ffn")) is x
        with pytest.raises(ValueError, match="logical names"):
            shard_act(x, ("batch",))
    assert current_mesh() is None
    assert _spec(("batch", "ffn"), (8, 4), {"data": 2, "model": 4}) \
        == P("data", "model")


def test_param_specs_and_sharding_keyed_by_the_mesh():
    """Specs over a nested axes tree (dicts and lists, as the LM's
    ``first``), against the reference's ``param_specs``; shapes may be
    tensors (``meta`` ones) or tuples."""
    mesh, jmesh = _meshes({"data": 16, "model": 16})
    axes = {"w": ("d_model", "ffn"), "first": [{"b": ("ffn",)}]}
    shapes = {"w": torch.empty((4096, 14336), device="meta"),
              "first": [{"b": (14336,)}]}
    got = param_specs(axes, shapes, mesh)
    import jax
    jshapes = {"w": jax.ShapeDtypeStruct((4096, 14336), "float32"),
               "first": [{"b": jax.ShapeDtypeStruct((14336,), "float32")}]}
    want = jrules.param_specs(axes, jshapes, jmesh)
    assert got == {"w": P(None, "model"), "first": [{"b": P("model")}]}
    assert got["w"] == tuple(want["w"])
    assert got["first"][0]["b"] == tuple(want["first"][0]["b"])
    sharding = make_param_sharding(axes, shapes, mesh)
    assert sharding["mesh"] is mesh and sharding["specs"] == got


def test_meshes_are_abstract_and_the_rules_read_only_names_and_sizes():
    """The production meshes hold axis names and sizes (no devices), the
    debug mesh's factorization is the reference's, and ``mesh_shape``
    reads a ``.shape`` mapping, an ``AbstractMesh`` and a DeviceMesh-like
    object alike."""
    from repro.launch.mesh import _debug_mesh_shape as jdebug

    m = mesh_mod.make_production_mesh()
    assert mesh_shape(m) == {"data": 16, "model": 16} and m.size == 256
    mm = mesh_mod.make_production_mesh(multi_pod=True)
    assert mesh_shape(mm) == {"pod": 2, "data": 16, "model": 16}
    assert mm.name == "2x16x16" and mm.size == 512
    for n in range(0, 40):
        assert mesh_mod._debug_mesh_shape(n) == jdebug(n), n

    class _DeviceMeshLike:
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(2, 4)

    assert mesh_shape(_DeviceMeshLike()) == {"data": 2, "model": 4}
    assert mesh_mod.PEAK_FLOPS_BF16 == 989e12
    assert mesh_mod.HBM_BW == 3.35e12 and mesh_mod.ICI_BW == 450e9


def _axes_of(part):
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


@given(AXES, st.integers(1, 4096))
@settings(**PROP)
def test_prop_divisibility_never_violated(shape, dim):
    spec = _spec(("batch", "ffn"), (dim, dim), shape)
    for part in list(spec) + [None] * (2 - len(spec)):
        n = 1
        for a in _axes_of(part):
            n *= shape[a]
        assert dim % n == 0


@given(AXES,
       st.lists(st.sampled_from([None, "batch", "ffn", "heads", "vocab",
                                 "seq"]), min_size=1, max_size=4),
       st.data())
@settings(**PROP)
def test_prop_each_mesh_axis_used_at_most_once(shape, names, data):
    dims = tuple(data.draw(st.integers(1, 2048)) for _ in names)
    spec = _spec(names, dims, shape)
    used = [a for part in spec for a in _axes_of(part)]
    assert len(used) == len(set(used))


@given(AXES,
       st.lists(st.sampled_from([None, "batch", "ffn", "heads", "vocab"]),
                min_size=1, max_size=3),
       st.data())
@settings(**PROP)
def test_prop_tuple_rules_resolve_to_listed_axes(shape, names, data):
    dims = tuple(data.draw(st.integers(1, 2048)) for _ in names)
    spec = _spec(names, dims, shape)
    for name, part in zip(names, list(spec) + [None] * len(names)):
        rule = DEFAULT_RULES.get(name) if name else None
        allowed = set(_axes_of(rule)) if rule else set()
        assert set(_axes_of(part)) <= allowed


@given(AXES, st.integers(1, 4096), st.integers(1, 4096))
@settings(**PROP)
def test_prop_zero1_only_adds_divisible_data_axis(shape, d0, d1):
    base = P(None, "model") if d1 % shape["model"] == 0 else P()
    out = _zero1(base, (d0, d1), shape)
    parts = list(out) + [None] * (2 - len(out))
    base_parts = list(base) + [None] * (2 - len(base))
    added = [(i, p) for i, (p, b) in enumerate(zip(parts, base_parts))
             if p != b]
    if not added:
        return
    assert len(added) == 1
    i, p = added[0]
    assert p == "data" and base_parts[i] is None
    assert (d0, d1)[i] % shape["data"] == 0


@given(st.fixed_dictionaries({"pod": st.sampled_from([1, 2, 4]),
                              "data": st.sampled_from([1, 2, 8, 16]),
                              "model": st.sampled_from([1, 4, 16])}),
       st.sampled_from([DEFAULT_RULES, DECODE_RULES, LONGCTX_RULES]),
       st.lists(st.sampled_from([None, "batch", "seq", "kv_seq", "heads",
                                 "kv_heads", "ffn", "experts", "vocab",
                                 "ssm_heads", "cohort"]),
                min_size=1, max_size=5),
       st.data())
@settings(**PROP)
def test_prop_every_table_matches_the_reference_on_three_axes(shape, rules,
                                                              names, data):
    """Any names, dims, table and 3-axis mesh: the port's spec and its
    ZeRO-1 extension are the reference's."""
    dims = tuple(data.draw(st.integers(1, 4096)) for _ in names)
    spec = _spec(names, dims, shape, rules)
    _zero1(spec, dims, shape)
