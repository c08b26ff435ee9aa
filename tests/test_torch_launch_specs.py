"""The port's cells against the reference's, spec for spec: every arch's
logical-axes trees, the optimizer states' axes, and every cell's in and
out specs and argument shapes on the reference's production meshes
(``jax.sharding.AbstractMesh``: no devices), built by both packages'
``build_cell``. The reference's axes come from a smoke-size init, once an
arch (cached here: the tree does not depend on the widths)."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding

from repro.configs.base import ARCH_IDS, SHAPES, get_config as jget
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro_torch.configs.base import get_config, shape_supported
from repro_torch.kernels.ops import tree_leaves
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.api import param_axes

_REF_AXES: dict = {}
MULTI_POD_ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b", "zamba2-2.7b")


def _ref_axes(cfg):
    """The reference's ``steps._param_axes`` (its smoke config's ``init``
    axes), once an arch; the init traced abstractly (``jax.eval_shape``),
    the axes, plain tuples, kept from the trace."""
    if cfg.name not in _REF_AXES:
        smoke, box = jbuild(jget(cfg.name, smoke=True)), {}

        def init(key):
            params, box["axes"] = smoke.init(key)
            return params

        jax.eval_shape(init, jax.random.PRNGKey(0))
        _REF_AXES[cfg.name] = box["axes"]
    return _REF_AXES[cfg.name]


@pytest.fixture(scope="module", autouse=True)
def cached_reference_axes():
    """The reference's ``build_cell`` takes its axes from ``_ref_axes``
    (the same tree as its own eager smoke init, without its compiles)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsteps, "_param_axes", _ref_axes)
    yield
    mp.undo()


def _specs(tree):
    """A tree of ``NamedSharding``s as their specs' tuples."""
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda x: isinstance(x, NamedSharding))


def _shapes(tree):
    """(shape, dtype name) of every leaf, reference or port."""
    def one(x):
        name = str(x.dtype).replace("torch.", "")
        return tuple(x.shape), name
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return one(tree)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_are_the_references(arch):
    """The logical axes of every param (the factory's record at each of
    the 53 LM ``param`` calls, ``"layers"`` in front of each stacked
    axis) and of every cache leaf, against the reference's ``init`` and
    ``cache_struct``; each leaf's axes as long as its shape at full
    width."""
    cfg = get_config(arch)
    axes = param_axes(cfg)
    assert axes == _ref_axes(cfg)
    params = build_model(cfg).init(None, device="meta")
    ranks = []
    steps._spec_map(lambda names, p: ranks.append((len(names), p.dim())),
                    steps.map_axes(axes, lambda a: steps.P(*a)), params)
    assert ranks and all(a == b for a, b in ranks)
    jm = jbuild(jget(arch, smoke=True))
    m = build_model(get_config(arch, smoke=True))
    if cfg.family == "encdec":
        jc = jm.cache_struct(2, 8, 8)[1]
    else:
        jc = jm.cache_struct(2, 8)[1]
    assert m.cache_axes() == jc


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "adafactor"])
def test_opt_state_axes_match_the_references(opt):
    """For every optimizer, over the deepest axes tree (DeepSeek's, a
    ``first`` list beside the stack)."""
    axes = param_axes(get_config("deepseek-v2-lite-16b"))
    assert steps.opt_state_axes(opt, axes) == jsteps.opt_state_axes(
        opt, _ref_axes(jget("deepseek-v2-lite-16b")))
    with pytest.raises(ValueError):
        steps.opt_state_axes("lion", axes)


def _check_cell(arch, shape_name, multi_pod):
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    jmesh = JaxAbstractMesh((2, 16, 16) if multi_pod else (16, 16), names)
    cell = steps.build_cell(arch, shape, mesh)
    jcell = jsteps.build_cell(arch, shape, jmesh)
    assert cell.kind == jcell.kind
    assert cell.rules == jcell.rules
    assert cell.in_shardings == _specs(jcell.in_shardings)
    assert cell.out_shardings == _specs(jcell.out_shardings)
    got = [_shapes(a) for a in cell.logical_args]
    want = [_shapes(jax.tree.map(lambda s: s, a)) for a in jcell.in_args]
    assert got == want
    ref_params = sum(int(np.prod(x.shape)) for x in
                     jax.tree.leaves(jcell.in_args[0]))
    assert cell.total_params() == ref_params
    return cell


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_on_16x16_has_the_references_specs(arch):
    """All five shapes of the arch (``long_500k`` where the reference
    runs it): in and out specs, argument shapes and dtypes in the
    reference's layout, and the param count equal to the reference's
    ``build_cell``'s on the same 16x16 abstract mesh."""
    for shape_name in SHAPES:
        if not shape_supported(get_config(arch), SHAPES[shape_name])[0]:
            continue
        cell = _check_cell(arch, shape_name, multi_pod=False)
        if cell.kind == "train":
            # the port's own arguments: the fused Adam's rows where the
            # reference keeps trees, everything else the same arrays
            p = cell.total_params()
            if cell.cfg.optimizer == "adam":
                assert cell.in_args[1]["m"].shape[1] >= p


@pytest.mark.parametrize("arch", MULTI_POD_ARCHS)
def test_cells_on_2x16x16_have_the_references_specs(arch):
    for shape_name in SHAPES:
        if shape_supported(get_config(arch), SHAPES[shape_name])[0]:
            _check_cell(arch, shape_name, multi_pod=True)


def test_scatter_bf16_variant_specs_and_its_mesh_raise():
    """``fl_round``'s ``scatter_bf16`` variant: the reference's specs
    (weights over data, the output as the params). On a production
    ``AbstractMesh`` its step no longer raises: over ``meta`` tensors it
    exchanges and launches nothing and gives the params' shapes in their
    dtypes (its psum over ranks runs on a process-group mesh,
    ``tests/test_torch_mesh_plane.py``); on ``1x1`` it is the sum rounded
    through bf16."""
    shape = SHAPES["fl_round"]
    cell = steps.build_cell("qwen3-1.7b", shape, make_production_mesh(),
                            variant="scatter_bf16")
    jcell = jsteps.build_cell("qwen3-1.7b", shape,
                              JaxAbstractMesh((16, 16), ("data", "model")),
                              variant="scatter_bf16")
    assert cell.in_shardings == _specs(jcell.in_shardings)
    assert cell.out_shardings == _specs(jcell.out_shardings)
    out = cell.fn(*cell.in_args)
    for got, want in zip(tree_leaves(out),
                         tree_leaves(cell.in_args[0])):
        assert got.is_meta and got.dtype == want.dtype
        assert tuple(got.shape) == tuple(want.shape[1:])
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.launch.dryrun import cut_shape
    small, _ = cut_shape(shape, global_batch=3)
    one = steps.build_cell("qwen3-1.7b", small, make_card_mesh(),
                           overrides=_smoke_overrides("qwen3-1.7b"),
                           variant="scatter_bf16")
    upd, w = one.make_args("cpu", seed=3)
    got = one.fn(upd, w)
    want = steps.fl_aggregate(upd, w)
    for k in ("tok_embed", "ln_f"):
        assert torch.equal(got[k], want[k].to(torch.bfloat16).to(
            want[k].dtype))


def _smoke_overrides(arch):
    smoke = get_config(arch, smoke=True)
    return {k: getattr(smoke, k) for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab_size", "param_dtype", "compute_dtype")}
