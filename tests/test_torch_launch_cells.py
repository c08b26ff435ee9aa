"""The slice as a whole: the port's four cell kinds against the
reference's, run. For Qwen3 (dense), DeepSeek-V2-Lite (MoE + MLA) and
SeamlessM4T (enc-dec) at their smoke configs, each kind's cell is built
by both packages' ``build_cell`` at a small shape; the reference's runs
compiled on a one-device ``jax.sharding.Mesh``, the port's on the CPU
(its ``1x1`` mesh), from the reference's params converted through numpy
and the same arguments (the port's ``Cell.make_args``, carried over). The
outputs agree at rtol 1e-4 / atol 1e-5: the loss, the updated params and
the Adam moments (the port's fused rows against the reference's trees
raveled in the same order), the logits tail, the caches, the aggregate.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.kernels.ops import tree_leaves
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_card_mesh
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from test_torch_launch_specs import cached_reference_axes  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
# DeepSeek's cells run in ``test_torch_launch_cells_moe.py`` (the suite
# spreads files over its workers)
ARCHS = ("qwen3-1.7b", "seamless-m4t-large-v2")
SHAPES = {"train": ("x_train", 16, 2, "train"),
          "prefill": ("x_prefill", 16, 2, "prefill"),
          "decode": ("x_decode", 16, 2, "decode"),
          "flround": ("x_round", 0, 3, "flround")}


def _overrides(arch):
    smoke = get_config(arch, smoke=True)
    return {f.name: getattr(smoke, f.name)
            for f in dataclasses.fields(smoke) if f.name != "name"}


_PARAMS: dict = {}


def _ref_params(cfg):
    """The reference's params of ``cfg`` (its own ``init``), once an
    arch."""
    if cfg.name not in _PARAMS:
        _PARAMS[cfg.name] = jbuild(cfg).init(jax.random.PRNGKey(2))[0]
    return _PARAMS[cfg.name]


def _np(tree):
    """A tree of tensors (or a tuple of trees) as numpy; a Python int as
    is."""
    if isinstance(tree, torch.Tensor):
        return params_to_numpy(tree.detach())
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


def _close(got, want, what):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_runs_as_the_references(arch, kind):
    check_cell(arch, kind)


def check_cell(arch, kind):
    ov = _overrides(arch)
    cell = steps.build_cell(arch, ShapeConfig(*SHAPES[kind]),
                            make_card_mesh(), overrides=ov)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jcell = jsteps.build_cell(arch, JShapeConfig(*SHAPES[kind]), mesh,
                              overrides=ov)
    jfn = jcell.lower().compile()
    jparams = _ref_params(jcell.cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    args = cell.make_args("cpu", params=None if kind == "flround"
                          else params, seed=5)
    to_jax = lambda tree: jax.tree.map(jnp.asarray, _np(tree))
    if kind == "train":
        jopt = jcell.in_args[1]
        jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jopt)
        jargs = (jparams, jstate, to_jax(args[2]))
    elif kind == "prefill":
        jargs = (jparams, to_jax(args[1]))
    elif kind == "decode":
        jargs = (jparams, to_jax(args[1]), to_jax(args[2]),
                 jnp.int32(int(args[3])))
    else:
        upd = jax.tree.map(jnp.asarray, _np(args[0]))
        jargs = (upd, to_jax(args[1]))
    want = jfn(*jargs)
    got = cell.fn(*args)
    if kind == "train":
        p, state, loss = got
        jp, jstate, jloss = want
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                                   atol=ATOL)
        _close(p, jp, "params")
        if cell.cfg.optimizer == "adam":        # the fused rows, raveled
            n = sum(t.numel() for t in tree_leaves(p))
            for k in ("m", "v"):
                flat = np.concatenate([np.asarray(x).ravel() for x in
                                       jax.tree.leaves(jstate[k])])
                np.testing.assert_allclose(state[k][0, :n].numpy(), flat,
                                           rtol=RTOL, atol=ATOL)
            assert state["t"] == int(jstate["t"]) == 1
    elif kind in ("prefill", "decode"):
        _close(got[0], want[0], "logits")
        assert tuple(got[0].shape) == tuple(want[0].shape)
        _close(got[1], want[1], "caches")
    else:
        _close(got, want, "aggregate")
