"""The MoE + MLA slice against the reference: the MoE layer, MLA
attention, the MoE and MLA decoder blocks, and Adafactor.

Every model case starts from the reference's params (``models.convert``)
at the SMOKE configs of DeepSeek-V2-Lite and Arctic, on seeded numpy
inputs. fp32: rtol 1e-5 / atol 1e-6 for the MoE layer's output and aux
loss, rtol 1e-4 / atol 1e-5 for attention and the blocks (as
``tests/test_torch_lm.py``); the dispatch indices (``top_e``, ``slot``,
``slot_token``, ``keep``) exactly. bf16: the relative L2 error within
``test_torch_lm``'s 3e-2. Adafactor's updates are elementwise apart from
its row, column and RMS means: rtol 1e-5 / atol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.configs import base as jbase
from repro.core.client import CohortTrainer as JaxTrainer
from repro.core.data_plane import DatasetStore as JaxDatasetStore
from repro.data.synthetic import make_federated_dataset
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch import optim
from repro_torch.configs import base
from repro_torch.core.client import CohortTrainer
from repro_torch.core.data_plane import DatasetStore
from repro_torch.kernels.ops import RavelSpec, tree_leaves, tree_map
from repro_torch.models import attention, blocks, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN
from test_torch_client_store import JaxBatchIndices, one_torch_thread  # noqa: F401

MOE_RTOL, MOE_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-4, 1e-5
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
BF16_REL = 3e-2
MOE_ARCHS = ("deepseek-v2-lite-16b", "arctic-480b")
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfgs(arch, dtype="float32", **over):
    jcfg = jbase.get_config(arch, smoke=True).with_(
        param_dtype=dtype, compute_dtype=dtype, **over)
    cfg = base.get_config(arch, smoke=True).with_(
        param_dtype=dtype, compute_dtype=dtype, **over)
    return jcfg, cfg


def _ref_params(init_fn, dtype=jnp.float32, seed=0):
    pf = jcommon.ParamFactory(jax.random.PRNGKey(seed), dtype)
    init_fn(pf)
    return pf.params


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, prefix + (i,))]
    return [(prefix, tuple(tree.shape))]


def _x(cfg, shape, seed=0, dtype="float32"):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))


def _jax_dispatch(p, x, cfg):
    """The reference's routing and dispatch (``moe_forward``'s lines up to
    the gather), with its own ops, for the indices it does not return."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = jmoe.capacity(T, cfg)
    xf = x.reshape(T, D)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_e = jax.lax.top_k(probs, K)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    flat_e = top_e.reshape(T * K)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    counts = jnp.sum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), axis=0)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    pos_in_e = jnp.arange(T * K, dtype=jnp.int32) - starts[sorted_e]
    keep = pos_in_e < C
    slot = jnp.where(keep, sorted_e * C + pos_in_e, E * C)
    slot_token = jnp.zeros((E * C + 1,), jnp.int32).at[slot].set(order // K)
    return {"top_e": top_e, "top_w": top_w, "order": order, "keep": keep,
            "slot": slot, "slot_token": slot_token[:-1], "C": C}


def _moe_pair(arch, dtype="float32", cf=8.0, seed=0):
    jcfg, cfg = _cfgs(arch, dtype, capacity_factor=cf)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = _ref_params(lambda pf: jmoe.init_moe(pf, jcfg), jdt, seed)
    return jcfg, cfg, jp, _to_torch(jp)


# -- the MoE layer ---------------------------------------------------------------


@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_the_reference(arch, dtype, cf):
    """cf 8 drops nothing, cf 0.25 drops most assignments: the dispatch
    indices equal the reference's exactly, ``y`` and ``aux`` within the
    dtype's limits."""
    jcfg, cfg, jp, p = _moe_pair(arch, dtype, cf)
    jx, x = _x(cfg, (4, 24, cfg.d_model), seed=1, dtype=dtype)
    want = _jax_dispatch(jp, jx, jcfg)
    T = 96
    assert moe.capacity(T, cfg) == want["C"] == jmoe.capacity(T, jcfg)
    _, top_w, top_e = moe.route(p, x.reshape(T, -1), cfg)
    d = moe.dispatch(top_e, want["C"], cfg.n_experts)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want["top_e"]))
    for k in ("order", "keep", "slot", "slot_token"):
        np.testing.assert_array_equal(d[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert bool((~d["keep"]).any()) == (cf < 1)
    wy, waux = jmoe.moe_forward(jp, jx, jcfg)
    y, aux = moe.moe_forward(p, x, cfg)
    assert y.dtype == x.dtype and aux.dtype == torch.float32
    if dtype == "float32":
        _close(top_w, want["top_w"], MOE_RTOL, MOE_ATOL)
        _close(y, wy, MOE_RTOL, MOE_ATOL)
        _close(aux, waux, MOE_RTOL, MOE_ATOL)
    else:
        assert _rel_l2(y, wy) <= BF16_REL
        _close(aux, waux, 1e-2, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_rounds_as_the_references_scatter_add(dtype):
    """The combine alone, on the same expert outputs and routing: the
    port's gather-and-sum in sorted-assignment order equals the
    reference's scatter-add to the bit, in fp32 and in bf16."""
    jcfg, cfg, jp, p = _moe_pair("deepseek-v2-lite-16b", cf=0.5)
    jx, x = _x(cfg, (3, 20, cfg.d_model), seed=2)
    want = _jax_dispatch(jp, jx, jcfg)
    assert not bool(want["keep"].all())
    T, K, E, C = 60, cfg.top_k, cfg.n_experts, want["C"]
    oe = np.random.default_rng(3).normal(size=(E * C, cfg.d_model))
    joe = jnp.asarray(oe, getattr(jnp, dtype))
    flat_w = want["top_w"].reshape(T * K)
    contrib = joe[jnp.clip(want["slot"], 0, E * C - 1)]
    contrib = contrib * (flat_w[want["order"]] * want["keep"]).astype(
        joe.dtype)[:, None]
    wy = jnp.zeros((T, cfg.d_model), joe.dtype).at[
        want["order"] // K].add(contrib)
    _, top_w, top_e = moe.route(p, x.reshape(T, -1), cfg)
    d = moe.dispatch(top_e, C, E)
    y = moe.combine(torch.as_tensor(np.array(joe, np.float32)).to(
        getattr(torch, dtype)), torch.as_tensor(np.array(want["top_w"])), d)
    np.testing.assert_array_equal(_np(y), _np(wy))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_reference_matches_the_references_and_moe_forward(arch):
    """The masked-dense oracle against the reference's, and the
    sort-based layer against it at cf 8 (no drops; the reference's own
    2e-4)."""
    jcfg, cfg, jp, p = _moe_pair(arch)
    jx, x = _x(cfg, (2, 9, cfg.d_model), seed=4)
    dense = moe.moe_reference(p, x, cfg)
    _close(dense, jmoe.moe_reference(jp, jx, jcfg), MOE_RTOL, MOE_ATOL)
    _close(moe.moe_forward(p, x, cfg)[0], dense, 2e-4, 2e-4)


def test_tied_router_picks_the_lowest_experts_as_lax_top_k():
    """An all-zero router makes every probability equal: each token takes
    experts 0..K-1 in order, as ``lax.top_k`` does."""
    jcfg, cfg, jp, p = _moe_pair("deepseek-v2-lite-16b")
    p["router"] = torch.zeros_like(p["router"])
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    jx, x = _x(cfg, (2, 5, cfg.d_model), seed=5)
    _, top_w, top_e = moe.route(p, x.reshape(10, -1), cfg)
    want = _jax_dispatch(jp, jx, jcfg)
    assert top_e.tolist() == [list(range(cfg.top_k))] * 10
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want["top_e"]))
    _close(top_w, want["top_w"], MOE_RTOL, MOE_ATOL)
    _close(moe.moe_forward(p, x, cfg)[0], jmoe.moe_forward(jp, jx, jcfg)[0],
           MOE_RTOL, MOE_ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_under_vmap_grad_matches_the_references_vmap(arch):
    """Per-lane value and grads of the MoE layer (output plus aux loss)
    under ``torch.func.vmap(grad_and_value)``, as the cohort trainer runs
    it, against the reference's ``vmap(value_and_grad)``, at a capacity
    that drops."""
    jcfg, cfg, jp, p = _moe_pair(arch, cf=1.0)
    rng = np.random.default_rng(6)
    lanes = rng.normal(size=(3, 2, 8, cfg.d_model)).astype(np.float32)
    scale = np.array([1.0, 0.5, 2.0], np.float32)
    jlanes = jax.tree.map(lambda a: jnp.stack([a * s for s in scale]), jp)
    tlanes = tree_map(lambda a: torch.stack([a * float(s) for s in scale]), p)

    def jloss(q, x):
        y, aux = jmoe.moe_forward(q, x, jcfg)
        return jnp.mean(jnp.square(y)) + aux

    def tloss(q, x):
        y, aux = moe.moe_forward(q, x, cfg)
        return torch.mean(torch.square(y)) + aux

    wv, wg = jax.vmap(jax.value_and_grad(jloss))(jlanes, jnp.asarray(lanes))
    g, v = torch.func.vmap(torch.func.grad_and_value(tloss))(
        tlanes, torch.as_tensor(lanes))
    _close(v, wv, MOE_RTOL, MOE_ATOL)
    for (path, _), a, b in zip(_paths(p), tree_leaves(g),
                               jax.tree.leaves(wg)):
        _close(a, b, RTOL, ATOL, str(path))


# -- MLA ---------------------------------------------------------------------------


def _mla_pair(dtype="float32"):
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b", dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = _ref_params(lambda pf: jattn.init_mla(pf, jcfg), jdt, seed=7)
    p = _to_torch(jp)
    assert _paths(p) == _paths(jax.tree.map(np.asarray, jp))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["uncached", "prefill", "decode"])
def test_mla_forward_matches_the_reference(mode, dtype):
    """The expanded branch (no cache), a prefill of S tokens into a cache
    at 0 and a one-token decode at pos 6 (both the absorbed branch): out
    and the cache leaves; the caller's cache is not written."""
    jcfg, cfg, jp, p = _mla_pair(dtype)
    B, T = 2, 10
    S, pos = {"uncached": (7, 0), "prefill": (7, 0), "decode": (1, 6)}[mode]
    jx, x = _x(cfg, (B, S, cfg.d_model), seed=8, dtype=dtype)
    positions = np.arange(S, dtype=np.int32) + pos
    kw, jkw = {}, {}
    if mode != "uncached":
        rng = np.random.default_rng(9)
        cache = {"c": rng.normal(size=(B, T, cfg.kv_lora_rank)),
                 "k_pe": rng.normal(size=(B, T, cfg.qk_rope_dim))}
        cache = {k: v.astype(np.float32) for k, v in cache.items()}
        tdt = getattr(torch, dtype)
        jkw = dict(cache={k: jnp.asarray(v, getattr(jnp, dtype))
                          for k, v in cache.items()}, pos=jnp.int32(pos))
        kw = dict(cache={k: torch.as_tensor(v).to(tdt)
                         for k, v in cache.items()}, pos=pos)
        before = tree_map(torch.clone, kw["cache"])
    want, wcache = jattn.mla_forward(jp, jx, jcfg, jnp.asarray(positions),
                                     **jkw)
    got, gcache = attention.mla_forward(p, x, cfg,
                                        torch.as_tensor(positions), **kw)
    assert got.dtype == x.dtype
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel_l2(got, want) <= BF16_REL
    if mode == "uncached":
        assert gcache is None and wcache is None
        return
    for k in ("c", "k_pe"):
        if dtype == "float32":
            _close(gcache[k], wcache[k])
        else:
            assert _rel_l2(gcache[k], wcache[k]) <= BF16_REL
        assert torch.equal(kw["cache"][k], before[k])


def test_mla_absorbed_prefill_equals_the_expanded_branch():
    """The absorbed form over a fresh cache (prefill at 0) and the
    expanded form over the same tokens compute one attention."""
    _, cfg, _, p = _mla_pair()
    _, x = _x(cfg, (2, 9, cfg.d_model), seed=10)
    pos = torch.arange(9)
    full, _ = attention.mla_forward(p, x, cfg, pos)
    cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     attention.mla_cache_shape(cfg, 2, 12, torch.float32))
    absorbed, _ = attention.mla_forward(p, x, cfg, pos, cache=cache, pos=0)
    _close(absorbed, full)


def test_mla_cache_shape_equals_the_references():
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    s = attention.mla_cache_shape(cfg, 3, 11, torch.bfloat16)
    js = jattn.mla_cache_shape(jcfg, 3, 11, jnp.bfloat16)
    assert set(s) == set(js) == {"c", "k_pe"}
    for k in s:
        assert tuple(s[k].shape) == js[k].shape
        assert s[k].is_meta and s[k].dtype == torch.bfloat16


# -- the MoE and MLA blocks ------------------------------------------------------


@pytest.mark.parametrize("arch, kind", [
    ("deepseek-v2-lite-16b", "mla_dense"), ("deepseek-v2-lite-16b", "mla_moe"),
    ("deepseek-v2-lite-16b", "moe"), ("arctic-480b", "moe")])
def test_decoder_block_kinds_match_the_reference(arch, kind):
    """Each block kind's params (names, shapes, order) and its output, new
    cache and aux loss against the reference's; Arctic's ``moe`` carries
    the parallel dense residual FFN under ``mlp/dense_res``."""
    jcfg, cfg = _cfgs(arch)
    jp = _ref_params(lambda pf: jblk.init_decoder_block(pf, jcfg, kind=kind))
    p = _to_torch(jp)
    pf = blocks.ParamFactory(torch.Generator().manual_seed(0))
    blocks.init_decoder_block(pf, cfg, kind=kind)
    assert _paths(pf.params) == _paths(p)
    assert ("dense_res" in p["mlp"]) == (cfg.dense_residual
                                         and kind.endswith("moe"))
    jx, x = _x(cfg, (2, 6, cfg.d_model), seed=11)
    want, _, waux = jblk.decoder_block(jp, jx, jcfg, jnp.arange(6),
                                       kind=kind)
    got, cache, aux = blocks.decoder_block(p, x, cfg, torch.arange(6),
                                           kind=kind)
    _close(got, want)
    _close(aux, waux, MOE_RTOL, MOE_ATOL)
    assert cache is None
    assert (float(aux) > 0) == kind.endswith("moe")


# -- Adafactor -------------------------------------------------------------------


def _tree(rng):
    """Rank-1, -2 and -3 leaves (and a list, as the LM's ``first``)."""
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "w": rng.normal(size=(5, 6)).astype(np.float32),
            "first": [{"e": rng.normal(size=(3, 4, 5)).astype(np.float32)}]}


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_adafactor_pytree_form_matches_the_reference(clip):
    """Five steps of the reference's formula: the updates, the params, the
    factored state (row / col for rank >= 2, v for rank 1) and ``t``. At
    clip 0.5 every leaf's update is clipped to RMS lr * 0.5; at 100 none
    is."""
    rng = np.random.default_rng(12)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    p = params_from_numpy(_tree(np.random.default_rng(12)), "cpu")
    jopt, opt = joptim.adafactor(1e-2, clip=clip), optim.adafactor(1e-2,
                                                                 clip=clip)
    assert optim.build_optimizer("adafactor", 1e-2).name == "adafactor"
    jstate, state = jopt.init(jp), opt.init(p)
    shapes = lambda tree: [(path, shape) for path, shape in _paths(tree)]
    assert shapes(state["s"]) == shapes(jax.tree.map(np.asarray,
                                                     jstate["s"]))
    assert state["s"]["w"]["row"].shape == (5,)
    assert state["s"]["first"][0]["e"]["col"].shape == (3, 5)
    for step in range(5):
        g = _tree(np.random.default_rng(100 + step))
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        upd, state = opt.update(params_from_numpy(g, "cpu"), state, p)
        for a, b in zip(tree_leaves(upd), jax.tree.leaves(jupd)):
            assert a.dtype == torch.float32
            _close(a, b, OPT_RTOL, OPT_ATOL)
            rms = float(torch.sqrt(torch.mean(torch.square(a))))
            if clip < 1:
                assert rms == pytest.approx(1e-2 * clip, rel=1e-4)
            else:
                assert rms < 1e-2 * clip
        jp = joptim.apply_updates(jp, jupd)
        p = optim.apply_updates(p, upd)
        for a, b in zip(tree_leaves(p), jax.tree.leaves(jp)):
            _close(a, b, OPT_RTOL, OPT_ATOL)
        for a, b in zip(tree_leaves(state["s"]), jax.tree.leaves(jstate["s"])):
            _close(a, b, OPT_RTOL, OPT_ATOL)
    assert state["t"] == int(jstate["t"]) == 5


def test_adafactor_cohort_form_follows_each_lane_of_the_reference():
    """The cohort form over ``[Kp, W]`` rows (W padded past the params)
    through the spec's leaf views: each active lane follows the pytree
    reference's trajectory, a finished lane and the pad columns are left
    as they are."""
    rng = np.random.default_rng(13)
    template = params_from_numpy(_tree(rng), "cpu")
    spec = RavelSpec(template)
    W = spec.n_params + 5
    steps = np.array([4, 1, 0, 3], np.int32)
    flat0 = rng.normal(size=(4, W)).astype(np.float32)
    flat = torch.as_tensor(flat0.copy())
    opt, jopt = optim.adafactor(5e-2), joptim.adafactor(5e-2)
    state = opt.cohort_init(flat, spec)
    unravel = lambda row: jax.tree.map(
        jnp.asarray, jax.tree.map(lambda t: t.numpy(),
                                  spec.unravel(torch.as_tensor(row))))
    lanes = [unravel(r) for r in flat0]
    jstates = [jopt.init(l) for l in lanes]
    for s in range(int(steps.max())):
        g = rng.normal(size=flat0.shape).astype(np.float32)
        g[:, spec.n_params:] = 0.0
        opt.cohort_step(flat, state, torch.as_tensor(g),
                        torch.as_tensor(steps), s)
        for i in np.flatnonzero(steps > s):
            upd, jstates[i] = jopt.update(unravel(g[i]), jstates[i], lanes[i])
            lanes[i] = joptim.apply_updates(lanes[i], upd)
        want = np.stack([np.concatenate([np.asarray(x).ravel() for x in
                                         jax.tree.leaves(l)]) for l in lanes])
        _close(flat[:, :spec.n_params], want, OPT_RTOL, OPT_ATOL)
    np.testing.assert_array_equal(flat[2].numpy(), flat0[2])
    np.testing.assert_array_equal(flat[:, spec.n_params:].numpy(),
                                  flat0[:, spec.n_params:])


def test_adafactor_cohort_trainer_matches_the_references():
    """ProxyCNN through the port's ``CohortTrainer(optimizer="adafactor")``
    against the reference's vmapped trainer, from the same params on the
    same draws, lanes of unequal step budgets and one pad lane: trained
    rows and mean losses within rtol 1e-4 / atol 1e-5 (the grads' own
    tolerance)."""
    data = make_federated_dataset("mnist", n_clients=6, scale=0.05, seed=0)
    jmodel, model = JaxProxyCNN(10), ProxyCNN(10)
    jparams = jmodel.init(jax.random.PRNGKey(3))[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    sel, steps = [4, 1, 2], np.array([3, 6, 1], np.int64)
    kw = dict(optimizer="adafactor", lr=1e-2, batch_size=5, seed=7)
    jstacked, _, jloss = JaxTrainer(jmodel, **kw).train_cohort_indexed(
        jparams, JaxDatasetStore(data), sel, data.n[sel], steps)
    tr = CohortTrainer(model, device="cpu",
                       batch_indices=JaxBatchIndices(7, 5), **kw)
    assert tr.opt.name == "adafactor"
    stacked, _, loss = tr.train_cohort_indexed(
        params, DatasetStore(data, device="cpu"), sel, data.n[sel], steps)
    _close(loss, jloss, RTOL, ATOL)
    for a, b in zip(tree_leaves(stacked), jax.tree.leaves(jstacked)):
        _close(a, b, RTOL, ATOL)
