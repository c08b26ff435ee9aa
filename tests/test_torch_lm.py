"""The decoder-LM families against the reference: dense (Qwen3, Granite,
Yi), since the MoE + MLA slice moe (DeepSeek-V2-Lite, Arctic; their SMOKE
configs route at capacity factor 8, so no token drops), and since the SSM
+ hybrid slice ssm (Mamba2) and hybrid (Zamba2).

Every comparison starts from the reference's params, carried over as numpy
(``params_from_numpy``), on seeded numpy inputs. fp32: rtol 1e-4 / atol
1e-5, as ``tests/test_torch_paper_models.py``. bf16 (the published
configs' ``param_dtype = compute_dtype = bfloat16``, through
``with_(...)``): the logits' relative L2 error within 3e-2, each grad
leaf's within 5e-2, the loss within 1e-2. bf16 keeps 8 mantissa bits and
the two frameworks round in other places (einsum accumulation, SiLU,
the grads' reductions); at these sizes the reference's own bf16 run
differs from its fp32 run by 0.9-1.2 % in the logits and up to 2.6 % in a
grad leaf, and the port's bf16 run from the reference's by 0.9 % and
1.7 %, so the limits hold the port to a few times the reference's own
bf16 rounding. Decode against prefill holds at the reference's own
2e-3 (``tests/test_models.py``)."""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import common as jcommon
from repro.models.lm import DecoderLM as JaxDecoderLM
from repro_torch.configs import base
from repro_torch.kernels.ops import RavelSpec, tree_leaves, tree_map
from repro_torch.models import api, attention, blocks, common
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.lm import DecoderLM
from repro_torch.models.paper_models import MnistCNN
from test_torch_client_store import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
BF16_LOGITS, BF16_GRADS, BF16_LOSS = 3e-2, 5e-2, 1e-2
DENSE = ("qwen3-1.7b", "granite-8b", "yi-6b", "qwen3-4b")
MOE = ("deepseek-v2-lite-16b", "arctic-480b")
SSM = ("mamba2-370m", "zamba2-2.7b")
CONFIG_FILES = sorted(p.name for p in (ROOT / "src/repro/configs").glob("*.py"))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _paths(tree, prefix=()):
    """(path, leaf) in ``jax.tree.leaves`` order for dict/list trees."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _cfgs(arch, dtype="float32"):
    jcfg = jbase.get_config(arch, smoke=True).with_(param_dtype=dtype,
                                                    compute_dtype=dtype)
    cfg = base.get_config(arch, smoke=True).with_(param_dtype=dtype,
                                                  compute_dtype=dtype)
    return jcfg, cfg


def _tokens(cfg, shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


# -- configs --------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_files_are_the_references_source(name):
    """Each of the port's config files is the reference's, verbatim apart
    from ``repro_torch`` read as ``repro``."""
    mine = (ROOT / "src/repro_torch/configs" / name).read_text()
    ref = (ROOT / "src/repro/configs" / name).read_text()
    assert mine.replace("repro_torch.", "repro.") == ref


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(jbase._MODULE_FOR))
def test_get_config_answers_for_every_id(arch, smoke):
    assert dataclasses.asdict(base.get_config(arch, smoke)) == \
        dataclasses.asdict(jbase.get_config(arch, smoke))


def test_shapes_ids_and_shape_support_equal_the_reference():
    assert tuple(base.ARCH_IDS) == tuple(jbase.ARCH_IDS)
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in base.ARCH_IDS:
        for shape in base.SHAPES:
            assert base.shape_supported(base.get_config(arch),
                                        base.SHAPES[shape]) == \
                jbase.shape_supported(jbase.get_config(arch),
                                      jbase.SHAPES[shape])


# -- primitives -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=16)).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-6)
    got = common.rms_norm(torch.as_tensor(x).to(getattr(torch, dtype)),
                          torch.as_tensor(w), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # the fp32 result rounds once to the input's type in both
    _close(got, want, *((RTOL, ATOL) if dtype == "float32" else (8e-3, 0)))


@pytest.mark.parametrize("positions", ["S", "BS"])
@pytest.mark.parametrize("has_heads", [True, False])
def test_apply_rope_matches_the_reference(positions, has_heads):
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 7, 3, 16
    x = rng.normal(size=(B, S, H, hd) if has_heads else (B, S, hd))
    x = x.astype(np.float32)
    pos = (np.arange(S) + 5 if positions == "S"
           else rng.integers(0, 600, (B, S))).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              has_heads=has_heads)
    got = common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                            has_heads=has_heads)
    _close(got, want)
    _close(common.rope_frequencies(hd, 1e6), jcommon.rope_frequencies(hd, 1e6))


def test_swiglu_and_layer_norm_match_the_reference():
    rng = np.random.default_rng(2)
    g, u, w, b = (rng.normal(size=s).astype(np.float32)
                  for s in ((4, 9), (4, 9), (9,), (9,)))
    _close(common.swiglu(torch.as_tensor(g), torch.as_tensor(u)),
           jcommon.swiglu(jnp.asarray(g), jnp.asarray(u)))
    _close(common.layer_norm(*map(torch.as_tensor, (g, w, b))),
           jcommon.layer_norm(*map(jnp.asarray, (g, w, b))))


# -- attention and blocks ------------------------------------------------------


def _gqa_cfg(qk_norm: bool, kv: int):
    jcfg = jbase.ModelConfig(d_model=32, n_heads=4, n_kv_heads=kv,
                             head_dim=8, qk_norm=qk_norm, rope_theta=1e4)
    return jcfg, base.ModelConfig(**dataclasses.asdict(jcfg))


def _ref_params(init_fn, *args, seed=0):
    pf = jcommon.ParamFactory(jax.random.PRNGKey(seed), jnp.float32)
    init_fn(pf, *args)
    return pf.params


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kv", [4, 2])          # g = 1 and g = 2
def test_gqa_forward_matches_the_reference(kv, qk_norm, cached):
    jcfg, cfg = _gqa_cfg(qk_norm, kv)
    jp = _ref_params(jattn.init_gqa, jcfg)
    p = _to_torch(jp)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    rng = np.random.default_rng(3)
    B, S, T, pos = 2, 3, 10, 4
    x = rng.normal(size=(B, S, 32)).astype(np.float32)
    positions = (np.arange(S) + (pos if cached else 0)).astype(np.int32)
    kw, jkw = {}, {}
    if cached:
        cache = {k: rng.normal(size=(B, T, kv, 8)).astype(np.float32)
                 for k in ("k", "v")}
        jkw = dict(cache=jax.tree.map(jnp.asarray, cache), pos=jnp.int32(pos))
        kw = dict(cache=tree_map(torch.as_tensor, cache), pos=pos)
    want, wcache = jattn.gqa_forward(jp, jnp.asarray(x), jcfg,
                                     jnp.asarray(positions), **jkw)
    got, gcache = attention.gqa_forward(p, torch.as_tensor(x), cfg,
                                        torch.as_tensor(positions), **kw)
    _close(got, want)
    if cached:
        for k in ("k", "v"):
            _close(gcache[k], wcache[k])
            # the caller's buffer is not written
            np.testing.assert_array_equal(kw["cache"][k].numpy(), cache[k])
    else:
        assert gcache is None and wcache is None


def test_gqa_cache_shape_and_unported_attention_raise():
    """The GQA and (since the MoE + MLA slice) MLA cache shapes equal the
    reference's; cross attention and the cross block, which raised before
    the VLM + enc-dec slice, now run: their params' names and shapes equal
    the reference's, and a gated block's zero gate leaves only the FFN's
    residual (values: ``tests/test_torch_xattn.py``)."""
    jcfg, cfg = _gqa_cfg(True, 2)
    s = attention.gqa_cache_shape(cfg, 3, 11, torch.bfloat16)
    js = jattn.gqa_cache_shape(jcfg, 3, 11, jnp.bfloat16)
    for k in ("k", "v"):
        assert tuple(s[k].shape) == js[k].shape and s[k].is_meta
        assert s[k].dtype == torch.bfloat16
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    s = attention.mla_cache_shape(cfg, 3, 11, torch.bfloat16)
    js = jattn.mla_cache_shape(jcfg, 3, 11, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in s.items()} == \
        {k: v.shape for k, v in js.items()}
    pf = common.ParamFactory(torch.Generator().manual_seed(0))
    attention.init_mla(pf, cfg)
    assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
        [(k, tuple(v.shape)) for k, v in _paths(_ref_params(
            jattn.init_mla, jcfg))]
    jcfg, cfg = _gqa_cfg(False, 2)
    jcfg, cfg = jcfg.with_(d_ff=48), cfg.with_(d_ff=48)
    for gated in (False, True):
        pf = common.ParamFactory(torch.Generator().manual_seed(0))
        blocks.init_cross_block(pf, cfg, gated=gated)
        assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
            [(k, tuple(v.shape)) for k, v in _paths(_ref_params(
                lambda f: jblk.init_cross_block(f, jcfg, gated=gated)))]
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1))
    kv = attention.cross_kv(pf.params["xattn"], torch.randn(2, 7, 32))
    assert tuple(kv["k"].shape) == (2, 7, 2, 8)
    p = pf.params
    y = blocks.cross_block(p, x, kv, cfg, gated=True)
    ffn = blocks.ffn_forward(p["mlp"], common.rms_norm(x, p["ln_mlp"]))
    torch.testing.assert_close(y, x + ffn, rtol=0, atol=0)


def test_decoder_block_matches_the_reference():
    jcfg, cfg = _gqa_cfg(True, 2)
    jcfg, cfg = jcfg.with_(d_ff=48), cfg.with_(d_ff=48)
    jp = _ref_params(lambda pf: jblk.init_decoder_block(pf, jcfg,
                                                        kind="dense"))
    p = _to_torch(jp)
    pf = common.ParamFactory(torch.Generator().manual_seed(0))
    blocks.init_decoder_block(pf, cfg, kind="dense")
    assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]
    x = np.random.default_rng(4).normal(size=(2, 6, 32)).astype(np.float32)
    want, _, waux = jblk.decoder_block(jp, jnp.asarray(x), jcfg,
                                       jnp.arange(6), kind="dense")
    got, cache, aux = blocks.decoder_block(p, torch.as_tensor(x), cfg,
                                           torch.arange(6), kind="dense")
    _close(got, want)
    assert cache is None and float(aux) == float(waux) == 0.0
    # the MoE + MLA slice's kinds, on DeepSeek-V2-Lite's smoke config
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    for kind in ("moe", "mla_dense", "mla_moe"):
        jp = _ref_params(lambda pf: jblk.init_decoder_block(pf, jcfg,
                                                            kind=kind))
        x = np.random.default_rng(4).normal(size=(2, 6, 64))
        x = x.astype(np.float32)
        want, _, waux = jblk.decoder_block(jp, jnp.asarray(x), jcfg,
                                           jnp.arange(6), kind=kind)
        got, _, aux = blocks.decoder_block(_to_torch(jp), torch.as_tensor(x),
                                           cfg, torch.arange(6), kind=kind)
        _close(got, want)
        _close(aux, waux)


# -- the decoder LM ------------------------------------------------------------


def _lm_pair(arch, dtype="float32", seed=0):
    jcfg, cfg = _cfgs(arch, dtype)
    jlm, lm = JaxDecoderLM(jcfg), DecoderLM(cfg)
    jp = jlm.init(jax.random.PRNGKey(seed))[0]
    return jlm, lm, jp, _to_torch(jp)


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_param_names_shapes_and_order_equal_the_references_init(arch):
    """Names, shapes and leaf order; the ssm and hybrid layers have no
    ``first`` list, the hybrid's stack is ``[n_chunks, attn_period, ...]``
    beside its ``shared`` block."""
    jcfg, cfg = _cfgs(arch)
    jp = JaxDecoderLM(jcfg).init(jax.random.PRNGKey(0))[0]
    p = DecoderLM(cfg).init(torch.Generator().manual_seed(0))
    assert set(p["layers"]) == set(jp["layers"])
    assert len(p["layers"].get("first", [])) == \
        len(jp["layers"].get("first", [])) == cfg.first_dense_layers
    assert [(k, tuple(v.shape)) for k, v in _paths(p)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]
    assert ("head" in p) == (not cfg.tie_embeddings)
    assert all(v.dtype == torch.float32 for v in tree_leaves(p))
    assert float(p["ln_f"].min()) == float(p["ln_f"].max()) == 1.0


def _lm_batch(cfg, B=2, S=12, seed=0):
    tok = _tokens(cfg, (B, S + 1), seed)
    tgt = tok[:, 1:].copy()
    tgt[0, -3:] = -1                              # masked targets
    return {"tokens": tok[:, :-1], "targets": tgt}


def _ref_loss_and_grads(jlm, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(jlm.loss, has_aux=True)(jp, jb)
    logits = jlm.apply(jp, {"tokens": jb["tokens"]})[0]
    return logits, loss, grads


def _port_loss_and_grads(lm, p, batch):
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = lm.loss(p, tb)
    loss.backward()
    with torch.no_grad():
        logits = lm.apply(p, {"tokens": tb["tokens"]})[0]
    return logits, loss, [leaf.grad for leaf in tree_leaves(p)], metrics


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_lm_logits_loss_and_grads_match_the_reference_fp32(arch):
    """Tied (qwen3, mamba2) and untied (granite, yi, zamba2) heads,
    qk-norm on (qwen3) and off, MLA with an MLA-dense first layer and
    shared experts (deepseek), GQA with a dense residual FFN (arctic), the
    Mamba2 stack (mamba2) and mamba chunks around a shared attention block
    (zamba2): logits, loss (CE plus the MoE aux loss) and every grad leaf,
    the tied embedding's grad summing its two uses, the shared block's
    its applications'."""
    jlm, lm, jp, p = _lm_pair(arch)
    batch = _lm_batch(lm.cfg)
    wlogits, wloss, wgrads = _ref_loss_and_grads(jlm, jp, batch)
    logits, loss, grads, metrics = _port_loss_and_grads(lm, p, batch)
    assert logits.shape == (2, 12, lm.cfg.vocab_size)
    _close(logits, wlogits)
    _close(loss, wloss)
    waux = jlm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})[1]
    _close(metrics["aux"], waux["aux"])
    assert (float(metrics["aux"].detach()) > 0) == (arch in MOE)
    wleaves = jax.tree.leaves(wgrads)
    assert len(grads) == len(wleaves)
    for (path, _), g, w in zip(_paths(p), grads, wleaves):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_lm_logits_loss_and_grads_match_the_reference_bf16(arch):
    jlm, lm, jp, p = _lm_pair(arch, "bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in tree_leaves(p))
    batch = _lm_batch(lm.cfg)
    wlogits, wloss, wgrads = _ref_loss_and_grads(jlm, jp, batch)
    logits, loss, grads, _ = _port_loss_and_grads(lm, p, batch)
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert _rel_l2(logits, wlogits) <= BF16_LOGITS
    assert abs(float(loss.detach()) - float(wloss)) <= BF16_LOSS
    for (path, _), g, w in zip(_paths(p), grads, jax.tree.leaves(wgrads)):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, w) <= BF16_GRADS, path


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-8b"] + list(MOE)
                         + list(SSM))
def test_decode_step_matches_the_references(arch):
    """Prefill into a cache, then one decode step, in both packages: the
    logits and every cache leaf (MLA's compressed ``c`` and ``k_pe`` for
    deepseek, its first layer's among them; the mamba states, and the
    shared block's K/V for zamba2)."""
    jlm, lm, jp, p = _lm_pair(arch)
    tok = _tokens(lm.cfg, (2, 9), seed=5)
    wl, wc, _ = jlm.apply(jp, {"tokens": jnp.asarray(tok[:, :8])},
                          make_cache=True, cache_len=12)
    gl, gc, _ = lm.apply(p, {"tokens": torch.as_tensor(tok[:, :8])},
                         make_cache=True, cache_len=12)
    _close(gl, wl)
    wd, wc2 = jlm.decode_step(jp, wc, jnp.asarray(tok[:, 8:9]), jnp.int32(8))
    before = tree_map(torch.clone, gc)
    gd, gc2 = lm.decode_step(p, gc, torch.as_tensor(tok[:, 8:9]), 8)
    _close(gd, wd)
    assert len(gc.get("first", [])) == len(gc2.get("first", [])) == \
        lm.cfg.first_dense_layers
    assert [k for k, _ in _paths(gc2)] == [k for k, _ in _paths(gc)]
    for (path, g), w in zip(_paths(gc2), jax.tree.leaves(wc2)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))
    # the caller's caches are not written
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gc),
                                                 tree_leaves(before)))
    if arch == "mamba2-370m":
        return
    kv = gc["shared"] if arch == "zamba2-2.7b" else gc["stack"]
    key = "c" if lm.cfg.kv_lora_rank else "k"
    assert float(kv[key][:, :, 8].abs().max()) == 0.0


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_prefill_then_decode_matches_full_forward(arch):
    """The twin of the reference's ``tests/test_models.py`` case: the full
    forward's logits at position S-1 equal a prefill of S-1 tokens into a
    cache of S+1 and one decode step at S-1 (tolerance 2e-3, the
    reference's); for MLA this holds the absorbed branch (prefill, decode)
    against the expanded one (the full forward), at cf 8 (no drops); for
    the mamba layers the recurrent step against the chunked scan, the
    state handed over by the prefill."""
    _, lm, _, p = _lm_pair(arch)
    assert lm.cfg.capacity_factor == 8.0 or arch in DENSE + SSM
    S = 12
    tok = torch.as_tensor(_tokens(lm.cfg, (1, S + 1), seed=9))
    with torch.no_grad():
        full, _, _ = lm.apply(p, {"tokens": tok[:, :S]})
        _, caches, _ = lm.apply(p, {"tokens": tok[:, :S - 1]},
                                make_cache=True, cache_len=S + 1)
        dec, caches = lm.decode_step(p, caches, tok[:, S - 1:S],
                                     torch.tensor(S - 1))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    struct = lm.cache_struct(1, S + 1)
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), caches) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), struct)


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_cache_struct_equals_the_references(arch):
    """GQA's ``k`` / ``v``, or MLA's ``c`` / ``k_pe`` (deepseek), per
    ``first`` layer and stacked; the mamba states (``conv`` bf16, ``h``
    fp32) stacked per layer (mamba2) or ``[n_chunks, attn_period, ...]``
    beside the shared block's K/V per application (zamba2)."""
    jcfg = jbase.get_config(arch)
    struct = DecoderLM(base.get_config(arch)).cache_struct(4, 576)
    jstruct, _ = JaxDecoderLM(jcfg).cache_struct(4, 576)
    if arch in SSM:
        assert [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."),
                 v.is_meta) for k, v in _paths(struct)] == \
            [(k, v.shape, str(v.dtype), True) for k, v in _paths(jstruct)]
        return
    assert len(struct["first"]) == len(jstruct["first"]) == \
        jcfg.first_dense_layers
    keys = ("c", "k_pe") if jcfg.kv_lora_rank else ("k", "v")
    assert set(struct["stack"]) == set(keys) == set(jstruct["stack"])
    for one, jone in zip(struct["first"] + [struct["stack"]],
                         jstruct["first"] + [jstruct["stack"]]):
        for k in keys:
            assert tuple(one[k].shape) == jone[k].shape
            assert one[k].dtype == torch.bfloat16 and one[k].is_meta


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
def test_published_count_on_meta_equals_the_references_eval_shape(arch):
    """The FULL config counted on the ``meta`` device (nothing allocated,
    nothing drawn) equals the reference's ``jax.eval_shape`` count, leaf by
    leaf, in bf16."""
    jlm = JaxDecoderLM(jbase.get_config(arch))
    shapes = jax.eval_shape(lambda r: jlm.init(r)[0], jax.random.PRNGKey(0))
    params = DecoderLM(base.get_config(arch)).init(device="meta")
    assert all(t.is_meta and t.dtype == torch.bfloat16
               for t in tree_leaves(params))
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [s.shape for s in jax.tree.leaves(shapes)]
    assert common.count_params(params) == \
        sum(int(s.size) for s in jax.tree.leaves(shapes))


def test_qwen3_1p7b_has_its_published_count():
    n = common.count_params(
        DecoderLM(base.get_config("qwen3-1.7b")).init(device="meta"))
    assert n == 1_720_574_976


@pytest.mark.parametrize("arch, layers, n", [
    ("deepseek-v2-lite-16b", None, 15_706_484_224),
    ("deepseek-v2-lite-16b", 3, 1_670_135_296),
    ("arctic-480b", 1, 14_069_945_344)])
def test_moe_counts_of_the_card_runs(arch, layers, n):
    """The counts of the MoE runs on the card (uncut DeepSeek, its 3-layer
    cut, Arctic's one layer at width), on the ``meta`` device."""
    cfg = base.get_config(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    assert common.count_params(DecoderLM(cfg).init(device="meta")) == n


@pytest.mark.parametrize("arch, layers, n", [
    ("mamba2-370m", None, 368_338_432),
    ("zamba2-2.7b", None, 2_435_782_560),
    ("zamba2-2.7b", 36, 1_717_794_240),
    ("zamba2-2.7b", 24, 1_239_135_360),
    ("zamba2-2.7b", 12, 760_476_480)])
def test_ssm_counts_of_the_card_runs(arch, layers, n):
    """The counts of the SSM and hybrid runs on the card (both uncut,
    Zamba2's 36-layer training cut, its 24-layer fallback, its 12-layer
    fp32 cut), on the ``meta`` device."""
    cfg = base.get_config(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    params = DecoderLM(cfg).init(device="meta")
    assert common.count_params(params) == n
    if arch == "zamba2-2.7b":
        assert params["layers"]["stack"]["ln"].shape == \
            (cfg.n_layers // 6, 6, cfg.d_model)


def test_hybrid_depth_must_split_into_chunks():
    """A hybrid's layers come in chunks of ``attn_period``; any other depth
    raises, as the reference's reshape would, and the launcher refuses
    ``--layers`` that is not a multiple."""
    from repro_torch.launch import train

    jcfg, cfg = _cfgs("zamba2-2.7b")
    assert cfg.attn_period == 2
    with pytest.raises(TypeError):
        JaxDecoderLM(jcfg.with_(n_layers=5)).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="attn_period 2"):
        DecoderLM(cfg.with_(n_layers=5))
    with pytest.raises(SystemExit):
        train.main(["--arch", "zamba2-2.7b", "--smoke", "--layers", "3",
                    "--steps", "1", "--device", "cpu"])
    out = train.main(["--arch", "zamba2-2.7b", "--smoke", "--layers", "2",
                      "--steps", "1", "--batch", "2", "--seq", "9",
                      "--device", "cpu"])
    assert out["params"]["layers"]["stack"]["ln"].shape == (1, 2, 64)


# -- remat ---------------------------------------------------------------------


def test_remat_changes_no_value_under_autograd_and_under_vmap():
    """``cfg.remat`` runs each layer under ``torch.utils.checkpoint`` with
    plain autograd (loss and grads bit-equal to remat off) and without it
    under ``torch.func.vmap(grad_and_value)``, where torch's checkpoint
    raises; the vmapped lanes equal the unbatched grads."""
    jcfg, cfg = _cfgs("qwen3-1.7b")
    assert cfg.remat
    p = _to_torch(JaxDecoderLM(jcfg).init(jax.random.PRNGKey(0))[0])
    batch = {k: torch.as_tensor(v) for k, v in _lm_batch(cfg).items()}
    out = {}
    for remat in (True, False):
        lm = DecoderLM(cfg.with_(remat=remat))
        q = tree_map(lambda t: t.clone().requires_grad_(True), p)
        loss = lm.loss(q, batch)[0]
        loss.backward()
        out[remat] = (loss, [t.grad for t in tree_leaves(q)])
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))

    lm = DecoderLM(cfg)
    lanes = tree_map(lambda t: torch.stack([t, t * 0.5]), p)
    xb = torch.stack([batch["tokens"]] * 2)
    yb = torch.stack([batch["targets"]] * 2)
    grad_fn = torch.func.vmap(torch.func.grad_and_value(
        lambda q, x, y: lm.loss(q, {"tokens": x, "targets": y})[0]))
    g, loss = grad_fn(lanes, xb, yb)
    _close(loss[0], out[True][0])
    for a, b in zip(tree_leaves(g), out[True][1]):
        _close(a[0], b)


# -- the API ---------------------------------------------------------------------


def test_build_model_raises_for_the_families_not_ported():
    """Every one of the fourteen configs builds, as in the reference: the
    dense, moe, ssm, hybrid and (since the VLM + enc-dec slice) vlm
    families a ``DecoderLM``, the enc-dec family an ``EncDecLM``, the
    paper configs their models; no family raises any more. ``DecoderLM``
    refuses the enc-dec family, as the reference's ``init`` does."""
    from repro_torch.models.encdec import EncDecLM

    families = {}
    for arch in sorted(jbase._MODULE_FOR):          # the fourteen configs
        cfg = base.get_config(arch)
        model = api.build_model(cfg)
        if cfg.family.startswith("paper"):
            assert not isinstance(model, (DecoderLM, EncDecLM)), arch
        else:
            want = EncDecLM if cfg.family == "encdec" else DecoderLM
            assert isinstance(model, want), arch
        families[arch] = cfg.family
    assert len(families) == 14
    assert set(families.values()) > {"dense", "moe", "ssm", "hybrid", "vlm",
                                     "encdec"}
    assert isinstance(api.build_model(base.get_config("paper-mnist")),
                      MnistCNN)
    with pytest.raises(ValueError, match="does not handle family encdec"):
        DecoderLM(base.get_config("seamless-m4t-large-v2"))


@pytest.mark.parametrize("shape", sorted(jbase.SHAPES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_input_specs_equal_the_references(arch, shape):
    batch, axes = api.input_specs(base.get_config(arch), base.SHAPES[shape])
    jbatch, jaxes = japi.input_specs(jbase.get_config(arch),
                                     jbase.SHAPES[shape])
    assert axes == jaxes
    assert {k: (s, str(d).removeprefix("torch."))
            for k, (s, d) in batch.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jbatch.items()}


def test_lm_client_adapter_matches_the_references():
    jcfg, cfg = _cfgs("qwen3-1.7b")
    jad, ad = japi.LMClientAdapter(jcfg), api.LMClientAdapter(cfg)
    jp = jad.init(jax.random.PRNGKey(3))[0]
    p = _to_torch(jp)
    b = _lm_batch(cfg, B=4, S=16, seed=4)
    b["targets"][2] = -1                              # an all-masked row
    jb = {"x": jnp.asarray(b["tokens"]), "y": jnp.asarray(b["targets"])}
    tb = {"x": torch.as_tensor(b["tokens"]),
          "y": torch.as_tensor(b["targets"]).long()}
    with torch.no_grad():
        acc = ad.accuracy(p, tb)
        loss, _ = ad.loss(p, tb)
    assert acc.dtype == torch.float32
    assert float(acc) == float(jad.accuracy(jp, jb))
    _close(loss, jad.loss(jp, jb)[0])
    assert set(ad.init(torch.Generator().manual_seed(0))) == set(jp)


# -- tree helpers over list-bearing trees ----------------------------------------


def _list_tree(rng):
    return {"b": [{"y": rng.normal(size=(2, 3)), "x": rng.normal(size=4)},
                  rng.normal(size=(1,))],
            "a": rng.normal(size=(3, 2)),
            "c": {"first": [], "stack": {"w": rng.normal(size=(2, 2))}}}


def test_tree_helpers_take_lists_in_jax_order():
    rng = np.random.default_rng(6)
    tree = jax.tree.map(lambda a: a.astype(np.float32), _list_tree(rng))
    t = params_from_numpy(tree, "cpu")
    assert t["c"]["first"] == []
    assert [x.numpy().tolist() for x in tree_leaves(t)] == \
        [x.tolist() for x in jax.tree.leaves(tree)]
    doubled = tree_map(lambda x, y: x + y, t, t)
    assert isinstance(doubled["b"], list) and doubled["c"]["first"] == []
    back = params_to_numpy(doubled)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, 2 * b)


def test_ravel_spec_over_lists_equals_ravel_pytree():
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda a: a.astype(np.float32), _list_tree(rng))
    flat, unravel = ravel_pytree(tree)
    spec = RavelSpec(params_from_numpy(tree, "cpu"))
    t = params_from_numpy(tree, "cpu")
    np.testing.assert_array_equal(spec.ravel(t).numpy(), np.asarray(flat))
    back = spec.unravel(torch.as_tensor(np.array(flat)))
    assert jax.tree.structure(params_to_numpy(back)) == \
        jax.tree.structure(unravel(flat))
    rows = torch.stack([spec.ravel(t), 2 * spec.ravel(t)])
    views = spec.unravel_stacked(rows)
    assert views["c"]["first"] == []
    np.testing.assert_array_equal(views["b"][0]["y"][1].numpy(),
                                  2 * tree["b"][0]["y"])
    np.testing.assert_array_equal(spec.ravel_stacked(views).numpy(),
                                  rows.numpy())


def test_ravel_spec_of_lm_params_follows_the_references_leaf_order():
    jcfg, cfg = _cfgs("granite-8b")
    jp = JaxDecoderLM(jcfg).init(jax.random.PRNGKey(2))[0]
    flat, _ = ravel_pytree(jp)
    p = _to_torch(jp)
    np.testing.assert_array_equal(RavelSpec(p).ravel(p).numpy(),
                                  np.asarray(flat))


def test_bf16_params_cross_through_numpy_exactly():
    jp = JaxDecoderLM(_cfgs("qwen3-1.7b", "bfloat16")[0]).init(
        jax.random.PRNGKey(0))[0]
    p = _to_torch(jp)
    for a, b in zip(tree_leaves(p), jax.tree.leaves(jp)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


# -- the factory -------------------------------------------------------------------


def test_param_factory_scopes_ones_and_meta():
    pf = common.ParamFactory(torch.Generator().manual_seed(0), torch.bfloat16)
    with pf.scope("attn"):
        pf.param("wq", (4, 2))
        with pf.scope("inner"):
            pf.param("g", (3,), init="ones")
    pf.param("b", (2,), init="zeros")
    with pytest.raises(ValueError, match="duplicate param attn/wq"):
        with pf.scope("attn"):
            pf.param("wq", (4, 2))
    assert set(pf.params) == {"attn", "b"}
    assert pf.params["attn"]["inner"]["g"].dtype == torch.bfloat16
    assert float(pf.params["attn"]["inner"]["g"].sum()) == 3.0
    meta = common.ParamFactory(None, device="meta")
    w = meta.param("w", (1 << 20, 1 << 20))
    assert w.is_meta and w.shape == (1 << 20, 1 << 20)
    stacked = common.init_stacked(lambda f: f.param("v", (3, 2)),
                                  torch.Generator().manual_seed(1), 5,
                                  torch.float32)
    assert stacked["v"].shape == (5, 3, 2)
    assert not torch.equal(stacked["v"][0], stacked["v"][1])


def _old_initialize(gen, shape, dtype, init, scale, device=None, out=None):
    """The factory's draw before the init repair: an fp32 draw, scaled
    into a second fp32 copy, then cast."""
    assert out is None
    device = torch.device("cpu" if device is None else device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "normal":
        fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (
            shape[-1] if shape else 1)
        std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (x * std).to(dtype)
    std = scale if scale is not None else 0.02
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def _old_init_stacked(init_fn, generator, n, dtype, *args, device=None):
    """The stacked init before the repair: every block drawn whole, then
    ``torch.stack``-ed."""
    blocks_ = []
    for _ in range(n):
        pf = common.ParamFactory(generator, dtype, device)
        init_fn(pf, *args)
        blocks_.append(pf.params)
    return tree_map(lambda *xs: torch.stack(xs), blocks_[0], *blocks_[1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_init_repair_keeps_every_value(arch, dtype, monkeypatch):
    """Preallocated stacks and in-place scaling draw what the previous
    init drew: every leaf of every family's init equal to the bit, dtypes
    and all, to the init of whole blocks stacked afterwards with two fp32
    copies a leaf."""
    from repro_torch.models import lm as lm_mod

    cfg = _cfgs(arch, dtype)[1]
    new = DecoderLM(cfg).init(torch.Generator().manual_seed(5))
    monkeypatch.setattr(common, "_initialize", _old_initialize)
    monkeypatch.setattr(lm_mod, "init_stacked", _old_init_stacked)
    old = DecoderLM(cfg).init(torch.Generator().manual_seed(5))
    assert [k for k, _ in _paths(new)] == [k for k, _ in _paths(old)]
    for (path, a), b in zip(_paths(new), tree_leaves(old)):
        assert a.dtype == b.dtype == getattr(torch, dtype), path
        assert torch.equal(a, b), path


# -- the centralized training driver ---------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "yi-6b"] + list(MOE)
                         + list(SSM))
def test_launch_train_steps_match_the_references(arch):
    """Three steps of ``launch.train``'s step on its token stream, from the
    reference's params, against the reference driver's step (value and
    grad, the config's optimizer, ``apply_updates``): each loss and the
    final params within rtol 1e-4 / atol 1e-5. The port's ``adam`` is the
    fused kernel's form (its plain version here), the reference's on the
    CPU plain Adam: the same formula; Arctic's config takes Adafactor."""
    from repro.optim import apply_updates as japply
    from repro.optim import build_optimizer as jbuild
    from repro_torch.launch import train
    from repro_torch.optim import build_optimizer

    jlm, lm, jp, p = _lm_pair(arch)
    cfg = lm.cfg
    jopt = jbuild(cfg.optimizer, cfg.learning_rate)
    opt = build_optimizer(cfg.optimizer, cfg.learning_rate)
    assert opt.name == {"adam": "adam-fused",
                        "adafactor": "adafactor"}[cfg.optimizer]
    jstate, state = jopt.init(jp), opt.init(p)

    @jax.jit
    def jstep(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(jlm.loss, has_aux=True)(
            params, batch)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return japply(params, updates), opt_state, loss

    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        batch = train.token_batch(rng, cfg.vocab_size, 2, 17, "cpu")
        tokens = jrng.integers(0, cfg.vocab_size, (2, 17), dtype=np.int32)
        np.testing.assert_array_equal(batch["tokens"].numpy(), tokens[:, :-1])
        jp, jstate, jloss = jstep(jp, jstate, {
            "tokens": jnp.asarray(tokens[:, :-1]),
            "targets": jnp.asarray(tokens[:, 1:])})
        p, state, loss = train.train_step(lm, opt, p, state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert state["t"] == int(jstate["t"]) == 3
    for (path, a), b in zip(_paths(p), jax.tree.leaves(jp)):
        assert not a.requires_grad
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))
