"""The VLM + enc-dec slice against the reference: cross attention (gated
and plain), the cross block, the ``vlm`` family of ``DecoderLM``
(Llama-3.2-Vision) and ``EncDecLM`` (SeamlessM4T), their caches and
decode steps, the launcher's batches for both, the serving example, and
the bf16 decode drift of the port against the reference's.

Every comparison starts from the reference's params, carried over as numpy
(``params_from_numpy``), on seeded numpy inputs (tokens, and normal
patches or frames), at the SMOKE configs. A fresh VLM's gates are zeros,
so its cross attention adds nothing: every VLM comparison first sets each
``gate`` to 0.5 in the reference's tree. fp32: rtol 1e-4 / atol 1e-5, as
``tests/test_torch_lm.py``. bf16: ``test_torch_lm``'s limits, the logits'
relative L2 error within 3e-2, each grad leaf's within 5e-2, the loss
within 1e-2. Prefill-then-decode against the full forward at the
reference's 2e-3. The bf16 decode drift (each decoded position's logits
against the full forward's, as the relative L2 over the vocabulary) of the
port within 1.5x the reference's drift plus 1e-3, from the same params."""
import dataclasses
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import common as jcommon
from repro_torch.configs import base
from repro_torch.kernels.ops import tree_leaves, tree_map
from repro_torch.launch import train
from repro_torch.models import api, attention, blocks, common
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM
from test_torch_client_store import one_torch_thread  # noqa: F401
from test_torch_lm import (ATOL, BF16_GRADS, BF16_LOGITS, BF16_LOSS, RTOL,
                           _close, _np, _paths, _rel_l2, _to_torch)

ROOT = Path(__file__).resolve().parents[1]
VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
ARCHS = (VLM, ENCDEC)
GATE = 0.5
DRIFT_FACTOR, DRIFT_ATOL = 1.5, 1e-3
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfgs(arch, dtype="float32"):
    jcfg = jbase.get_config(arch, smoke=True).with_(param_dtype=dtype,
                                                    compute_dtype=dtype)
    cfg = base.get_config(arch, smoke=True).with_(param_dtype=dtype,
                                                  compute_dtype=dtype)
    return jcfg, cfg


def _open_gates(jp):
    """The reference's VLM params with every cross block's gate at GATE
    (a no-op for other trees)."""
    cross = jp.get("layers", {}).get("cross")
    if cross is not None:
        cross["xattn"]["gate"] = jnp.full_like(cross["xattn"]["gate"], GATE)
    return jp


def _pair(arch, dtype="float32", seed=0):
    jcfg, cfg = _cfgs(arch, dtype)
    jlm, lm = japi.build_model(jcfg), api.build_model(cfg)
    jp = _open_gates(jlm.init(jax.random.PRNGKey(seed))[0])
    return jlm, lm, jp, _to_torch(jp)


def _memory(cfg, B, S, seed=0) -> dict:
    """Normal patches at every position (vlm) or S frames (encdec)."""
    rng = np.random.default_rng(100 + seed)
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                .astype(np.float32)}
    return {"frames": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)}


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _batch(cfg, B=2, S=12, seed=0) -> dict:
    tok = _tokens(cfg, (B, S + 1), seed)
    tgt = tok[:, 1:].copy()
    tgt[0, -3:] = -1                              # masked targets
    return {"tokens": tok[:, :-1], "targets": tgt, **_memory(cfg, B, 9, seed)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _ref_params(init_fn, seed=0):
    pf = jcommon.ParamFactory(jax.random.PRNGKey(seed), jnp.float32)
    init_fn(pf)
    return pf.params


def _small_cfgs():
    jcfg = jbase.ModelConfig(d_model=32, n_heads=4, n_kv_heads=2,
                             head_dim=8, d_ff=48)
    return jcfg, base.ModelConfig(**dataclasses.asdict(jcfg))


# -- cross attention and the cross block ----------------------------------------


@pytest.mark.parametrize("gated", [False, True])
def test_cross_attention_matches_the_reference(gated):
    """``cross_kv`` (K/V over a memory of 7 slots, GQA g = 2) and
    ``cross_forward``: no mask, no rope, the gated output scaled by
    ``tanh(gate)`` (0.5 here; the drawn gate is zero, and so is the gated
    output)."""
    jcfg, cfg = _small_cfgs()
    jp = _ref_params(lambda pf: jattn.init_cross(pf, jcfg, gated=gated))
    pf = common.ParamFactory(torch.Generator().manual_seed(0))
    attention.init_cross(pf, cfg, gated=gated)
    assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 7, 32)).astype(np.float32)
    if gated:
        assert float(pf.params["gate"]) == float(jp["gate"]) == 0.0
        y0 = attention.cross_forward(pf.params, torch.as_tensor(x),
                                     attention.cross_kv(
                                         pf.params, torch.as_tensor(mem)),
                                     gated=True)
        assert float(y0.abs().max()) == 0.0
        jp["gate"] = jnp.float32(GATE)
    p = _to_torch(jp)
    jkv = jattn.cross_kv(jp, jnp.asarray(mem))
    kv = attention.cross_kv(p, torch.as_tensor(mem))
    for k in ("k", "v"):
        assert tuple(kv[k].shape) == (2, 7, 2, 8)
        _close(kv[k], jkv[k])
    want = jattn.cross_forward(jp, jnp.asarray(x), jkv, gated=gated)
    got = attention.cross_forward(p, torch.as_tensor(x), kv, gated=gated)
    _close(got, want)


@pytest.mark.parametrize("gated", [False, True])
def test_cross_block_matches_the_reference(gated):
    """Pre-norm cross attention, then the SwiGLU FFN, which no gate
    scales: names, shapes and values."""
    jcfg, cfg = _small_cfgs()
    jp = _ref_params(lambda pf: jblk.init_cross_block(pf, jcfg, gated=gated))
    pf = common.ParamFactory(torch.Generator().manual_seed(0))
    blocks.init_cross_block(pf, cfg, gated=gated)
    assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]
    if gated:
        jp["xattn"]["gate"] = jnp.float32(GATE)
    p = _to_torch(jp)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 9, 32)).astype(np.float32)
    want = jblk.cross_block(jp, jnp.asarray(x),
                            jattn.cross_kv(jp["xattn"], jnp.asarray(mem)),
                            jcfg, gated=gated)
    got = blocks.cross_block(p, torch.as_tensor(x),
                             attention.cross_kv(p["xattn"],
                                                torch.as_tensor(mem)),
                             cfg, gated=gated)
    _close(got, want)


# -- the two families --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_names_shapes_and_order_equal_the_references_init(arch):
    """The VLM's ``layers`` are ``{"cross", "stack"}``, the stack ``[n_cross,
    cross_attn_period, ...]`` and the gates drawn as zeros; the enc-dec's
    leaves ``tok_embed``, ``ln_enc``, ``ln_f``, ``head``, ``encoder``,
    ``decoder``."""
    jcfg, cfg = _cfgs(arch)
    jp = japi.build_model(jcfg).init(jax.random.PRNGKey(0))[0]
    p = api.build_model(cfg).init(torch.Generator().manual_seed(0))
    assert [(k, tuple(v.shape)) for k, v in _paths(p)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]
    assert set(p) == set(jp)
    assert all(v.dtype == torch.float32 for v in tree_leaves(p))
    if arch == VLM:
        assert isinstance(api.build_model(cfg), DecoderLM)
        assert set(p["layers"]) == {"cross", "stack"}
        assert p["layers"]["stack"]["ln_attn"].shape == (2, 2, 64)
        assert float(p["layers"]["cross"]["xattn"]["gate"].abs().max()) == 0
        assert p["layers"]["stack"]["ln_attn"].is_contiguous()
    else:
        assert isinstance(api.build_model(cfg), EncDecLM)
        assert set(p) == {"tok_embed", "ln_enc", "ln_f", "head", "encoder",
                          "decoder"}
        assert p["encoder"]["ln_attn"].shape == (2, 64)


def _ref_loss_and_grads(jlm, jp, batch):
    jb = _j(batch)
    (loss, _), grads = jax.value_and_grad(jlm.loss, has_aux=True)(jp, jb)
    logits = jlm.apply(jp, {k: v for k, v in jb.items() if k != "targets"})[0]
    return logits, loss, grads


def _port_loss_and_grads(lm, p, batch):
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    tb = _t(batch)
    loss, _ = lm.loss(p, tb)
    loss.backward()
    with torch.no_grad():
        logits = lm.apply(p, {k: v for k, v in tb.items()
                              if k != "targets"})[0]
    return logits, loss, [leaf.grad for leaf in tree_leaves(p)]


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_the_reference_fp32(arch):
    """Logits, loss and every grad leaf, the gates' and the cross K/V
    projections' among them (the VLM's patches and the enc-dec's frames
    reach the loss only through them)."""
    jlm, lm, jp, p = _pair(arch)
    batch = _batch(lm.cfg)
    wlogits, wloss, wgrads = _ref_loss_and_grads(jlm, jp, batch)
    logits, loss, grads = _port_loss_and_grads(lm, p, batch)
    assert logits.shape == (2, 12, lm.cfg.vocab_size)
    _close(logits, wlogits)
    _close(loss, wloss)
    wleaves = jax.tree.leaves(wgrads)
    assert len(grads) == len(wleaves)
    for (path, _), g, w in zip(_paths(p), grads, wleaves):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))
    paths = [path for path, _ in _paths(p)]
    wk = paths.index(("layers", "cross", "xattn", "wk") if arch == VLM
                     else ("decoder", "cross", "wk"))
    assert float(grads[wk].abs().max()) > 1e-4       # cross attention acts


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_the_reference_bf16(arch):
    """bf16 at ``test_torch_lm``'s limits. Each grad leaf is held to the
    reference's bf16 grad, or, where that strays more than the limit from
    the reference's fp32 grad over the same (upcast) params, to the fp32
    grad: the VLM's gates, whose grad sums every token and channel, come
    out ~13 % off in the reference's bf16 run and ~3 % in the port's."""
    jlm, lm, jp, p = _pair(arch, "bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in tree_leaves(p))
    batch = _batch(lm.cfg)
    wlogits, wloss, wgrads = _ref_loss_and_grads(jlm, jp, batch)
    exact = _ref_loss_and_grads(
        japi.build_model(_cfgs(arch)[0]),
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), batch)[2]
    logits, loss, grads = _port_loss_and_grads(lm, p, batch)
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert _rel_l2(logits, wlogits) <= BF16_LOGITS
    assert abs(float(loss.detach()) - float(wloss)) <= BF16_LOSS
    held_to_fp32 = []
    for (path, _), g, w, x in zip(_paths(p), grads, jax.tree.leaves(wgrads),
                                  jax.tree.leaves(exact)):
        assert g.dtype == torch.bfloat16
        if _rel_l2(w, x) > BF16_GRADS:
            held_to_fp32.append(path)
            w = x
        assert _rel_l2(g, w) <= BF16_GRADS, path
    assert held_to_fp32 == ([("layers", "cross", "xattn", "gate")]
                            if arch == VLM else [])


def _prefill(jlm, lm, jp, p, tok, memory, cache_len):
    want = jlm.apply(jp, {"tokens": jnp.asarray(tok), **_j(memory)},
                     make_cache=True, cache_len=cache_len)
    got = lm.apply(p, {"tokens": torch.as_tensor(tok), **_t(memory)},
                   make_cache=True, cache_len=cache_len)
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_references(arch):
    """A prefill of 8 tokens into a cache of 12 (the enc-dec over 9
    frames), then one decode step, in both packages: the logits and every
    cache leaf (the self K/V, and the cross K/V over the patches or the
    encoded frames, which decode reads and hands on unchanged)."""
    jlm, lm, jp, p = _pair(arch)
    tok = _tokens(lm.cfg, (2, 9), seed=5)
    memory = _memory(lm.cfg, 2, 9, seed=5)
    (wl, wc, _), (gl, gc, _) = _prefill(jlm, lm, jp, p, tok[:, :8], memory,
                                        12)
    _close(gl, wl)
    assert [k for k, _ in _paths(gc)] == [k for k, _ in _paths(
        jax.tree.map(np.asarray, wc))]
    for (path, g), w in zip(_paths(gc), jax.tree.leaves(wc)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))
    wd, wc2 = jlm.decode_step(jp, wc, jnp.asarray(tok[:, 8:9]), jnp.int32(8))
    before = tree_map(torch.clone, gc)
    gd, gc2 = lm.decode_step(p, gc, torch.as_tensor(tok[:, 8:9]), 8)
    _close(gd, wd)
    for (path, g), w in zip(_paths(gc2), jax.tree.leaves(wc2)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))
    # the caller's caches are not written; the cross K/V go on as they are
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gc),
                                                 tree_leaves(before)))
    assert gc2["cross"] is gc["cross"]
    own = gc["stack"] if arch == VLM else gc["self"]
    assert float(own["k"][..., 8, :, :].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """The full forward's logits at position S-1 equal a prefill of S-1
    tokens into a cache of S+1 and one decode step at S-1 (the reference's
    2e-3), over the same patches or frames; the caches take the shapes of
    ``cache_struct``."""
    _, lm, _, p = _pair(arch)
    S = 12
    tok = torch.as_tensor(_tokens(lm.cfg, (1, S + 1), seed=9))
    memory = _t(_memory(lm.cfg, 1, 10, seed=9))
    with torch.no_grad():
        full, _, _ = lm.apply(p, {"tokens": tok[:, :S], **memory})
        _, caches, _ = lm.apply(p, {"tokens": tok[:, :S - 1], **memory},
                                make_cache=True, cache_len=S + 1)
        dec, caches = lm.decode_step(p, caches, tok[:, S - 1:S],
                                     torch.tensor(S - 1))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    struct = (lm.cache_struct(1, S + 1) if arch == VLM
              else lm.cache_struct(1, S + 1, 10))
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), caches) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), struct)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_struct_equals_the_references(arch):
    """The published configs' cache trees as ``meta`` tensors: the VLM's
    self K/V ``[n_cross, period, B, T, K, hd]`` and cross K/V over its
    1,601 patches; the enc-dec's (with ``enc_len``) self and cross K/V a
    decoder layer; names, shapes and dtypes as the reference's."""
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    if arch == VLM:
        struct = DecoderLM(cfg).cache_struct(4, 576)
        jstruct, _ = japi.build_model(jcfg).cache_struct(4, 576)
        assert tuple(struct["cross"]["k"].shape) == (8, 4, 1601, 8, 128)
    else:
        struct = EncDecLM(cfg).cache_struct(4, 576, 512)
        jstruct, _ = japi.build_model(jcfg).cache_struct(4, 576, 512)
        assert tuple(struct["cross"]["v"].shape) == (24, 4, 512, 16, 64)
    assert [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."),
             v.is_meta) for k, v in _paths(struct)] == \
        [(k, v.shape, str(v.dtype), True) for k, v in _paths(jstruct)]


@pytest.mark.parametrize("arch", ARCHS)
def test_published_count_on_meta_equals_the_references_eval_shape(arch):
    jlm = japi.build_model(jbase.get_config(arch))
    shapes = jax.eval_shape(lambda r: jlm.init(r)[0], jax.random.PRNGKey(0))
    params = api.build_model(base.get_config(arch)).init(device="meta")
    assert all(t.is_meta and t.dtype == torch.bfloat16
               for t in tree_leaves(params))
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [s.shape for s in jax.tree.leaves(shapes)]
    assert common.count_params(params) == \
        sum(int(s.size) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch, layers, n", [
    (VLM, None, 9_775_157_256), (VLM, 4, 2_141_237_249),
    (VLM, 8, 3_231_797_250), (ENCDEC, None, 2_034_784_256),
    (ENCDEC, 24, 1_279_748_096)])
def test_counts_of_the_card_runs(arch, layers, n):
    """The counts of the card's runs, cut as ``launch.train --layers``
    cuts them (the VLM in whole chunks, the enc-dec split evenly), on the
    ``meta`` device."""
    cfg = base.get_config(arch)
    if layers:
        cfg = train.cut_depth(cfg, layers)
    assert common.count_params(api.build_model(cfg).init(device="meta")) == n
    if arch == ENCDEC and layers:
        assert (cfg.enc_layers, cfg.dec_layers) == (12, 12)


def test_depth_must_split_into_chunks_and_halves():
    """A VLM's layers come in chunks of ``cross_attn_period``: any other
    depth raises, as the reference's reshape does, and the launcher
    refuses it; an enc-dec's ``--layers`` must be even."""
    jcfg, cfg = _cfgs(VLM)
    with pytest.raises(TypeError):
        japi.build_model(jcfg.with_(n_layers=3)).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="cross_attn_period 2"):
        DecoderLM(cfg.with_(n_layers=3))
    with pytest.raises(ValueError, match="does not handle family encdec"):
        DecoderLM(_cfgs(ENCDEC)[1])
    for arch in ARCHS:
        with pytest.raises(SystemExit):
            train.main(["--arch", arch, "--smoke", "--layers", "3",
                        "--steps", "1", "--device", "cpu"])
    out = train.main(["--arch", ENCDEC, "--smoke", "--layers", "2",
                      "--steps", "1", "--batch", "2", "--seq", "9",
                      "--device", "cpu"])
    assert out["params"]["encoder"]["ln_attn"].shape == (1, 64)
    assert out["params"]["decoder"]["ln_self"].shape == (1, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    """``cfg.remat`` wraps each VLM chunk and each enc-dec layer in
    ``torch.utils.checkpoint``: loss and grads bit-equal to remat off."""
    _, lm, _, p = _pair(arch)
    assert lm.cfg.remat
    batch = _t(_batch(lm.cfg))
    out = {}
    for remat in (True, False):
        model = api.build_model(lm.cfg.with_(remat=remat))
        q = tree_map(lambda t: t.clone().requires_grad_(True), p)
        loss = model.loss(q, batch)[0]
        loss.backward()
        out[remat] = (loss, [t.grad for t in tree_leaves(q)])
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


# -- the launcher ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_batches_and_steps_match_the_references(arch):
    """``step_batch`` draws the reference launcher's batches (tokens, then
    the VLM's zero patches or the enc-dec's normal frames from the same
    generator), and three of ``launch.train``'s steps on them from the
    reference's params match its step: each loss and the final params
    within rtol 1e-4 / atol 1e-5."""
    from repro.optim import apply_updates as japply
    from repro.optim import build_optimizer as jbuild
    from repro_torch.optim import build_optimizer

    jlm, lm, jp, p = _pair(arch)
    cfg = lm.cfg
    jopt = jbuild(cfg.optimizer, cfg.learning_rate)
    opt = build_optimizer(cfg.optimizer, cfg.learning_rate)
    jstate, state = jopt.init(jp), opt.init(p)

    @jax.jit
    def jstep(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(jlm.loss, has_aux=True)(
            params, batch)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return japply(params, updates), opt_state, loss

    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        batch = train.step_batch(rng, cfg, 2, 17, "cpu")
        tokens = jrng.integers(0, cfg.vocab_size, (2, 17), dtype=np.int32)
        jb = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        if arch == VLM:
            jb["patches"] = np.zeros((2, cfg.n_patches, cfg.d_model),
                                     np.float32)
        else:
            jb["frames"] = jrng.normal(size=(2, 16, cfg.d_model)).astype(
                np.float32)
        assert sorted(batch) == sorted(jb)
        for k, v in jb.items():
            np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
        jp, jstate, jloss = jstep(jp, jstate, _j(jb))
        p, state, loss = train.train_step(lm, opt, p, state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for (path, a), b in zip(_paths(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))


def test_step_batch_on_meta_advances_the_stream_as_a_real_draw():
    """The resume skip draws on the ``meta`` device: the generator ends
    where a real draw leaves it, frames included, and nothing is held."""
    cfg = base.get_config(ENCDEC, smoke=True)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    skipped = train.step_batch(a, cfg, 2, 9, "meta")
    train.step_batch(b, cfg, 2, 9, "cpu")
    assert all(t.is_meta for t in skipped.values())
    assert skipped["frames"].shape == (2, 8, 64)
    np.testing.assert_array_equal(a.normal(size=4), b.normal(size=4))


def test_launch_train_resumes_an_encdec_run_where_it_ends(tmp_path, capsys):
    """SeamlessM4T's smoke config, 4 steps with a checkpoint every 2, the
    step-4 checkpoint removed, then ``--resume``: the skip draws the
    frames of the steps it skips, so the resumed run ends on the
    uninterrupted run's losses, params and Adam state, to the bit."""
    from repro_torch.checkpoint import CheckpointManager

    def run(*extra):
        return train.main(["--arch", ENCDEC, "--smoke", "--steps", "4",
                           "--batch", "2", "--seq", "17", "--device", "cpu",
                           *extra])

    whole = run()
    ck = str(tmp_path / "ck")
    run("--ckpt-dir", ck, "--ckpt-every", "2")
    mgr = CheckpointManager(ck)
    shutil.rmtree(mgr._step_dir(4))
    resumed = run("--ckpt-dir", ck, "--ckpt-every", "2", "--resume")
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert resumed["losses"] == whole["losses"][2:]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(whole["params"])):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        assert torch.equal(resumed["opt_state"][k], whole["opt_state"][k])


# -- the serving example and the client adapter ------------------------------------


def _serve_example():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_example_decodes_the_full_forwards_argmax(arch, capsys):
    """The serving example on the CPU: random patches or frames drawn after
    the prompts, each decoded token the greedy pick of the full forward
    over the same patches or frames."""
    seqs = _serve_example()(["--arch", arch, "--device", "cpu", "--tokens",
                             "4", "--batch", "2", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "prefill 2x6 in" in out and f"({arch}, " in out
    assert seqs.shape == (2, 4)
    cfg = base.get_config(arch, smoke=True)
    model = api.build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    memory = ({"patches": torch.randn((2, cfg.n_patches, cfg.d_model),
                                      generator=gen)} if arch == VLM else
              {"frames": torch.randn((2, 6, cfg.d_model), generator=gen)})
    with torch.no_grad():
        logits, _, _ = model.apply(params, {"tokens": torch.cat(
            [prompts, seqs[:, :-1]], dim=1), **memory})
    assert torch.equal(torch.argmax(logits[:, 5:], dim=-1), seqs)


@pytest.mark.parametrize("arch, key", [(VLM, "patches"), (ENCDEC, "frames")])
def test_client_adapter_raises_the_references_key_error(arch, key):
    """The reference's ``LMClientAdapter`` passes only the tokens, so it
    cannot federate either family: its ``loss`` and ``accuracy`` raise
    ``KeyError`` for the patches or the frames, and the port's the same."""
    jcfg, cfg = _cfgs(arch)
    jad, ad = japi.LMClientAdapter(jcfg), api.LMClientAdapter(cfg)
    jp = jad.init(jax.random.PRNGKey(0))[0]
    p = ad.init(torch.Generator().manual_seed(0))
    tok = _tokens(cfg, (2, 8))
    jb = {"x": jnp.asarray(tok), "y": jnp.asarray(tok)}
    tb = {"x": torch.as_tensor(tok), "y": torch.as_tensor(tok).long()}
    for fn, params, b in ((jad.loss, jp, jb), (jad.accuracy, jp, jb),
                          (ad.loss, p, tb), (ad.accuracy, p, tb)):
        with pytest.raises(KeyError, match=key):
            fn(params, b)


# -- bf16 decode drift ------------------------------------------------------------


def _drift_script():
    spec = importlib.util.spec_from_file_location(
        "bf16_decode_drift", ROOT / "scripts" / "bf16_decode_drift.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch, layers, smoke", [
    (VLM, 4, True), (ENCDEC, 4, True), ("mamba2-370m", 4, False)],
    ids=["vlm-smoke", "encdec-smoke", "mamba2-width-4-layers"])
def test_bf16_decode_drift_is_the_references(arch, layers, smoke):
    """``scripts/bf16_decode_drift.py`` on one prompt of 16 tokens and 4
    decode steps, in bf16 from the same params: the port's decode strays
    from its own full forward no further than 1.5x the reference's from
    its own, plus 1e-3. The new families at their smoke widths (two
    chunks of the VLM, 2 + 2 enc-dec layers), and Mamba2 at its published
    width cut to 4 layers, the cheapest of the cuts whose drift (~1.5 %
    here, in both packages) grows with depth to the card's ~9 %."""
    rec = _drift_script().drift(arch, layers, batch=1, prompt=16, steps=4,
                                smoke=smoke)
    assert np.isfinite(rec["port_max"]) and np.isfinite(rec["reference_max"])
    assert rec["port_max"] <= DRIFT_FACTOR * rec["reference_max"] + DRIFT_ATOL
    if arch == "mamba2-370m":
        assert rec["reference_max"] > 1e-3 and rec["d_model"] == 1024
