"""The SSM + hybrid slice against the reference: the Mamba2 layer
(``models/ssm.py``: the chunked SSD scan, its O(S^2) oracle, the causal
conv, the full-sequence path with its cache handoff, the recurrent decode
step), the mamba and Zamba shared blocks, and the ``ssm_dt`` / ``ssm_a``
initializers.

Every model case starts from the reference's params (``models.convert``)
at the SMOKE configs of mamba2-370m and zamba2-2.7b, on seeded numpy
inputs. fp32: rtol 1e-4 / atol 1e-5, as ``tests/test_torch_lm.py``; the
oracle against the scan at the reference's own 1e-4, decode steps against
the full forward at its 2e-3 (``tests/test_models.py``). bf16: the
relative L2 error within ``test_torch_lm``'s 3e-2."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import blocks as jblk
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch.configs import base
from repro_torch.kernels.ops import tree_leaves, tree_map
from repro_torch.models import blocks, common, ssm
from repro_torch.models.convert import params_from_numpy
from test_torch_client_store import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
BF16_REL = 3e-2
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfgs(arch="mamba2-370m", dtype="float32"):
    jcfg = jbase.get_config(arch, smoke=True).with_(param_dtype=dtype,
                                                    compute_dtype=dtype)
    cfg = base.get_config(arch, smoke=True).with_(param_dtype=dtype,
                                                  compute_dtype=dtype)
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
    return [(prefix, tree)]


def _mixer_pair(arch="mamba2-370m", dtype="float32", seed=0):
    jcfg, cfg = _cfgs(arch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = _ref_params(lambda pf: jssm.init_mamba2(pf, jcfg), jdt, seed)
    return jcfg, cfg, jp, _to_torch(jp)


def _x(cfg, shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (jnp.asarray(x, jdt),
            torch.as_tensor(x).to(getattr(torch, dtype)))


def _ssd_inputs(B=2, S=64, H=3, P=4, N=5, seed=0):
    rng = np.random.default_rng(seed)
    xd = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = -rng.uniform(0.01, 0.6, size=(B, S, H)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return xd, a, Bm, Cm, h0


# -- sizes and the initializers ----------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_sizes_and_cache_shape_equal_the_references(arch, smoke):
    cfg, jcfg = base.get_config(arch, smoke), jbase.get_config(arch, smoke)
    for fn in ("d_inner", "n_ssm_heads", "conv_dim"):
        assert getattr(ssm, fn)(cfg) == getattr(jssm, fn)(jcfg), fn
    s = ssm.mamba2_cache_shape(cfg, 3, torch.bfloat16)
    js = jssm.mamba2_cache_shape(jcfg, 3, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in s.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in js.items()}
    assert all(v.is_meta for v in s.values())


def test_mixer_param_names_and_shapes_equal_the_references():
    jcfg, cfg = _cfgs()
    pf = common.ParamFactory(torch.Generator().manual_seed(0))
    ssm.init_mamba2(pf, cfg)
    jp = _ref_params(lambda f: jssm.init_mamba2(f, jcfg))
    assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_initializers_draw_in_their_ranges(dtype):
    """``ssm_dt``: softplus of ``dt_bias`` in [1e-3, 1e-1]; ``ssm_a``: exp
    of ``A_log`` in [1, 16]; each drawn in fp32 from the generator and
    cast (a bf16 leaf is the fp32 draw rounded once)."""
    shape = (4096,)
    dt = common._initialize(torch.Generator().manual_seed(1), shape, dtype,
                            "ssm_dt", None)
    a = common._initialize(torch.Generator().manual_seed(2), shape, dtype,
                           "ssm_a", None)
    assert dt.dtype == a.dtype == dtype
    u_dt = ssm.softplus(dt.float())
    u_a = torch.exp(a.float())
    slack = 1e-6 if dtype == torch.float32 else 2 ** -7
    assert float(u_dt.min()) >= 1e-3 * (1 - slack)
    assert float(u_dt.max()) <= 1e-1 * (1 + slack)
    assert float(u_a.min()) >= 1.0 * (1 - slack)
    assert float(u_a.max()) <= 16.0 * (1 + slack)
    # spread over the ranges, not stuck at an end
    assert float(u_dt.mean()) == pytest.approx(0.0505, rel=0.05)
    assert float(u_a.mean()) == pytest.approx(8.5, rel=0.05)
    if dtype == torch.bfloat16:
        want = common._initialize(torch.Generator().manual_seed(1), shape,
                                  torch.float32, "ssm_dt", None)
        assert torch.equal(dt, want.to(dtype))
    # into a preallocated leaf, and on meta nothing is drawn
    out = torch.empty(shape, dtype=dtype)
    got = common._initialize(torch.Generator().manual_seed(1), shape, dtype,
                             "ssm_dt", None, out=out)
    assert got is out and torch.equal(out, dt)
    meta = common._initialize(None, (1 << 40,), dtype, "ssm_a", None,
                              device="meta")
    assert meta.is_meta and meta.shape == (1 << 40,)


def test_ssm_initializers_through_the_factory_and_its_meta_path():
    """The factory's ``meta`` path allocates nothing at the published
    width; drawn, ``dt_bias`` and ``A_log`` leave their generator
    advanced (two stacked layers differ)."""
    cfg = base.get_config("mamba2-370m")
    stack = common.init_stacked(lambda f: blocks.init_mamba_block(f, cfg),
                                None, cfg.n_layers, torch.bfloat16,
                                device="meta")
    assert all(t.is_meta for t in tree_leaves(stack))
    assert tuple(stack["mixer"]["dt_bias"].shape) == (48, 32)
    _, small = _cfgs()
    drawn = common.init_stacked(lambda f: blocks.init_mamba_block(f, small),
                                torch.Generator().manual_seed(0), 2,
                                torch.float32)
    for k in ("dt_bias", "A_log"):
        assert not torch.equal(drawn["mixer"][k][0], drawn["mixer"][k][1])
    assert float(drawn["mixer"]["D_skip"].min()) == 1.0


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_softplus_is_jaxs(scale):
    """``softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``) in fp32,
    past 20 too, where ``F.softplus`` switches to ``x`` (atol 1e-37: XLA
    flushes subnormal results to zero, torch keeps them)."""
    x = (np.random.default_rng(3).normal(size=4096) * scale).astype(
        np.float32)
    got = ssm.softplus(torch.as_tensor(x))
    want = jax.nn.softplus(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-37)


# -- the scan --------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_the_reference(chunk, with_h0):
    """y and the final state against the reference's scan, from zeros or
    from an entering state ``h0``."""
    xd, a, Bm, Cm, h0 = _ssd_inputs()
    h0 = h0 if with_h0 else None
    wy, wh = jssm.ssd_chunked(*map(jnp.asarray, (xd, a, Bm, Cm)), chunk,
                              None if h0 is None else jnp.asarray(h0))
    y, h = ssm.ssd_chunked(*map(torch.as_tensor, (xd, a, Bm, Cm)), chunk,
                           None if h0 is None else torch.as_tensor(h0))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, wy)
    _close(h, wh)


def test_ssd_chunked_matches_both_oracles():
    """The scan against the port's O(S^2) oracle and the reference's, at
    the reference's own 1e-4; the oracles agree with each other."""
    xd, a, Bm, Cm, _ = _ssd_inputs(S=48, seed=1)
    t = [torch.as_tensor(v) for v in (xd, a, Bm, Cm)]
    y, _ = ssm.ssd_chunked(*t, 16)
    mine = ssm.ssd_reference(*t)
    ref = jssm.ssd_reference(*map(jnp.asarray, (xd, a, Bm, Cm)))
    _close(y, mine, 1e-4, 1e-4)
    _close(y, ref, 1e-4, 1e-4)
    _close(mine, ref)


def test_ssd_bf16_rounds_its_output_to_the_input_type():
    xd, a, Bm, Cm, _ = _ssd_inputs(S=32, seed=2)
    y, h = ssm.ssd_chunked(torch.as_tensor(xd).bfloat16(),
                           torch.as_tensor(a), torch.as_tensor(Bm).bfloat16(),
                           torch.as_tensor(Cm).bfloat16(), 16)
    wy, wh = jssm.ssd_chunked(jnp.asarray(xd, jnp.bfloat16), jnp.asarray(a),
                              jnp.asarray(Bm, jnp.bfloat16),
                              jnp.asarray(Cm, jnp.bfloat16), 16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert _rel_l2(y, wy) <= 1e-2
    _close(h, wh)


def test_segsum_matches_and_its_grads_are_finite():
    """-inf above the diagonal before ``exp``: the values equal the
    reference's, and the grads through ``exp`` are finite (masking after
    ``exp`` would give ``inf * 0 = NaN``)."""
    a = -np.random.default_rng(4).uniform(0.1, 3.0, size=(2, 3, 9))
    a = a.astype(np.float32)
    seg = ssm._segsum(torch.as_tensor(a))
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(seg.numpy()), np.isneginf(want))
    finite = np.isfinite(want)
    _close(seg.numpy()[finite], want[finite])
    t = torch.as_tensor(a).requires_grad_(True)
    torch.exp(ssm._segsum(t * 40.0)).sum().backward()
    assert bool(torch.isfinite(t.grad).all())
    wg = jax.grad(lambda v: jnp.exp(jssm._segsum(v * 40.0)).sum())(
        jnp.asarray(a))
    _close(t.grad, wg)


def test_ssd_grads_match_the_references():
    xd, a, Bm, Cm, h0 = _ssd_inputs(S=32, seed=5)

    def jf(*v):
        y, h = jssm.ssd_chunked(*v[:4], 8, v[4])
        return jnp.sum(y * y) + jnp.sum(jnp.sin(h))

    wg = jax.grad(jf, argnums=tuple(range(5)))(
        *map(jnp.asarray, (xd, a, Bm, Cm, h0)))
    t = [torch.as_tensor(v).requires_grad_(True)
         for v in (xd, a, Bm, Cm, h0)]
    y, h = ssm.ssd_chunked(*t[:4], 8, t[4])
    (torch.sum(y * y) + torch.sum(torch.sin(h))).backward()
    for got, want in zip(t, wg):
        _close(got.grad, want, 1e-4, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_the_reference(dtype, monkeypatch):
    """The unrolled conv in the input's dtype: fp32 at 1e-4 / 1e-5; in
    bf16 within 1e-2 relative L2, and its sum before SiLU (the bias, then W
    products, each rounded to bf16) equal to the reference's to the bit.
    The SiLU itself rounds apart in bf16: ``F.silu`` rounds once from fp32,
    ``jax.nn.silu`` rounds ``sigmoid(x)`` and then the product."""
    jcfg, cfg, jp, p = _mixer_pair(dtype=dtype)
    cd = ssm.conv_dim(cfg)
    jx, x = _x(cfg, (2, 11, cd), seed=6, dtype=dtype)
    rng = np.random.default_rng(7)
    b = rng.normal(size=cd).astype(np.float32) * 0.1
    want = jssm._causal_conv(jx, jp["conv_w"], jnp.asarray(b))
    got = ssm._causal_conv(x, p["conv_w"], torch.as_tensor(b))
    assert got.dtype == x.dtype
    if dtype == "float32":
        _close(got, want)
        return
    assert _rel_l2(got, want) <= 1e-2
    monkeypatch.setattr(jax.nn, "silu", lambda v: v)
    monkeypatch.setattr(torch.nn.functional, "silu", lambda v: v)
    want = jssm._causal_conv(jx, jp["conv_w"], jnp.asarray(b))
    got = ssm._causal_conv(x, p["conv_w"], torch.as_tensor(b))
    np.testing.assert_array_equal(_np(got), _np(want))


# -- the mixer -------------------------------------------------------------------


@pytest.mark.parametrize("cache", [None, {}])
@pytest.mark.parametrize("S", [1, 2, 12, 17, 48])
def test_mamba2_forward_matches_the_reference_fp32(S, cache):
    """S = 1 and 2 (the conv tail left-padded), 12 (one chunk of 12), 17
    (prime: chunk 1, one scan step a token), 48 (three chunks of 16); with
    no cache and with ``cache={}``, which asks for the new cache."""
    jcfg, cfg, jp, p = _mixer_pair()
    jx, x = _x(cfg, (2, S, cfg.d_model), seed=8)
    want, wc = jssm.mamba2_forward(jp, jx, jcfg, cache=cache)
    got, gc = ssm.mamba2_forward(p, x, cfg, cache=cache)
    _close(got, want)
    assert ssm.chunk_for(cfg, S) == {1: 1, 2: 2, 12: 12, 17: 1, 48: 16}[S]
    if cache is None:
        assert gc is None and wc is None
        return
    assert set(gc) == {"h", "conv"}
    assert tuple(gc["conv"].shape) == (2, cfg.ssm_conv - 1,
                                       ssm.conv_dim(cfg))
    for k in ("h", "conv"):
        _close(gc[k], wc[k], msg=k)
    if S < cfg.ssm_conv - 1:
        assert float(gc["conv"][:, :cfg.ssm_conv - 1 - S].abs().max()) == 0


@pytest.mark.parametrize("S", [12, 17])
def test_mamba2_forward_matches_the_reference_bf16(S):
    jcfg, cfg, jp, p = _mixer_pair(dtype="bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in tree_leaves(p))
    jx, x = _x(cfg, (2, S, cfg.d_model), seed=9, dtype="bfloat16")
    want, wc = jssm.mamba2_forward(jp, jx, jcfg, cache={})
    got, gc = ssm.mamba2_forward(p, x, cfg, cache={})
    assert got.dtype == torch.bfloat16 and gc["h"].dtype == torch.float32
    assert gc["conv"].dtype == torch.bfloat16
    assert _rel_l2(got, want) <= BF16_REL
    assert _rel_l2(gc["h"], wc["h"]) <= BF16_REL


def test_mamba2_decode_step_matches_the_references_from_one_cache():
    """One decode step from the same seeded cache in both packages: out,
    the new state and the shifted conv window; the caller's cache is not
    written."""
    jcfg, cfg, jp, p = _mixer_pair()
    rng = np.random.default_rng(10)
    H, P, N = ssm.n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    cache = {"h": rng.normal(size=(2, H, P, N)).astype(np.float32),
             "conv": rng.normal(size=(2, cfg.ssm_conv - 1,
                                      ssm.conv_dim(cfg))).astype(np.float32)}
    jx, x = _x(cfg, (2, 1, cfg.d_model), seed=11)
    want, wc = jssm.mamba2_decode_step(jp, jx, jcfg,
                                       jax.tree.map(jnp.asarray, cache))
    tc = tree_map(torch.as_tensor, cache)
    got, gc = ssm.mamba2_decode_step(p, x, cfg, tc)
    _close(got, want)
    for k in ("h", "conv"):
        _close(gc[k], wc[k], msg=k)
        np.testing.assert_array_equal(tc[k].numpy(), cache[k])


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_decode_steps_continue_the_full_forward(arch):
    """A prefill of S0 tokens hands its state to S - S0 decode steps: each
    step's output equals the full forward's at that position (the
    reference's own 2e-3), from S0 = 1 (the conv tail padded) and 5."""
    jcfg, cfg, jp, p = _mixer_pair(arch)
    S = 20
    _, x = _x(cfg, (2, S, cfg.d_model), seed=12)
    with torch.no_grad():
        full, _ = ssm.mamba2_forward(p, x, cfg)
        for s0 in (1, 5):
            out, cache = ssm.mamba2_forward(p, x[:, :s0], cfg, cache={})
            _close(out, full[:, :s0], 2e-3, 2e-3)
            for t in range(s0, S):
                y, cache = ssm.mamba2_decode_step(p, x[:, t:t + 1], cfg,
                                                  cache)
                _close(y, full[:, t:t + 1], 2e-3, 2e-3, msg=f"{s0} {t}")


def test_mamba2_forward_grads_match_the_references():
    jcfg, cfg, jp, p = _mixer_pair(seed=3)
    jx, x = _x(cfg, (2, 24, cfg.d_model), seed=13)

    def jloss(q, v):
        return jnp.mean(jnp.square(jssm.mamba2_forward(q, v, jcfg)[0]))

    wg, wxg = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    for t in tree_leaves(p):
        t.requires_grad_(True)
    x.requires_grad_(True)
    torch.mean(torch.square(ssm.mamba2_forward(p, x, cfg)[0])).backward()
    _close(x.grad, wxg)
    for (path, t), w in zip(_paths(p), jax.tree.leaves(wg)):
        _close(t.grad, w, msg=str(path))


def test_mamba_block_under_vmap_grad_matches_the_references_vmap():
    """Per-lane value and grads of the mamba block under
    ``torch.func.vmap(grad_and_value)``, as the cohort trainer runs a
    model, against the reference's ``vmap(value_and_grad)``: each lane's
    grad leaf at rtol 1e-4 and atol 1e-5 times the leaf's largest
    magnitude (the lane of params doubled, ``A_log`` among them, has grads
    up to 2.1, and the unbatched port strays 1.3e-5 of that from the
    reference there too)."""
    jcfg, cfg = _cfgs()
    jp = _ref_params(lambda f: jblk.init_mamba_block(f, jcfg), seed=4)
    p = _to_torch(jp)
    lanes = np.random.default_rng(14).normal(
        size=(3, 2, 10, cfg.d_model)).astype(np.float32)
    scale = np.array([1.0, 0.5, 2.0], np.float32)
    jlanes = jax.tree.map(lambda a: jnp.stack([a * s for s in scale]), jp)
    tlanes = tree_map(lambda a: torch.stack([a * float(s) for s in scale]), p)

    def jloss(q, x):
        return jnp.mean(jnp.square(jblk.mamba_block(q, x, jcfg)[0]))

    def tloss(q, x):
        return torch.mean(torch.square(blocks.mamba_block(q, x, cfg)[0]))

    wv, wg = jax.vmap(jax.value_and_grad(jloss))(jlanes, jnp.asarray(lanes))
    g, v = torch.func.vmap(torch.func.grad_and_value(tloss))(
        tlanes, torch.as_tensor(lanes))
    _close(v, wv)
    for (path, _), a, b in zip(_paths(p), tree_leaves(g),
                               jax.tree.leaves(wg)):
        for lane in range(3):
            scale = max(1.0, float(np.abs(np.asarray(b[lane])).max()))
            _close(a[lane], b[lane], RTOL, ATOL * scale, f"{path} {lane}")


# -- the blocks ------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["uncached", "prefill", "decode"])
def test_mamba_block_matches_the_reference(mode):
    jcfg, cfg = _cfgs()
    jp = _ref_params(lambda f: jblk.init_mamba_block(f, jcfg), seed=5)
    p = _to_torch(jp)
    pf = common.ParamFactory(torch.Generator().manual_seed(0))
    blocks.init_mamba_block(pf, cfg)
    assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]
    S = 1 if mode == "decode" else 9
    jx, x = _x(cfg, (2, S, cfg.d_model), seed=15)
    kw, jkw = {}, {}
    if mode == "prefill":
        kw, jkw = dict(cache={}), dict(cache={})
    elif mode == "decode":
        _, cache = ssm.mamba2_forward(p["mixer"], torch.as_tensor(
            np.random.default_rng(16).normal(size=(2, 6, cfg.d_model))
            .astype(np.float32)), cfg, cache={})
        kw = dict(cache=cache, decode=True)
        jkw = dict(cache=jax.tree.map(jnp.asarray, tree_map(
            lambda t: t.numpy(), cache)), decode=True)
    want, wc = jblk.mamba_block(jp, jx, jcfg, **jkw)
    got, gc = blocks.mamba_block(p, x, cfg, **kw)
    _close(got, want)
    if mode == "uncached":
        assert gc is None and wc is None
    else:
        for k in ("h", "conv"):
            _close(gc[k], wc[k], msg=k)


@pytest.mark.parametrize("mode", ["uncached", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba_shared_block_matches_the_reference(dtype, mode):
    """The shared block on (x, x0): concat, ``ln_in``, ``w_concat``, the
    dense decoder block with its GQA cache, ``x + (y - h)``; without a
    cache, prefilled into one at 0, and decoding one token at 6."""
    jcfg, cfg = _cfgs("zamba2-2.7b", dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = _ref_params(lambda f: jblk.init_zamba_shared(f, jcfg), jdt, seed=6)
    p = _to_torch(jp)
    pf = common.ParamFactory(torch.Generator().manual_seed(0))
    blocks.init_zamba_shared(pf, cfg)
    assert [(k, tuple(v.shape)) for k, v in _paths(pf.params)] == \
        [(k, tuple(v.shape)) for k, v in _paths(jp)]
    S, pos = (1, 6) if mode == "decode" else (7, 0)
    jx, x = _x(cfg, (2, S, cfg.d_model), seed=17, dtype=dtype)
    jx0, x0 = _x(cfg, (2, S, cfg.d_model), seed=18, dtype=dtype)
    positions = np.arange(S, dtype=np.int32) + pos
    kw, jkw = {}, {}
    if mode != "uncached":
        rng = np.random.default_rng(19)
        shape = (2, 10, cfg.n_kv_heads, cfg.hd())
        cache = {k: (rng.normal(size=shape) if mode == "decode"
                     else np.zeros(shape)).astype(np.float32)
                 for k in ("k", "v")}
        jkw = dict(cache={k: jnp.asarray(v, jdt) for k, v in cache.items()},
                   pos=jnp.int32(pos))
        kw = dict(cache={k: torch.as_tensor(v).to(getattr(torch, dtype))
                         for k, v in cache.items()}, pos=pos)
    want, wc = jblk.zamba_shared_block(jp, jx, jx0, jcfg,
                                       jnp.asarray(positions), **jkw)
    got, gc = blocks.zamba_shared_block(p, x, x0, cfg,
                                        torch.as_tensor(positions), **kw)
    if dtype == "float32":
        _close(got, want)
    else:
        assert got.dtype == torch.bfloat16
        assert _rel_l2(got, want) <= BF16_REL
    if mode == "uncached":
        assert gc is None and wc is None
        return
    for k in ("k", "v"):
        if dtype == "float32":
            _close(gc[k], wc[k], msg=k)
        else:
            assert _rel_l2(gc[k], wc[k]) <= BF16_REL
