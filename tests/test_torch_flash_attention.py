"""The port's attention forward against the reference's.

The plain ``flash_attention`` (what a CPU tensor takes) is held to the
reference's Pallas kernel in interpret mode and to its oracle
``repro.kernels.ref.flash_attention`` on the same numpy inputs, at the
reference's own tolerances (``tests/test_kernels.py``): 2e-4 in fp32, 3e-2
in bf16, and 1e-2 in fp16 (the reference's kernel rounds p to v's type;
one fp16 ulp is 2^-11 of a value). The CUDA kernels run only on a card:
``test_torch_cuda.py`` and ``chip_smoke.py`` hold them against the plain
version; here their arithmetic is emulated (tile order, and how each
rounds p or splits its operands)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

FP32_TOL, BF16_TOL, FP16_TOL = 2e-4, 3e-2, 1e-2


def _inputs(seed, b, h, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, t, d)).astype(np.float32),
            rng.standard_normal((b, h, t, d)).astype(np.float32))


def _both(arrays, dtype, jdtype, **kw):
    got = ops.flash_attention(*(torch.as_tensor(a).to(dtype) for a in arrays),
                              **kw)
    jargs = [jnp.asarray(a).astype(jdtype) for a in arrays]
    pallas = jops.flash_attention(*jargs, interpret=True, **kw)
    oracle = jref.flash_attention(*jargs, **{k: v for k, v in kw.items()
                                             if k in ("causal", "sm_scale")})
    return (got.float().numpy(), np.asarray(pallas, np.float32),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("s, t, causal", [
    (128, 128, True), (128, 128, False), (256, 128, True), (256, 128, False),
    (128, 256, True), (128, 256, False)])
def test_fp32_matches_the_reference(s, t, causal):
    arrays = _inputs(s + t + causal, 1, 2, s, t, 64)
    got, pallas, oracle = _both(arrays, torch.float32, jnp.float32,
                                causal=causal)
    assert got.shape == (1, 2, s, 64)
    np.testing.assert_allclose(got, pallas, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, oracle, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("b, h, s, d", [(1, 1, 128, 64), (1, 2, 256, 128)])
def test_bf16_matches_the_reference(b, h, s, d):
    arrays = _inputs(s + d, b, h, s, s, d)
    got, pallas, oracle = _both(arrays, torch.bfloat16, jnp.bfloat16,
                                causal=True)
    np.testing.assert_allclose(got, pallas, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got, oracle, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("s, causal", [(256, True), (128, False)])
def test_fp16_matches_the_reference(s, causal):
    """fp16 in, fp16 out: the CPU route computes in fp32 as the card's
    fp16 kernel does; the reference's kernel rounds p to fp16."""
    arrays = _inputs(s + 16, 1, 2, s, s, 64)
    got, pallas, oracle = _both(arrays, torch.float16, jnp.float16,
                                causal=causal)
    assert got.shape == (1, 2, s, 64)
    np.testing.assert_allclose(got, pallas, rtol=FP16_TOL, atol=FP16_TOL)
    np.testing.assert_allclose(got, oracle, rtol=FP16_TOL, atol=FP16_TOL)


@pytest.mark.parametrize("d, causal", [(16, True), (80, False), (96, True)])
def test_padded_head_dim_is_the_unpadded_attention(d, causal):
    """The card kernels run D <= 128 at 64 or 128: zero columns appended
    to q, k and v leave q k^T unchanged and give zero output columns, so
    the plain version of the padded inputs, at sm_scale D^-0.5 and cut to
    D columns, is the unpadded plain version and the reference's."""
    arrays = _inputs(d, 1, 2, 256, 256, d)
    q, k, v = (torch.as_tensor(a) for a in arrays)
    kd = fa.kernel_head_dim(d)
    assert kd == (64 if d <= 64 else 128)
    padded = ref.flash_attention(*(fa.pad_head_dim(t, kd) for t in (q, k, v)),
                                 causal=causal, sm_scale=d ** -0.5)
    assert padded.shape == (1, 2, 256, kd)
    assert bool((padded[..., d:] == 0).all())
    got = padded[..., :d]
    torch.testing.assert_close(got, ref.flash_attention(q, k, v,
                                                        causal=causal),
                               rtol=1e-6, atol=1e-6)
    jargs = [jnp.asarray(a) for a in arrays]
    pallas = jops.flash_attention(*jargs, causal=causal, interpret=True)
    oracle = jref.flash_attention(*jargs, causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP32_TOL, atol=FP32_TOL)


def test_head_dims_past_128_are_not_taken():
    assert [fa.kernel_head_dim(d) for d in (1, 64, 65, 128)] == \
        [64, 64, 128, 128]
    with pytest.raises(NotImplementedError, match="128"):
        fa.kernel_head_dim(192)


def test_qwen3_head_dim_causal_fp32():
    """H=2, S=256, D=128: qwen3-1.7b's head dim, two 128-query blocks."""
    arrays = _inputs(7, 1, 2, 256, 256, 128)
    got, pallas, oracle = _both(arrays, torch.float32, jnp.float32,
                                causal=True)
    np.testing.assert_allclose(got, pallas, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, oracle, rtol=FP32_TOL, atol=FP32_TOL)


def test_explicit_scale_and_small_blocks():
    arrays = _inputs(11, 2, 1, 64, 96, 64)
    got, pallas, oracle = _both(arrays, torch.float32, jnp.float32,
                                causal=True, sm_scale=0.3, block_q=32,
                                block_k=32)
    np.testing.assert_allclose(got, pallas, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, oracle, rtol=FP32_TOL, atol=FP32_TOL)


def test_causal_rows_see_only_their_prefix():
    """The property chip_smoke's 32k check rests on: the first rows of a
    longer causal run are the run on their prefix."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(5, 1, 2, 256, 256, 64))
    full = ops.flash_attention(q, k, v)
    prefix = ops.flash_attention(q[:, :, :128].contiguous(),
                                 k[:, :, :128].contiguous(),
                                 v[:, :, :128].contiguous())
    torch.testing.assert_close(full[:, :, :128], prefix, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s, t", [(130, 128), (128, 200)])
def test_ragged_lengths_raise(s, t):
    q, k, v = (torch.as_tensor(a) for a in _inputs(0, 1, 1, s, t, 64))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)


def test_malformed_shapes_raise():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 2, 128, 32),
                            torch.zeros(1, 2, 128, 32))
    with pytest.raises(ValueError):   # grouped k/v heads are the caller's
        ops.flash_attention(q, torch.zeros(1, 1, 128, 64),
                            torch.zeros(1, 1, 128, 64))


def test_attention_wrapper_takes_no_plain_fallback_off_the_cpu(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(ref, "flash_attention", forbidden)
    from repro_torch.kernels import _build
    seen = []
    monkeypatch.setattr(_build, "LISTENERS", [lambda *a: seen.append(a)])
    before = fa.flash_attention.launches
    t = torch.zeros(1, 2, 128, 64, device="meta")
    # a meta tensor (it raised here until the launch slice) takes the
    # shape-only path: nothing launched, its traffic reported
    out = fa.flash_attention(t, t, t)
    assert out.is_meta and out.shape == t.shape
    assert seen == [("flash_attention", 3 * t.numel() * 4, t.numel() * 4)]
    assert fa.flash_attention.launches == before


def _kernel_tile_order(q, k, v, causal=True, block=128, p_rounding="split"):
    """The bf16 CUDA kernel's arithmetic, plainly: 128-query x 128-key
    tiles, fp32 scores (q k^T) * sm_scale, the -2^30 causal mask, an online
    softmax with fp32 m, l and accumulator; l sums the fp32 p. p v takes p
    as the kernel's register operands do: ``"split"`` (the kernel) as
    bf16 p_hi plus bf16(p - p_hi), two products; ``"bf16"`` as one bf16
    p."""
    B, H, S, D = q.shape
    T = k.shape[2]
    scale = D ** -0.5
    out = torch.empty(B, H, S, D, dtype=torch.float32)
    for q0 in range(0, S, block):
        qt = q[:, :, q0:q0 + block].float()
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        m = torch.full(qt.shape[:3], ref.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(*qt.shape[:3], D)
        last = T if not causal else min(T, q0 + qt.shape[2])
        for k0 in range(0, last, block):
            s = torch.einsum("bhsd,bhtd->bhst", qt,
                             k[:, :, k0:k0 + block].float()) * scale
            if causal:
                keys = torch.arange(k0, k0 + s.shape[3])[None]
                s = torch.where(keys <= rows, s, ref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            vt = v[:, :, k0:k0 + block].float()
            pv = torch.einsum("bhst,bhtd->bhsd", hi, vt)
            if p_rounding == "split":
                lo = (p - hi).to(torch.bfloat16).float()
                pv = pv + torch.einsum("bhst,bhtd->bhsd", lo, vt)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, q0:q0 + block] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_split_p_stays_within_the_per_block_check():
    """The bf16 kernel's tile order and p rounding (hi + lo), emulated at
    [1, 2, 4096, 128], stay within chip_smoke's per-block check (tol 1e-2 x
    (the 128-row block's rms + |value|)) of the plain version, which the
    card run is held to."""
    cs = _chip_smoke()
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in _inputs(3, 1, 2, 4096, 4096, 128))
    got = _kernel_tile_order(q, k, v)
    want = ref.flash_attention(q, k, v)
    checked = cs.attention_check("split p emulation", got, want)
    assert checked["tol_ratio"] <= 1.0 and checked["max_abs_err"] > 0.0


def test_p_rounded_once_to_bf16_can_exceed_the_check():
    """Why the kernel splits p: rounded once to bf16 (the reference keeps
    p fp32), p's error in a few-key row whose v terms cancel exceeds the
    per-block check on these inputs (rows 0..127), where the split stays
    well inside it."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 16, 512, 128, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    want = ref.flash_attention(q, k, v)
    with pytest.raises(AssertionError, match="x the tolerance"):
        cs.attention_check("bf16 p", _kernel_tile_order(q, k, v,
                                                        p_rounding="bf16"),
                           want)
    split = cs.attention_check("split p", _kernel_tile_order(q, k, v), want)
    assert split["tol_ratio"] < 0.6


def test_kernel_tile_order_emulation_matches_the_reference():
    """The emulation itself, at a ragged S != T in both masks, against the
    reference's oracle at its bf16 tolerance."""
    for s, t, causal in ((384, 256, True), (256, 384, False)):
        arrays = _inputs(s + t, 1, 2, s, t, 64)
        got = _kernel_tile_order(*(torch.as_tensor(a).to(torch.bfloat16)
                                   for a in arrays), causal=causal)
        oracle = jref.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                        for a in arrays), causal=causal)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(oracle, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def _tf32(x):
    """x with its low 13 mantissa bits cleared: the kernel's TF32 operand."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _tf32_product(a, b, products=3):
    """a @ b as the fp32 kernel forms it from TF32 parts hi = tf32(x) and
    lo = tf32(x - hi): a_lo b_hi + a_hi b_lo + a_hi b_hi (three products),
    or a_hi b_hi alone (one), each summed in fp32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if products == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _tf32_kernel_tile_order(q, k, v, causal=True, products=3):
    """The fp32 CUDA kernel's arithmetic, plainly: 128-query x 64-key
    tiles, q scaled by the fp32 sm_scale first, scores and p v as TF32
    products (``_tf32_product``), the -2^30 causal mask, an online softmax
    with fp32 m, l and accumulator, the causal loop stopping at the tile
    of the 128-query tile's last row."""
    B, H, S, D = q.shape
    T = k.shape[2]
    qs = q.float() * float(np.float32(D ** -0.5))
    out = torch.empty(B, H, S, D, dtype=torch.float32)
    for q0 in range(0, S, 128):
        qt = qs[:, :, q0:q0 + 128]
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        m = torch.full(qt.shape[:3], ref.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(*qt.shape[:3], D)
        nkb = -(-T // 64)
        if causal:
            nkb = min(nkb, (q0 + qt.shape[2] - 1) // 64 + 1)
        for k0 in range(0, 64 * nkb, 64):
            kt = k[:, :, k0:k0 + 64].float()
            s = _tf32_product(qt, kt.transpose(-1, -2), products)
            if causal:
                keys = torch.arange(k0, k0 + s.shape[3])[None]
                s = torch.where(keys <= rows, s, ref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _tf32_product(
                p, v[:, :, k0:k0 + 64].float(), products)
            m = m_new
        out[:, :, q0:q0 + 128] = acc / l.clamp_min(1e-30)[..., None]
    return out


def test_tf32_split_stays_within_the_fp32_per_block_check():
    """The fp32 kernel's tile order and TF32 hi + lo split, emulated at
    [1, 2, 4096, 128], stay within a tenth of chip_smoke's per-block check
    (tol 2e-4 x (the 128-row block's rms + |value|)) of the plain
    version: the split itself leaves the check a wide margin."""
    cs = _chip_smoke()
    q, k, v = (torch.as_tensor(a) for a in _inputs(3, 1, 2, 4096, 4096, 128))
    got = _tf32_kernel_tile_order(q, k, v)
    checked = cs.attention_check("3xtf32 emulation", got,
                                 ref.flash_attention(q, k, v))
    assert checked["tol_ratio"] < 0.1 and checked["max_abs_err"] > 0.0


def test_one_tf32_product_exceeds_the_fp32_check():
    """Why the kernel takes three products: TF32 operands alone (10
    mantissa bits) put scores and p v outside the fp32 check on these
    inputs, where three products stay well inside it."""
    cs = _chip_smoke()
    q, k, v = (torch.as_tensor(a) for a in _inputs(4, 1, 4, 1024, 1024, 128))
    want = ref.flash_attention(q, k, v)
    with pytest.raises(AssertionError, match="x the tolerance"):
        cs.attention_check("1xtf32", _tf32_kernel_tile_order(
            q, k, v, products=1), want)
    three = cs.attention_check("3xtf32", _tf32_kernel_tile_order(q, k, v),
                               want)
    assert three["tol_ratio"] < 0.2


@pytest.mark.parametrize("s, t, causal", [(192, 160, True), (384, 256, True),
                                          (160, 288, False)])
def test_tf32_emulation_matches_the_reference(s, t, causal):
    """The fp32 emulation at a ragged S != T (a 64-row q tile, a 32-key
    kv tile) in both masks, against the reference's oracle at its fp32
    tolerance."""
    arrays = _inputs(s * t, 1, 2, s, t, 64)
    got = _tf32_kernel_tile_order(*(torch.as_tensor(a) for a in arrays),
                                  causal=causal)
    oracle = jref.flash_attention(*(jnp.asarray(a) for a in arrays),
                                  causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=FP32_TOL, atol=FP32_TOL)

