"""The port's attention forward against the reference's.

The plain ``flash_attention`` (what a CPU tensor takes) is held to the
reference's Pallas kernel in interpret mode and to its oracle
``repro.kernels.ref.flash_attention`` on the same numpy inputs, at the
reference's own tolerances (``tests/test_kernels.py``): 2e-4 in fp32, 3e-2
in bf16. The CUDA kernel runs only on a card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain version."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

FP32_TOL, BF16_TOL = 2e-4, 3e-2


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
    before = fa.flash_attention.launches
    t = torch.zeros(1, 2, 128, 64, device="meta")
    with pytest.raises((RuntimeError, TypeError, ValueError,
                        NotImplementedError)):
        fa.flash_attention(t, t, t)
    assert fa.flash_attention.launches == before
