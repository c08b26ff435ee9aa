"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip on a host without a card.
The file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6, the reference's kernel self-check
tolerance, unless a case states why it needs more; ``block_topk`` is
held to exact equality of values and indices."""
import pytest
import torch

from repro_torch.kernels import fused_adam as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import staleness_agg as sa
from repro_torch.kernels import topk

RTOL, ATOL = 1e-5, 1e-6
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py covers the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c, k, n", [(16, None, 4096), (208, 32, 582656)])
def test_staleness_agg_kernel_matches_plain(card, c, k, n):
    gen = torch.Generator(device=card).manual_seed(0)
    buf = torch.randn(c, n, device=card, generator=gen)
    if k is None:
        w, rows = torch.rand(c, device=card, generator=gen), None
    else:
        w = torch.rand(k, device=card, generator=gen)
        rows = torch.randperm(c, device=card, generator=gen)[:k]
    before = sa.staleness_agg.launches
    got = sa.staleness_agg(buf, w, rows=rows)
    torch.cuda.synchronize()
    assert sa.staleness_agg.launches == before + 1
    want = ref.staleness_agg(buf, w, rows=rows)
    # sums of up to c unit-normal terms in another order: the absolute
    # error of an fp32 sum near zero grows with the number of terms
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL * c)


@pytest.mark.cuda
def test_fused_adam_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(0)
    kp, w = 8, 16384
    p, g = (torch.randn(kp, w, device=card, generator=gen) for _ in range(2))
    m = torch.randn(kp, w, device=card, generator=gen) * 0.1
    v = torch.rand(kp, w, device=card, generator=gen) * 0.01
    steps = torch.tensor([3, 0, 1, 3, 2, 0, 3, 1], dtype=torch.int32,
                         device=card)
    want = [t.clone() for t in (p, m, v)]
    ref.fused_adam(*want, g, steps, 1, lr=LR, b1=B1, b2=B2, eps=EPS)
    before = fa.fused_adam.launches
    fa.fused_adam(p, m, v, g, steps, 1, lr=LR)
    torch.cuda.synchronize()
    assert fa.fused_adam.launches == before + 1
    for got, exp in zip((p, m, v), want):
        torch.testing.assert_close(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, block", [(256, 100, 1024), (3000, 17, 1024),
                                         (64, 5, 32), (1 << 20, 100, 1024)])
def test_block_topk_kernel_equals_plain(card, m, k, block):
    gen = torch.Generator(device=card).manual_seed(m + k)
    s = torch.randn(m, device=card, generator=gen)
    s[torch.rand(m, device=card, generator=gen) < 0.5] = float("-inf")
    s[torch.randperm(m, device=card, generator=gen)[:64]] = 2.5   # ties
    s[: min(m, block) // 2] = float("-inf")   # a block short of finite scores
    s[-1] = float("nan")
    s[0] = -0.0
    before = topk.block_topk.launches
    vals, idx = topk.block_topk(s, k, block)
    torch.cuda.synchronize()
    assert topk.block_topk.launches == before + 1
    want_v, want_i = ref.block_topk(s, k, block)
    assert torch.equal(idx, want_i)
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    # the whole selection: kernel passes until one block remains
    got_v, got_i = ops.masked_topk(s, k, block=block)
    exp_v, exp_i = ref.masked_topk(s, k)
    assert torch.equal(got_i, exp_i)
    assert torch.equal(got_v.view(torch.int32), exp_v.view(torch.int32))
