"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip on a host without a card.
The file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6, the reference's kernel self-check
tolerance, unless a case states why it needs more."""
import pytest
import torch

from repro_torch.kernels import fused_adam as fa
from repro_torch.kernels import ref
from repro_torch.kernels import staleness_agg as sa

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
