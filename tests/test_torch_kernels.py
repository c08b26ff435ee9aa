"""The port's kernels against the reference's.

The plain torch versions (what a CPU tensor takes) are held against
``repro.kernels.ref`` and against the reference's Pallas kernels run with
``interpret=True``, at rtol 1e-5 / atol 1e-6 (the reference's own
kernel-vs-XLA self-check tolerance). The CUDA kernels run only on a card:
``test_torch_cuda.py`` and ``chip_smoke.py`` hold them against the plain
versions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.fused_adam import BLOCK as JAX_ADAM_BLOCK
from repro.kernels.fused_adam import fused_adam as pallas_fused_adam
from repro.kernels.staleness_agg import BLOCK_N as JAX_AGG_BLOCK
from repro.kernels.staleness_agg import staleness_agg as pallas_staleness_agg
from repro_torch.kernels import fused_adam as fa
from repro_torch.kernels import ref
from repro_torch.kernels import staleness_agg as sa

RTOL, ATOL = 1e-5, 1e-6
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _pad_cols(a: np.ndarray, block: int) -> np.ndarray:
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, (-a.shape[-1]) % block)])


# ------------------------------------------------------------ staleness_agg
@pytest.mark.parametrize("k, n", [(1, 4), (3, 1500), (8, 1024), (13, 2100),
                                  (30, 4096)])
def test_staleness_agg_plain_matches_reference(k, n):
    rng = np.random.default_rng(k * 7 + n)
    u = rng.normal(size=(k, n)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    w[rng.random(k) < 0.3] = 0.0                 # free rows at weight 0
    got = sa.staleness_agg(torch.as_tensor(u), torch.as_tensor(w)).numpy()
    want_ref = np.asarray(jref.staleness_agg(jnp.asarray(u), jnp.asarray(w)))
    # the Pallas kernel takes N % 1024 == 0: pad with zero columns, trim
    want_pallas = np.asarray(pallas_staleness_agg(
        jnp.asarray(_pad_cols(u, JAX_AGG_BLOCK)), jnp.asarray(w),
        interpret=True))[:n]
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c, k", [(16, 3), (40, 8), (24, 11)])
def test_staleness_agg_rows_form_matches_reference(c, k):
    """With row ids the wrapper reduces only the referenced rows (repeats
    allowed), as the reference's gather-and-einsum does."""
    rng = np.random.default_rng(c + k)
    buf = rng.normal(size=(c, 2048)).astype(np.float32)
    rows = rng.integers(0, c, size=k)
    w = rng.random(k).astype(np.float32)
    got = sa.staleness_agg(torch.as_tensor(buf), torch.as_tensor(w),
                           rows=torch.as_tensor(rows)).numpy()
    want = np.asarray(jref.staleness_agg(jnp.asarray(buf[rows]),
                                         jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_staleness_agg_rejects_malformed_input():
    u = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        sa.staleness_agg(u, torch.zeros(3))
    with pytest.raises(ValueError):
        sa.staleness_agg(u, torch.zeros(2), rows=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        sa.staleness_agg(u.reshape(-1), torch.zeros(4))


@pytest.mark.parametrize("n", [4, 4096, 582_656, 582_660])
def test_staleness_agg_plan_covers_every_column_once_in_balanced_pieces(n):
    """The kernel's column split (mirrored by ``plan``) on a card of 132
    SMs: every column in exactly one piece, in order; every piece starts on
    a 128-byte boundary of the row (so a 16-byte one), is a whole number of
    16-byte float4s and at most ``PIECE_COLS`` wide; each CTA takes the
    fewest pieces its columns need, and its bytes are within one piece of
    the mean: within one 128-byte unit, plus the last CTA's float4s past
    the last whole unit."""
    sms = 132
    split = sa.plan(n, sms)
    assert len(split) == max(1, min(sms, n // 32))
    pos = 0
    for a, b in (piece for cta in split for piece in cta):
        assert a == pos and b > a
        assert (4 * a) % 128 == 0 and (4 * (b - a)) % 16 == 0
        assert b - a <= sa.PIECE_COLS
        pos = b
    assert pos == n
    cols = [sum(b - a for a, b in cta) for cta in split]
    assert [len(cta) for cta in split] == [-(-c // sa.PIECE_COLS)
                                           for c in cols]
    mean = 4 * n / len(split)
    for cta, c in zip(split, cols):
        assert abs(4 * c - mean) <= min(4 * (b - a) for a, b in cta)
        assert abs(4 * c - mean) < 128 + 4 * (n % 32)


# ---------------------------------------------------------------- fused_adam
def _adam_state(rng, kp, w):
    p = rng.normal(size=(kp, w)).astype(np.float32)
    m = (rng.normal(size=(kp, w)) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=(kp, w))) * 0.01).astype(np.float32)
    return p, m, v


@pytest.mark.parametrize("w", [8, 1000, 8192])
def test_fused_adam_plain_matches_reference_over_five_steps(w):
    """Lanes run out of steps at different times (masked lanes keep their
    state); t = 1..5 on every active lane."""
    rng = np.random.default_rng(w)
    steps = np.array([5, 2, 0, 4], np.int32)
    p, m, v = _adam_state(rng, len(steps), w)
    tp, tm, tv = (torch.as_tensor(a.copy()) for a in (p, m, v))
    for s in range(5):
        g = rng.normal(size=p.shape).astype(np.float32)
        fa.fused_adam(tp, tm, tv, torch.as_tensor(g), torch.as_tensor(steps),
                      s, lr=LR, b1=B1, b2=B2, eps=EPS)
        for lane in np.flatnonzero(steps > s):
            lane_in = [a[lane].copy() for a in (p, m, v, g)]
            want = [np.array(x) for x in jref.fused_adam(
                *map(jnp.asarray, lane_in), lr=LR, b1=B1, b2=B2, eps=EPS,
                t=s + 1)]
            # the Pallas kernel takes N % 8192 == 0: pad with zeros, trim
            pallas = pallas_fused_adam(
                *(jnp.asarray(_pad_cols(a, JAX_ADAM_BLOCK)) for a in lane_in),
                jnp.int32(s + 1), lr=LR, b1=B1, b2=B2, eps=EPS, interpret=True)
            for got, exp in zip(pallas, want):
                np.testing.assert_allclose(np.asarray(got)[:w], exp,
                                           rtol=RTOL, atol=ATOL)
            p[lane], m[lane], v[lane] = want
        for got, want in zip((tp, tm, tv), (p, m, v)):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # a lane with 0 steps was never touched
    p0, m0, v0 = _adam_state(np.random.default_rng(w), len(steps), w)
    assert np.array_equal(tp[2].numpy(), p0[2])
    assert np.array_equal(tv[2].numpy(), v0[2])


def test_fused_adam_bias_corrections_in_fp32():
    for t in (1, 2, 5, 100):
        bc1, bc2 = ref.bias_corrections(t, B1, B2)
        tf = np.float32(t)
        assert bc1 == float(np.float32(1) / (np.float32(1) - np.float32(B1) ** tf))
        assert bc2 == float(np.float32(1) / (np.float32(1) - np.float32(B2) ** tf))


def test_fused_adam_rejects_malformed_input():
    p = torch.zeros(2, 8)
    ok = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.fused_adam(p, p.clone(), p.clone(), torch.zeros(2, 4), ok, 0, lr=LR)
    with pytest.raises(ValueError):
        fa.fused_adam(p, p.clone(), p.clone(), p.clone(),
                      torch.ones(2, dtype=torch.int64), 0, lr=LR)


# ------------------------------------------ a non-CPU tensor never goes plain
def test_wrappers_take_no_plain_fallback_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain versions are never reached (no flag, no try/except fallback)."""
    def forbidden(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(ref, "staleness_agg", forbidden)
    monkeypatch.setattr(ref, "fused_adam", forbidden)
    before = (sa.staleness_agg.launches, fa.fused_adam.launches)
    u = torch.zeros(8, 16, device="meta")
    with pytest.raises((RuntimeError, TypeError, ValueError,
                        NotImplementedError)):
        sa.staleness_agg(u, torch.zeros(8, device="meta"))
    p = torch.zeros(2, 16, device="meta")
    with pytest.raises((RuntimeError, TypeError, ValueError,
                        NotImplementedError)):
        fa.fused_adam(p, p, p, p, torch.ones(2, dtype=torch.int32,
                                             device="meta"), 0, lr=LR)
    assert (sa.staleness_agg.launches, fa.fused_adam.launches) == before
