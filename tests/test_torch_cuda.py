"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip on a host without a card.
The file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6, the reference's kernel self-check
tolerance, unless a case states why it needs more; the top-k kernels
(values, indices, valid flags and the new booster), their sort route for
k > 1024, the int8 codes and scales of ``quantize_q8`` and every output
of the fused ``compress_q8`` are held to exact equality,
``flash_attention`` block by block of 128 query rows to |got - want| <=
tol * (the block's rms + |want|), tol 2e-4 for fp32 and 1e-2 for bf16
and fp16 (one bf16 ulp is at most 2^-7 of a value, one fp16 ulp 2^-10):
an attention row's values shrink with the keys it sees, so the limit
follows them.

The profile cases run ``build_engine(...).run()`` on the card against the
same run on the CPU, with torch's TF32 flags as they are (the trainer and
the evaluation hold fp32 in ``device.fp32_exact``), under a fault profile
of every kind, an open-loop traffic profile and the oracle planes (blob
updates, host data): identical chaos trace and counters, params within
rtol 1e-4 / atol 1e-5, the flags unchanged after the run.

The engine cases run the fused-round megastep against the stepwise engine
on the card under ``torch.use_deterministic_algorithms(True)``, bit for
bit, and a SCAFFOLD run on the card against the same run on the CPU
(identical host trace, params within rtol 1e-4 / atol 1e-5, ``c_global``
within rtol 1e-4 / atol 1e-5 / lr: a variate divides a params difference
by steps * lr), on one shared table of minibatch indices."""
import os

# deterministic algorithms need a fixed cuBLAS workspace, set before the
# first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.scheduler import Scheduler  # noqa: E402
from repro_torch.core.services import FLConfig  # noqa: E402
from repro_torch.data.synthetic import make_federated_dataset  # noqa: E402
from repro_torch.faas.hardware import HardwareProfile, paper_fleet  # noqa: E402
from repro_torch.kernels import flash_attention as attn  # noqa: E402
from repro_torch.kernels import fused_adam as fa  # noqa: E402
from repro_torch.kernels import ops, quant8  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import staleness_agg as sa  # noqa: E402
from repro_torch.kernels import topk  # noqa: E402
from repro_torch.models.proxy_models import ProxyCNN  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py covers the kernels")
    return torch.device("cuda")


def _agg_inputs(card, c, k, n, pad=0, seed=0):
    """Seeded [c, n] rows and weights: the sweep form (k None: one weight a
    row) or the rows form (k row ids, drawn with repeats when k > c), with
    ``pad`` zero-weight repeats of the first row id, as ops._pad_rows."""
    gen = torch.Generator(device=card).manual_seed(seed)
    buf = torch.randn(c, n, device=card, generator=gen)
    if k is None:
        return buf, torch.rand(c, device=card, generator=gen), None
    w = torch.rand(k, device=card, generator=gen)
    rows = (torch.randperm(c, device=card, generator=gen)[:k] if k <= c else
            torch.randint(0, c, (k,), device=card, generator=gen))
    rows = torch.cat([rows, rows[:1].repeat(pad)])
    w = torch.cat([w, torch.zeros(pad, device=card)])
    return buf, w, rows


@pytest.mark.cuda
@pytest.mark.parametrize("c, k, n, pad", [
    (16, None, 4096, 0), (208, 32, 582656, 0),
    (1, None, 4096, 0), (208, 1, 582656, 0),          # K = 1
    (1100, None, 4096, 0), (208, 1100, 8192, 0),      # K past 1,024
    (8, None, 582660, 0), (208, 30, 582660, 0),       # N / 4 odd
    (208, 30, 582656, 2),     # the main path's rows form: 30 padded to 32
])
def test_staleness_agg_kernel_matches_plain(card, c, k, n, pad):
    buf, w, rows = _agg_inputs(card, c, k, n, pad)
    before = sa.staleness_agg.launches
    got = sa.staleness_agg(buf, w, rows=rows)
    torch.cuda.synchronize()
    assert sa.staleness_agg.launches == before + 1
    want = ref.staleness_agg(buf, w, rows=rows)
    # sums of up to max(c, K) unit-normal terms in another order: the
    # absolute error of an fp32 sum near zero grows with the number of terms
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=ATOL * max(c, w.shape[0]))


@pytest.mark.cuda
def test_staleness_agg_nan_in_a_zero_weight_row(card):
    """A NaN in a row of weight 0 reaches the sweep form's output (0 * NaN
    = NaN: what the aggregation's finiteness guard relies on to catch
    garbage in freed rows) and, when that row is not referenced, not the
    rows form's."""
    buf, w, _ = _agg_inputs(card, 16, None, 4096)
    buf[5, 100] = float("nan")
    w[5] = 0.0
    sweep = sa.staleness_agg(buf, w)
    rows = torch.tensor([0, 1, 2, 3, 0], device=card)
    picked = sa.staleness_agg(buf, w[:5].clone(), rows=rows)
    torch.cuda.synchronize()
    assert torch.isnan(sweep[100])
    assert int(torch.isnan(sweep).sum()) == 1
    assert bool(torch.isfinite(picked).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c, k, pad", [(208, None, 0), (208, 30, 2)])
def test_staleness_agg_two_calls_are_bitwise_equal(card, c, k, pad):
    """No atomics, no split of K: each column's sum has one order, so
    two calls on the same inputs agree to the bit."""
    buf, w, rows = _agg_inputs(card, c, k, 582656, pad)
    first = sa.staleness_agg(buf, w, rows=rows)
    second = sa.staleness_agg(buf, w, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


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
    # the whole selection: one launch
    got_v, got_i = ops.masked_topk(s, k)
    exp_v, exp_i = ref.masked_topk(s, k)
    assert torch.equal(got_i, exp_i)
    assert torch.equal(got_v.view(torch.int32), exp_v.view(torch.int32))


TOPK_M = [1, 256, 3000, (1 << 20) + 7]
TOPK_K = [1, 100, 600, 1024]
TOPK_CASES = [(m, k) for m in TOPK_M for k in TOPK_K if k <= m]
TOPK_KINDS = ["all_neg_inf", "all_equal", "few_finite", "special", "fleet"]


def _topk_scores(kind, m, k, card):
    """Scores of one kind: all -inf; all equal; fewer finite than k (k // 2
    finite, 0 for k = 1); NaN, -NaN, +-inf, +-0 planted among normals; the
    fleet mix (about half -inf, a few +inf, planted ties)."""
    gen = torch.Generator(device=card).manual_seed(m + k)
    if kind == "all_neg_inf":
        return torch.full((m,), float("-inf"), device=card)
    if kind == "all_equal":
        return torch.full((m,), 0.5, device=card)
    if kind == "few_finite":
        s = torch.full((m,), float("-inf"), device=card)
        s[torch.randperm(m, device=card, generator=gen)[:k // 2]] = 1.0
        return s
    s = torch.randn(m, device=card, generator=gen)
    if kind == "special":
        pick = torch.randperm(m, device=card, generator=gen)
        n = max(m // 12, 1)
        nan = torch.tensor(float("nan"), device=card)
        for j, v in enumerate((nan, -nan, float("inf"), float("-inf"), 0.0,
                               -0.0)):
            s[pick[j * n:(j + 1) * n]] = v
        return s
    s = s.abs() * 50.0
    s[torch.rand(m, device=card, generator=gen) < 0.5] = float("-inf")
    s[torch.randperm(m, device=card, generator=gen)[:8]] = float("inf")
    s[torch.randperm(m, device=card, generator=gen)[:64]] = 2.5
    return s


def _score_state(kind, m, k, card):
    """(num, den, booster, eligible, ever) of one kind, the same kinds as
    ``_topk_scores``: every slot ineligible; every score equal; fewer
    eligible than k; NaN num, NaN den, den = 0, num -0 and +-inf planted;
    the fleet mix (60 % eligible, 90 % ever invoked)."""
    gen = torch.Generator(device=card).manual_seed(3 * m + k)
    num = torch.rand(m, device=card, generator=gen) * 5
    den = torch.rand(m, device=card, generator=gen)
    booster = 1.0 + torch.rand(m, device=card, generator=gen)
    eligible = torch.rand(m, device=card, generator=gen) < 0.6
    ever = torch.rand(m, device=card, generator=gen) < 0.9
    if kind == "all_neg_inf":
        eligible[:] = False
    elif kind == "all_equal":
        num[:], den[:], booster[:] = 1.0, 1.0, 1.0
        eligible[:], ever[:] = True, True
    elif kind == "few_finite":
        eligible[:] = False
        eligible[torch.randperm(m, device=card, generator=gen)[:k // 2]] = \
            True
    elif kind == "special":
        pick = torch.randperm(m, device=card, generator=gen)
        n = max(m // 12, 1)
        num[pick[:n]] = float("nan")
        den[pick[n:2 * n]] = float("nan")
        den[pick[2 * n:3 * n]] = 0.0
        num[pick[3 * n:4 * n]] = -0.0
        num[pick[4 * n:5 * n]] = float("inf")
        num[pick[5 * n:6 * n]] = float("-inf")
    return num, den, booster, eligible, ever


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TOPK_KINDS)
@pytest.mark.parametrize("m, k", TOPK_CASES)
def test_masked_topk_is_one_launch_equal_to_plain(card, m, k, kind):
    s = _topk_scores(kind, m, k, card)
    before = topk.block_topk.launches
    vals, idx = ops.masked_topk(s, k)
    torch.cuda.synchronize()
    assert topk.block_topk.launches == before + 1
    want_v, want_i = ref.masked_topk(s, k)
    assert torch.equal(idx, want_i)
    assert torch.equal(_bits(vals), _bits(want_v))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TOPK_KINDS)
@pytest.mark.parametrize("m, k", TOPK_CASES)
def test_scored_topk_is_one_launch_equal_to_plain(card, m, k, kind):
    state = _score_state(kind, m, k, card)
    before = topk.block_topk.launches
    idx, valid, boost = ops.scored_topk(*state, 1.2, k)
    torch.cuda.synchronize()
    assert topk.block_topk.launches == before + 1
    want_i, want_v, want_b = ref.scored_topk(*state, 1.2, k)
    assert torch.equal(idx, want_i)
    assert torch.equal(valid, want_v)
    assert torch.equal(_bits(boost), _bits(want_b))


@pytest.mark.cuda
@pytest.mark.parametrize("m, k", [(256, 100), ((1 << 20) + 7, 100),
                                  (3000, 1024)])
def test_topk_ticket_resets_between_calls_and_graph_replays(card, m, k):
    """Two calls back to back, and a CUDA graph of each call replayed
    twice, give the eager results: the merge's ticket is back at 0 after
    every launch (the graph holds the kernel alone: the capture stream's
    ticket is made by an eager call before the capture)."""
    s = _topk_scores("fleet", m, k, card)
    state = _score_state("fleet", m, k, card)
    want = ops.masked_topk(s, k) + ops.scored_topk(*state, 1.2, k)
    again = ops.masked_topk(s, k) + ops.scored_topk(*state, 1.2, k)
    for a, b in zip(again, want):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.masked_topk(s, k), ops.scored_topk(*state, 1.2, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = topk.block_topk.launches
    with torch.cuda.graph(graph, stream=side):
        got = ops.masked_topk(s, k) + ops.scored_topk(*state, 1.2, k)
    assert topk.block_topk.launches == before + 2
    for _ in range(2):
        for t in got:
            t.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_topk_first_call_on_a_stream_under_capture(card):
    """The merge's ticket is made by an eager call: a multi-tile call that
    would make it inside a CUDA-graph capture (its memory from the graph's
    pool, its zero-fill captured) raises instead. A one-tile call needs no
    ticket: captured on a fresh stream, its replay gives the eager
    result."""
    m, k = (1 << 20) + 7, 100
    s = _topk_scores("fleet", m, k, card)
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            ops.masked_topk(s, k)
    small = _topk_scores("fleet", 256, k, card)
    want = ops.masked_topk(small, k)
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=fresh):
        got = ops.masked_topk(small, k)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_topk_raises_on_what_it_does_not_take(card):
    """k > 1024 is no longer refused: it takes the sort route (the
    reference's ``lax.top_k`` route), bit-equal to the plain versions,
    with no kernel launch. Wrong types and strides still raise."""
    s = torch.randn(3000, device=card)
    state = _score_state("fleet", 3000, 1, card)
    sorts, launches = topk.masked_topk.sorts, topk.block_topk.launches
    vals, idx = ops.masked_topk(s, 1025)
    got = ops.scored_topk(*state, 1.2, 1025)
    torch.cuda.synchronize()
    assert (topk.masked_topk.sorts, topk.block_topk.launches) == \
        (sorts + 2, launches)
    want_v, want_i = ref.masked_topk(s, 1025)
    assert torch.equal(idx, want_i) and torch.equal(_bits(vals),
                                                    _bits(want_v))
    want = ref.scored_topk(*state, 1.2, 1025)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[2]), _bits(want[2]))
    with pytest.raises(TypeError):
        ops.masked_topk(s.double(), 10)
    with pytest.raises(ValueError):
        ops.masked_topk(s[::2], 10)
    with pytest.raises(TypeError):
        ops.scored_topk(state[0], state[1], state[2], state[3].float(),
                        state[4], 1.2, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("m, k", [(1 << 20, 4096), ((1 << 20) + 7, 1025),
                                  (3000, 3000)])
def test_topk_past_the_kernels_k_equals_plain(card, m, k):
    """The sort route at fleet scale, every kind of input: masked_topk and
    scored_topk bit-equal to the plain versions on the card and to the
    plain versions on CPU copies (the score is the reference's bit for
    bit), no kernel launch."""
    for kind in TOPK_KINDS:
        s = _topk_scores(kind, m, k, card)
        state = _score_state(kind, m, k, card)
        launches = topk.block_topk.launches
        vals, idx = ops.masked_topk(s, k)
        got = ops.scored_topk(*state, 1.2, k)
        torch.cuda.synchronize()
        assert topk.block_topk.launches == launches
        for want_v, want_i in (ref.masked_topk(s, k),
                               ref.masked_topk(s.cpu(), k)):
            assert torch.equal(idx.cpu(), want_i.cpu())
            assert torch.equal(_bits(vals.cpu()), _bits(want_v.cpu()))
        for want in (ref.scored_topk(*state, 1.2, k),
                     ref.scored_topk(*(t.cpu() for t in state), 1.2, k)):
            assert torch.equal(got[0].cpu(), want[0].cpu())
            assert torch.equal(got[1].cpu(), want[1].cpu())
            assert torch.equal(_bits(got[2].cpu()), _bits(want[2].cpu()))


def _same_bits(got, want):
    """Equal to the bit, NaNs where the other has NaNs (payloads aside)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 5000, 583680])
def test_quantize_q8_kernel_equals_plain(card, n):
    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn(n, device=card, generator=gen) * 3.0
    if n >= 1024:           # a NaN block, an inf block, -0, an all-zero block
        x[5], x[300], x[600] = float("nan"), float("inf"), -0.0
        x[768:1024] = 0.0
    before = quant8.quantize_q8.launches
    q, s = quant8.quantize_q8(x)
    torch.cuda.synchronize()
    assert quant8.quantize_q8.launches == before + 1
    want_q, want_s = ref.quantize_q8(x)
    assert torch.equal(q, want_q)
    _same_bits(s, want_s)
    if n >= 1024:
        assert bool((q[:512] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, n_scales", [(583680, 2280), (5000, 20),
                                         (5000, 24)])
def test_dequantize_q8_kernel_equals_plain(card, dtype, n, n_scales):
    gen = torch.Generator(device=card).manual_seed(n + n_scales)
    q = torch.randint(-127, 128, (n,), device=card, generator=gen,
                      dtype=torch.int8)
    s = torch.rand(n_scales, device=card, generator=gen) * 0.1
    before = quant8.dequantize_q8.launches
    got = quant8.dequantize_q8(q, s, dtype=dtype)
    torch.cuda.synchronize()
    assert quant8.dequantize_q8.launches == before + 1
    want = ref.dequantize_q8(q, s, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_compress_update_card_equals_cpu(card):
    """Three compressions with the error carried and one decompression:
    codes and scales equal to the CPU run's, the error and the update
    within rtol 1e-6 / atol 1e-7, one ``compress_q8`` launch a compression
    and one ``dequantize_q8`` for the decompression, no ``quantize_q8``."""
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(300, 70, generator=gen) * 0.01,
            "b": torch.randn(13, generator=gen)}
    on_card = {k: v.to(card) for k, v in tree.items()}
    err_card = err_cpu = None
    counters = (quant8.compress_q8, quant8.quantize_q8, quant8.dequantize_q8)
    before = [fn.launches for fn in counters]
    for _ in range(3):
        (q, s, spec), err_card = ops.compress_update(on_card, err_card)
        (q_cpu, s_cpu, _), err_cpu = ops.compress_update(tree, err_cpu)
        assert torch.equal(q.cpu(), q_cpu)
        _same_bits(s.cpu(), s_cpu)
        torch.testing.assert_close(err_card.cpu(), err_cpu, rtol=1e-6,
                                   atol=1e-7)
    back = ops.decompress_update(q, s, spec)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [3, 0, 1]
    for name, leaf in ops.decompress_update(q_cpu, s_cpu, spec).items():
        torch.testing.assert_close(back[name].cpu(), leaf, rtol=1e-6,
                                   atol=1e-7)


def _offset(t, offset):
    """``t``'s values in a view that starts ``offset`` elements into a
    buffer of its own: offset 1 of fp32 breaks 16-byte alignment."""
    buf = torch.empty(t.shape[0] + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["no_ef", "ef", "ef_misaligned",
                                    "flat_misaligned"])
@pytest.mark.parametrize("n", [1, 255, 257, 2047, 2049, 5003, 582026])
def test_compress_q8_kernel_equals_plain(card, n, layout):
    """The fused kernel against its plain version on the card, codes,
    scales and error to the bit, one launch: lengths with a tail past the
    last whole lane (N % 8, N % 4 != 0) and all-padding blocks, the error
    feedback absent, aligned or in a view one element into a buffer (the
    scalar path), a NaN block and an inf block where N > 512."""
    gen = torch.Generator(device=card).manual_seed(n)
    flat = torch.randn(n, device=card, generator=gen) * 0.02
    ef = (None if layout == "no_ef"
          else torch.randn(n, device=card, generator=gen) * 1e-4)
    if n > 512:
        flat[3], flat[300] = float("nan"), float("-inf")
    if layout == "ef_misaligned":
        ef = _offset(ef, 1)
    if layout == "flat_misaligned":
        flat = _offset(flat, 1)
    n_pad = n + (-n) % 2048
    before = quant8.compress_q8.launches
    q, s, err = quant8.compress_q8(flat, ef, n_pad)
    torch.cuda.synchronize()
    assert quant8.compress_q8.launches == before + 1
    want_q, want_s, want_err = ref.compress_q8(flat, ef, n_pad)
    assert torch.equal(q, want_q)
    _same_bits(s, want_s)
    _same_bits(err, want_err)
    if n > 512:
        assert not bool(q[:512].any())
        assert bool(torch.isnan(err[:512]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, offset", [(583680, 0), (2049, 0), (7, 0),
                                       (5003, 1), (5000, 3)])
def test_dequantize_q8_vector_path_equals_plain(card, dtype, n, offset):
    """Eight codes a lane: one 8-byte load, 16-byte stores; the tail lane
    (N % 8 != 0) and codes in a view that does not start on 8 bytes take
    the scalar path. fp32 and bf16 out, to the bit."""
    gen = torch.Generator(device=card).manual_seed(n + offset)
    q = _offset(torch.randint(-127, 128, (n,), device=card, generator=gen,
                              dtype=torch.int8), offset)
    s = torch.rand(-(-n // 256), device=card, generator=gen) * 0.1
    before = quant8.dequantize_q8.launches
    got = quant8.dequantize_q8(q, s, dtype=dtype)
    torch.cuda.synchronize()
    assert quant8.dequantize_q8.launches == before + 1
    want = ref.dequantize_q8(q, s, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_aggregate_pytree_card_matches_cpu(card):
    gen = torch.Generator().manual_seed(1)
    trees = [{"a": torch.randn(37, 5, generator=gen),
              "b": torch.randn(11, generator=gen)} for _ in range(3)]
    w = [0.2, 0.5, 0.3]
    before = sa.staleness_agg.launches
    got = ops.aggregate_pytree([{k: v.to(card) for k, v in t.items()}
                                for t in trees], w)
    torch.cuda.synchronize()
    assert sa.staleness_agg.launches == before + 1
    for name, leaf in ops.aggregate_pytree(trees, w).items():
        torch.testing.assert_close(got[name].cpu(), leaf, rtol=RTOL,
                                   atol=ATOL)


ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}


def assert_attention_close(got, want, rows=128):
    """Block by block of ``rows`` query rows, at ATTN_TOL scaled by the
    block's rms (see the module docstring)."""
    tol = ATTN_TOL[want.dtype]
    got, want = got.float(), want.float()
    for r in range(0, want.shape[2], rows):
        w, g = want[:, :, r:r + rows], got[:, :, r:r + rows]
        limit = tol * (w.pow(2).mean().sqrt() + w.abs())
        bad = (g - w).abs() > limit
        assert not bool(bad.any()), (
            f"rows {r}..: {int(bad.sum())} values off, max abs "
            f"{float((g - w).abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, s, t, d, dtype, causal, block", [
    (1, 2, 128, 128, 64, torch.float32, True, 128),
    (1, 2, 256, 128, 64, torch.float32, False, 128),
    (1, 2, 128, 256, 128, torch.float32, True, 128),
    (2, 3, 192, 320, 128, torch.bfloat16, True, 64),
    (1, 2, 256, 256, 128, torch.bfloat16, False, 128),
    (1, 1, 96, 96, 64, torch.float32, True, 32),    # ragged for 64-tiles
    (1, 16, 1024, 1024, 128, torch.bfloat16, True, 128),
    (1, 2, 256, 256, 64, torch.bfloat16, True, 128),
    (1, 2, 256, 384, 64, torch.bfloat16, False, 128),
    (2, 3, 320, 192, 128, torch.bfloat16, False, 64),   # ragged, S != T
    (1, 1, 128, 128, 128, torch.bfloat16, True, 128),
    # fp16: the 16-bit kernel with the .f16 wgmma
    (1, 2, 256, 256, 128, torch.float16, True, 128),
    (2, 3, 320, 192, 64, torch.float16, False, 64),    # ragged, S != T
    (1, 16, 1024, 1024, 128, torch.float16, True, 128),
    # fp32 (three TF32 products): ragged tiles, S != T, both masks
    (2, 3, 320, 192, 128, torch.float32, False, 64),
    (2, 3, 192, 320, 128, torch.float32, True, 64),
    (1, 2, 256, 256, 128, torch.float32, False, 128),
    (1, 16, 1024, 1024, 128, torch.float32, True, 128),
    # head dims the kernels run padded to 64 or 128, each type
    (1, 2, 256, 256, 16, torch.float32, True, 128),
    (1, 2, 256, 384, 96, torch.float32, False, 128),
    (1, 2, 256, 256, 16, torch.bfloat16, False, 128),
    (1, 2, 384, 256, 96, torch.bfloat16, True, 128),
    (1, 2, 256, 256, 16, torch.float16, True, 128),
    (1, 2, 256, 256, 96, torch.float16, False, 128),
])
def test_flash_attention_kernel_matches_plain(card, b, h, s, t, d, dtype,
                                              causal, block):
    gen = torch.Generator(device=card).manual_seed(s * t + d)
    q, k, v = (torch.randn(b, h, n, d, device=card, generator=gen).to(dtype)
               for n in (s, t, t))
    before = attn.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, block_q=block,
                              block_k=block)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, h, s, d)
    assert_attention_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("d, causal", [(128, True), (64, False)])
def test_flash_attention_ragged_tile_never_reads_the_next_head(card, d,
                                                               causal, dtype):
    """S = T = 192: every kernel's last 128-row query tile runs 64 rows
    past each head (and the 16-bit kernels' last 128-key tile too). Head 1
    is all NaN; head 0 must come out finite and right (its tiles past the
    end read zeros, not head 1's rows)."""
    gen = torch.Generator(device=card).manual_seed(d)
    q, k, v = (torch.randn(1, 2, 192, d, device=card, generator=gen
                           ).to(dtype) for _ in range(3))
    for t in (q, k, v):
        t[:, 1] = float("nan")
    got = ops.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    torch.cuda.synchronize()
    head0 = got[:, :1]
    assert bool(torch.isfinite(head0).all())
    want = ref.flash_attention(*(t[:, :1] for t in (q, k, v)), causal=causal)
    assert_attention_close(head0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_prefix_rows_equal_the_prefix_run(card, dtype):
    gen = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn(1, 4, 512, 128, device=card, generator=gen
                           ).to(dtype) for _ in range(3))
    full = ops.flash_attention(q, k, v)
    prefix = ops.flash_attention(*(t[:, :, :256].contiguous()
                                   for t in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(full[:, :, :256], prefix)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_takes_more_than_65535_heads(card, dtype):
    """B * H = 65,537 (past the 65,535 of a grid's second dimension): one
    launch, every head right."""
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn(1, 65537, 128, 64, device=card, generator=gen
                           ).to(dtype) for _ in range(3))
    before = attn.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    assert_attention_close(got, ref.flash_attention(q, k, v))


@pytest.mark.cuda
def test_flash_attention_raises_on_what_it_does_not_take(card):
    """D = 96 and fp16 compute now; D past 128 and fp64 do not."""
    t = torch.zeros(1, 2, 128, 192, device=card)
    with pytest.raises(NotImplementedError, match="128"):
        ops.flash_attention(t, t, t)
    h = torch.zeros(1, 2, 128, 64, device=card, dtype=torch.float64)
    before = attn.flash_attention.launches
    with pytest.raises(TypeError):
        ops.flash_attention(h, h, h)
    assert attn.flash_attention.launches == before


# ----------------------------------------------------- engines on the card
class TableIndices:
    """Minibatch indices from a numpy generator, equal on every device, so
    a card run and a CPU run draw the same minibatches."""

    def __init__(self, seed, batch_size):
        self.rng, self.batch_size = np.random.default_rng(seed), batch_size

    def __call__(self, Kp, max_steps, n_i):
        n = np.maximum(n_i.cpu().numpy(), 1)[:, None, None]
        u = self.rng.random((Kp, max_steps, self.batch_size))
        return torch.as_tensor((u * n).astype(np.int64), device=n_i.device)


def _trace(eng):
    return ([(l.round, l.t_start, l.t_end, l.accuracy, l.n_aggregated,
              l.n_stale) for l in eng.history],
            [(r.client_id, r.round, r.t_invoked, r.cold, r.duration,
              r.failed) for r in eng.platform.invocations])


MEGA_KW = dict(n_clients=10, clients_per_round=4, rounds=8, local_epochs=1,
               batch_size=5, base_step_time=0.5, strategy="apodotiko-topk",
               concurrency_ratio=1.0, eval_every=0, keep_warm=1e9, seed=0)


@pytest.mark.cuda
def test_fused_megastep_equals_stepwise_on_the_card(card):
    """ProxyCNN on 10 zero-variability clients: 3 stepwise bootstrap
    rounds, then 5 fused; trace, params, free list, device score state
    and generator bit-equal to the stepwise run, launches equal."""
    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    fleet = [HardwareProfile(f"det{i % 3}", speed=(1.0, 1.45, 1.9)[i % 3],
                             vcpus=1.0, mem_gib=2.0, variability=0.0)
             for i in range(10)]
    runs, was = {}, torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("stepwise", "fused"):
            eng = Scheduler(FLConfig(**MEGA_KW, megastep=mode), ProxyCNN(10),
                            data, list(fleet), device=card)
            counts = [w.launches for w in (topk.block_topk,
                                           sa.staleness_agg, fa.fused_adam)]
            m = eng.run()
            torch.cuda.synchronize()
            counts = [w.launches - c for w, c in zip(
                (topk.block_topk, sa.staleness_agg, fa.fused_adam), counts)]
            runs[mode] = (eng, m, counts)
    finally:
        torch.use_deterministic_algorithms(was)
    (step, m_step, c_step), (fused, m_fused, c_fused) = runs.values()
    assert (m_step["megastep_rounds"], m_fused["megastep_rounds"]) == (0, 5)
    assert _trace(fused) == _trace(step)
    for name, leaf in step.params.items():
        assert torch.equal(leaf.view(torch.int32),
                           fused.params[name].view(torch.int32)), name
    assert fused.store._free == step.store._free
    for eng in (step, fused):
        eng.db.fleet._flush_device()
    for col in ("num", "den", "booster", "eligible", "ever"):
        assert torch.equal(getattr(step.db.fleet._dev, col),
                           getattr(fused.db.fleet._dev, col)), col
    assert torch.equal(step.trainer.generator.get_state(),
                       fused.trainer.generator.get_state())
    assert c_step == c_fused and c_fused[:2] == [8, 8]


@pytest.mark.cuda
def test_fused_weight_normalization_on_the_card_equals_the_hosts(card):
    rng = np.random.default_rng(0)
    for k in (1, 30, 100, 1000):
        n = rng.integers(1, 600, size=k)
        host = n.astype(np.float32)
        host = host / host.sum()
        w = torch.as_tensor(n.astype(np.float32), device=card)
        got = (w / w.sum()).cpu().numpy()
        assert np.array_equal(got.view(np.int32), host.view(np.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("cap, k", [(208, 100), (208, 30)])
def test_aggregate_rows_traced_equals_stepwise_route_on_the_card(card, cap,
                                                                 k):
    from repro_torch.core.aggregation import rows_dispatch
    gen = torch.Generator(device=card).manual_seed(k)
    buf = torch.randn(cap, 582656, device=card, generator=gen)
    rows = torch.randperm(cap, device=card, generator=gen)[:k]
    w = torch.rand(k, device=card, generator=gen)
    sparse = rows_dispatch(cap, k)
    stepwise = ops.aggregate_rows_gather if sparse else ops.aggregate_rows
    want = stepwise(buf, rows.cpu().numpy(), w.cpu().numpy())
    before = sa.staleness_agg.launches
    got = ops.aggregate_rows_traced(buf, rows, w, sparse=sparse)
    torch.cuda.synchronize()
    assert sa.staleness_agg.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_scaffold_on_the_card_matches_the_cpu(card):
    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    init = ProxyCNN(10).init(torch.Generator().manual_seed(1))
    kw = dict(n_clients=10, clients_per_round=4, rounds=3, local_epochs=1,
              batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0,
              strategy="scaffold", lr=1e-3)
    runs = {}
    for where in (card, torch.device("cpu")):
        eng = Scheduler(FLConfig(**kw), ProxyCNN(10), data,
                        list(paper_fleet(10)), device=where,
                        init_params={k: v.to(where) for k, v in init.items()})
        eng.trainer.batch_indices = TableIndices(7, 5)
        eng.run()
        runs[where.type] = eng
    on_card, on_cpu = runs["cuda"], runs["cpu"]
    assert _trace(on_card) == _trace(on_cpu)
    assert on_card.c_global.is_cuda and on_card.c_buf.is_cuda
    for name, leaf in on_card.params.items():
        torch.testing.assert_close(leaf.cpu(), on_cpu.params[name],
                                   rtol=1e-4, atol=1e-5)
    # a variate divides a params difference by steps * lr, so its absolute
    # tolerance is the params' over lr
    torch.testing.assert_close(on_card.c_global.cpu(), on_cpu.c_global,
                               rtol=1e-4, atol=1e-5 / kw["lr"])


@pytest.fixture
def no_tf32(card):
    """TF32 off for cuDNN and cuBLAS (cuDNN's defaults to on): the card
    computes in fp32, as the CPU does."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield card
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = was


def _model_inputs(model, batch, seed):
    rng = np.random.default_rng(seed)
    if hasattr(model, "seq_len"):
        x = rng.integers(0, model.vocab, (batch, model.seq_len)).astype(np.int32)
    else:
        x = rng.normal(size=(batch,) + model.input_shape).astype(np.float32)
    return x, rng.integers(0, model.n_classes, batch).astype(np.int64)


# The filter gradient of FemnistCNN's first layer (5x5, one input channel,
# 28x28, SAME) sums 6,272 products a weight at batch 8, with cancellation
# (c1_w's largest value is 0.07): unbatched, cuDNN's strays from an fp64
# computation by about 1e-4 on the H100, and an fp32 CPU's may stray as
# far, so the two fp32 results are not held to each other. The unbatched
# case holds that one grad, from the card, to fp64 at this atol; under
# vmap (the trainer's path) the card is held to the CPU at 1e-5.
CUDNN_FIRST_FILTER_ATOL = 2e-4


def _new_model(name):
    from repro_torch.models.paper_models import build_paper_model
    from repro_torch.models.proxy_models import ProxyLSTM
    return ProxyLSTM() if name == "proxy-lstm" else build_paper_model(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paper-femnist", "paper-speech",
                                  "paper-shakespeare", "proxy-lstm"])
def test_new_models_vmapped_grads_card_equal_cpu(no_tf32, name):
    """Each model of this slice as the trainer runs it: per-lane loss and
    grads under ``torch.func.vmap(grad_and_value)``, two lanes of batch 8
    from one set of params, on the card within rtol 1e-4 / atol 1e-5 of
    the CPU."""
    model = _new_model(name)
    params = model.init(torch.Generator().manual_seed(0))
    (x0, y0), (x1, y1) = (_model_inputs(model, 8, seed=s) for s in (1, 2))
    out = []
    for dev in (no_tf32, torch.device("cpu")):
        lanes = {k: torch.stack([v, v]).to(dev) for k, v in params.items()}
        x = torch.as_tensor(np.stack([x0, x1]), device=dev)
        y = torch.as_tensor(np.stack([y0, y1]), device=dev)
        out.append(torch.func.vmap(torch.func.grad_and_value(
            lambda p, xb, yb: model.loss(p, {"x": xb, "y": yb})[0]))(
                lanes, x, y))
    (gc, lc), (gh, lh) = out
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5)
    for k in gh:
        torch.testing.assert_close(gc[k].cpu(), gh[k], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paper-femnist", "paper-speech",
                                  "paper-shakespeare", "proxy-lstm"])
def test_new_models_forward_and_grads_card_equal_cpu(no_tf32, name):
    """Logits, loss and every grad of each model of this slice, unbatched
    at batch 8, on the card within rtol 1e-4 / atol 1e-5 of the CPU's,
    from one set of params; FemnistCNN's first filter gradient from the
    card against an fp64 one on the CPU (``CUDNN_FIRST_FILTER_ATOL``, see
    there)."""
    model = _new_model(name)
    params = model.init(torch.Generator().manual_seed(0))
    x, y = _model_inputs(model, 8, seed=1)
    cpu = torch.device("cpu")
    out = []
    for dev, dtype in ((no_tf32, torch.float32), (cpu, torch.float32),
                       (cpu, torch.float64)):
        p = {k: v.to(dev, dtype) for k, v in params.items()}
        xb = torch.as_tensor(x, device=dev)
        batch = {"x": xb if xb.dtype == torch.int32 else xb.to(dtype),
                 "y": torch.as_tensor(y, device=dev)}
        logits = model.predict(p, batch["x"])
        grads, loss = torch.func.grad_and_value(
            lambda q: model.loss(q, batch)[0])(p)
        out.append((logits, loss, grads))
    (lc, sc, gc), (lh, sh, gh), (_, _, g64) = out
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sc.cpu(), sh, rtol=1e-4, atol=1e-5)
    for k in gh:
        if (name, k) == ("paper-femnist", "c1_w"):
            torch.testing.assert_close(gc[k].cpu().double(), g64[k],
                                       rtol=1e-4, atol=CUDNN_FIRST_FILTER_ATOL)
            continue
        torch.testing.assert_close(gc[k].cpu(), gh[k], rtol=1e-4, atol=1e-5,
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.cuda
def test_shakespeare_lstm_cohort_step_on_the_card(no_tf32):
    """One cohort of the paper's LSTM (80-character sequences, SGD 0.8,
    ragged budgets, one pad lane) through the trainer on the card and on
    the CPU from one index table: rows within rtol 1e-4 / atol 1e-5, no
    ``fused_adam`` launch (SGD), losses finite."""
    from repro_torch.core.client import CohortTrainer
    from repro_torch.core.data_plane import DatasetStore
    from repro_torch.core.update_store import UpdateStore
    from repro_torch.models.paper_models import ShakespeareLSTM
    from repro_torch.models.common import count_params

    data = make_federated_dataset("shakespeare", n_clients=4, scale=0.05,
                                  seed=0, fidelity="paper")
    model = ShakespeareLSTM()
    init = model.init(torch.Generator().manual_seed(2))
    sel, steps = [3, 0, 2], np.array([2, 3, 1])
    rows = []
    for dev in (no_tf32, torch.device("cpu")):
        t = CohortTrainer(model, optimizer="sgd", lr=0.8, batch_size=4,
                          device=dev, batch_indices=TableIndices(5, 4))
        store = UpdateStore(count_params(init), capacity=4, device=dev)
        before = fa.fused_adam.launches
        ids, _, loss = t.train_cohort_indexed(
            {k: v.to(dev) for k, v in init.items()}, DatasetStore(data, dev),
            sel, data.n[sel], steps, update_sink=store)
        assert fa.fused_adam.launches == before
        assert np.isfinite(loss).all()
        rows.append(store.gather(ids).cpu())
    torch.testing.assert_close(rows[0], rows[1], rtol=1e-4, atol=1e-5)


# ------------------------------------------ profiles, planes and precision
# a fault spec of every kind, its outage window open from t = 0, and an
# early-boundary traffic spec (tests/test_traffic.py's ENGINE_SPECS[0])
ALL_FAULTS = ("crash:train:0.2,slow:2.5:0.2,loss:0.15:0.2:45,oom:2.0:0.3,"
              "crash:startup:0.1,crash:upload:0.1,outage:0-40:mod3=1")
CARD_CASES = {
    "untouched_tf32": dict(strategy="apodotiko"),
    "faults": dict(strategy="apodotiko", fault_profile=ALL_FAULTS,
                   retry_budget=8, invocation_timeout=300.0,
                   quarantine_threshold=3),
    "traffic": dict(strategy="apodotiko",
                    traffic_profile="init:0.5,window:10,poisson:0.15:80"),
    "planes": dict(strategy="apodotiko", update_plane="blob",
                   data_plane="host"),
}


def _chaos_trace(eng):
    hist, inv = _trace(eng)
    return hist, inv, [(r.client_id, r.round, r.failed_phase, r.lost,
                        r.timed_out, r.cancelled)
                       for r in eng.platform.invocations]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_build_engine_on_the_card_matches_the_cpu(card, case):
    """``build_engine(...).run()`` with torch's TF32 flags as they are (no
    fixture: the trainer and the evaluation hold fp32 in their own scope)
    on the card against the same run on the CPU, on one table of minibatch
    indices: identical chaos trace and counters, params within rtol 1e-4 /
    atol 1e-5, and the flags the same after the run as before."""
    from repro_torch.core.scheduler import build_engine

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    init = ProxyCNN(10).init(torch.Generator().manual_seed(1))
    kw = dict(n_clients=10, clients_per_round=4, rounds=3, local_epochs=1,
              batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0,
              **CARD_CASES[case])
    runs = {}
    for where in (card, torch.device("cpu")):
        eng = build_engine(FLConfig(**kw), ProxyCNN(10), data,
                           list(paper_fleet(10)), device=where,
                           init_params={k: v.to(where)
                                        for k, v in init.items()})
        eng.trainer.batch_indices = TableIndices(7, 5)
        runs[where.type] = (eng, eng.run())
    (on_card, m_card), (on_cpu, m_cpu) = runs["cuda"], runs["cpu"]
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags
    assert _chaos_trace(on_card) == _chaos_trace(on_cpu)
    for key in ("failures_by_phase", "n_retries", "n_traffic_joins",
                "n_traffic_leaves", "update_host_bytes", "data_host_bytes",
                "megastep_fallback_reason"):
        assert m_card[key] == m_cpu[key], key
    for name, leaf in on_card.params.items():
        assert leaf.is_cuda
        torch.testing.assert_close(leaf.cpu(), on_cpu.params[name],
                                   rtol=1e-4, atol=1e-5)
    if case == "faults":
        assert m_card["n_failures"] > 0
    if case == "traffic":
        assert m_card["n_traffic_joins"] > 0
    if case == "planes":
        assert on_card.store is None and on_card.dataset is None
        assert min(m_card["update_host_bytes"],
                   m_card["data_host_bytes"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 30, 100])
def test_aggregate_pytree_at_mnist_width_equals_plain(card, k):
    """The blob plane's launch: K MnistCNN-shaped trees (582,026 params, N
    padded to 4), one ``staleness_agg`` over the stack, against the plain
    version on the same stack on the card."""
    from repro_torch.models.paper_models import MnistCNN

    template = MnistCNN().init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=card).manual_seed(k)
    trees = [{n: torch.randn(p.shape, device=card, generator=gen)
              for n, p in template.items()} for _ in range(k)]
    w = torch.rand(k, device=card, generator=gen)
    before = sa.staleness_agg.launches
    got = ops.aggregate_pytree(trees, w, restore_dtype=False)
    torch.cuda.synchronize()
    assert sa.staleness_agg.launches == before + 1
    spec = ops.RavelSpec(trees[0])
    want = ref.staleness_agg(torch.stack([spec.ravel(t) for t in trees]), w)
    # sums of K unit-normal terms in another order, as
    # test_staleness_agg_kernel_matches_plain holds them
    torch.testing.assert_close(spec.ravel(got), want, rtol=RTOL,
                               atol=ATOL * k)


# ------------------------------------------------------------ durable runs
DURABLE_KW = dict(n_clients=10, clients_per_round=4, rounds=3,
                  local_epochs=1, batch_size=5, base_step_time=0.5,
                  round_timeout=200.0, seed=0, durability="journal")


def _durable_state(eng):
    """What a resume must give back bit for bit: the trace, params (their
    bits), the store's free list and live rows, and the generator."""
    live = [int(i) for i in eng.store.live_rows()]
    return {"trace": _trace(eng),
            "params": {n: p.view(torch.int32).cpu()
                       for n, p in eng.params.items()},
            "free": list(eng.store._free), "live": live,
            "rows": eng.store.gather(live).view(torch.int32).cpu(),
            "generator": eng.trainer.generator.get_state()}


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["scheduler", "legacy"])
def test_durable_resume_on_the_card_is_bit_identical(card, tmp_path, engine):
    """A durable run on the card killed mid-run and at the last round close
    resumes, on the card with the device store, to the golden run's
    journal bytes, history, clock, params, free list, live rows and
    generator, under deterministic algorithms; the resumed run launches
    ``staleness_agg`` once a re-executed round."""
    from repro_torch.core.scheduler import build_engine
    from repro_torch.durability import SimulatedCrash, resume_durable

    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    kw = dict(DURABLE_KW, strategy="apodotiko", engine=engine)

    def cfg(name):
        return FLConfig(**kw, checkpoint_dir=str(tmp_path / name))

    def journal(name):
        with open(tmp_path / name / "journal.wal", "rb") as f:
            return f.read()

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        gold = build_engine(cfg("gold"), ProxyCNN(10), data,
                            list(paper_fleet(10)), device=card)
        m_gold = gold.run()
        n = m_gold["journal_records"]
        for k in (n // 2, n - 1):
            eng = build_engine(cfg(f"c{k}"), ProxyCNN(10), data,
                               list(paper_fleet(10)), device=card)
            eng.durability.crash_after = k
            with pytest.raises(SimulatedCrash):
                eng.run()
            res = resume_durable(cfg(f"c{k}"), ProxyCNN(10), data,
                                 list(paper_fleet(10)), device=card)
            assert res.store.buffer.device.type == "cuda"
            before = sa.staleness_agg.launches
            done = res.db.round
            m = res.run()
            torch.cuda.synchronize()
            assert sa.staleness_agg.launches - before == 3 - done
            assert m["history"] == m_gold["history"]
            assert m["total_time"] == m_gold["total_time"]
            assert journal(f"c{k}") == journal("gold")
            assert _same(_durable_state(res), _durable_state(gold))
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.cuda
def test_controller_checkpoint_resume_on_the_card(card, tmp_path):
    """The poll loop's database checkpoint on the card: the resume holds
    the checkpoint's round, client records, global params and live rows,
    the rows back on the card at their ids, and the run goes on."""
    from repro_torch.core.controller import Controller

    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    kw = dict(n_clients=10, clients_per_round=4, local_epochs=1,
              batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0,
              strategy="apodotiko", checkpoint_dir=str(tmp_path))
    ctl = Controller(FLConfig(**kw, rounds=2, checkpoint_every=1),
                     ProxyCNN(10), data, list(paper_fleet(10)), device=card)
    ctl.run()
    while ctl.loop.step():      # land the stragglers: live rows to save
        pass
    ctl.checkpoint()
    live = [r.update_row for r in ctl.db.results if not r.aggregated]
    assert live
    res = Controller.resume(FLConfig(**kw, rounds=3), ProxyCNN(10), data,
                            list(paper_fleet(10)), device=card)
    assert res.db.round == 2
    assert res.db.client_ids() == ctl.db.client_ids()
    for name, p in ctl.params.items():
        assert torch.equal(res.params[name], p), name
    assert res.store.buffer.device.type == "cuda"
    assert torch.equal(res.store.gather(live), ctl.store.gather(live))
    m = res.run()
    assert m["rounds"] >= 1 and res.db.round == 3


# -- the dense decoder LM -----------------------------------------------------


def _lm_batch(vocab, seed=0):
    tok = np.random.default_rng(seed).integers(0, vocab, (2, 17))
    tgt = tok[:, 1:].copy()
    tgt[0, -3:] = -1
    return tok[:, :-1].astype(np.int32), tgt


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-8b", "yi-6b",
                                  "qwen3-4b", "deepseek-v2-lite-16b",
                                  "arctic-480b"])
def test_lm_loss_and_grads_card_equal_cpu(no_tf32, arch):
    """A smoke-config ``DecoderLM``'s loss and every grad on the card
    within rtol 1e-4 / atol 1e-5 of the CPU, from one set of params, TF32
    off (both compute in fp32)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import tree_leaves, tree_map
    from repro_torch.models.lm import DecoderLM

    lm = DecoderLM(get_config(arch, smoke=True))
    params = lm.init(torch.Generator().manual_seed(0))
    tok, tgt = _lm_batch(lm.cfg.vocab_size)
    out = []
    for dev in (no_tf32, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        loss, _ = lm.loss(p, {"tokens": torch.as_tensor(tok, device=dev),
                              "targets": torch.as_tensor(tgt, device=dev)})
        loss.backward()
        out.append((loss.detach(), [t.grad for t in tree_leaves(p)]))
    (lc, gc), (lh, gh) = out
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5)
    for a, b in zip(gc, gh):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_lm_prefill_then_decode_on_the_card_matches_full_forward(no_tf32):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import DecoderLM

    lm = DecoderLM(get_config("qwen3-1.7b", smoke=True))
    p = lm.init(torch.Generator(device=no_tf32).manual_seed(0))
    tok = torch.randint(0, lm.cfg.vocab_size, (2, 13), device=no_tf32,
                        generator=torch.Generator(device=no_tf32).manual_seed(1))
    with torch.no_grad():
        full, _, _ = lm.apply(p, {"tokens": tok[:, :12]})
        _, caches, _ = lm.apply(p, {"tokens": tok[:, :11]}, make_cache=True,
                                cache_len=13)
        dec, _ = lm.decode_step(p, caches, tok[:, 11:12], 11)
    assert caches["stack"]["k"].is_cuda
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_federated_lm_round_card_matches_cpu(card):
    """One round of the federated LM example's setup (6 clients, 4 a round)
    on the card and on the CPU from one set of params, on one table of
    minibatch indices: the host trace identical, the global params within
    rtol 1e-4 / atol 1e-5, the token accuracies within 1e-2 (an argmax
    may flip on a difference of 1e-6)."""
    import importlib.util
    from pathlib import Path

    from repro_torch.core.controller import Controller
    from repro_torch.kernels.ops import tree_leaves, tree_map
    from repro_torch.models.api import LMClientAdapter

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_train_fl_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_fl_lm", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = ex.lm_config("qwen3-1.7b", full=False)
    data = ex.make_lm_federated_data(6, cfg.vocab_size, seq_len=32,
                                     samples_per_client=24)
    init = LMClientAdapter(cfg).init(torch.Generator().manual_seed(0))
    runs = {}
    for where in (card, torch.device("cpu")):
        ctl = Controller(ex.fl_config(6, 1), LMClientAdapter(cfg), data,
                         list(paper_fleet(6)), device=where,
                         init_params=tree_map(lambda t: t.to(where), init))
        ctl.trainer.batch_indices = TableIndices(7, 4)
        ctl.run()
        runs[where.type] = ctl
    on_card, on_cpu = runs["cuda"], runs["cpu"]
    strip = lambda t: ([h[:3] + h[4:] for h in t[0]], t[1])
    assert strip(_trace(on_card)) == strip(_trace(on_cpu))
    assert abs(on_card.history[-1].accuracy
               - on_cpu.history[-1].accuracy) <= 1e-2
    for a, b in zip(tree_leaves(on_card.params), tree_leaves(on_cpu.params)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


# -- the MoE + MLA family and Adafactor ----------------------------------------


def _smoke_params(arch, init_fn):
    from repro_torch.configs import get_config
    from repro_torch.models.common import ParamFactory

    cfg = get_config(arch, smoke=True)
    pf = ParamFactory(torch.Generator().manual_seed(0))
    init_fn(pf, cfg)
    return cfg, pf.params


@pytest.mark.cuda
@pytest.mark.parametrize("arch, cf", [("deepseek-v2-lite-16b", 8.0),
                                      ("arctic-480b", 0.5)])
def test_moe_dispatch_and_output_card_equal_cpu(no_tf32, arch, cf):
    """The MoE layer on the card and on the CPU from one set of params:
    routing and dispatch indices equal, the output and the aux loss within
    rtol 1e-5 / atol 1e-6 (cf 0.5 drops)."""
    from repro_torch.kernels.ops import tree_map
    from repro_torch.models import moe

    cfg, p = _smoke_params(arch, moe.init_moe)
    cfg = cfg.with_(capacity_factor=cf)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(4, 24, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in (no_tf32, torch.device("cpu")):
        q = tree_map(lambda t: t.to(dev), p)
        _, _, top_e = moe.route(q, x.to(dev).reshape(96, -1), cfg)
        d = moe.dispatch(top_e, moe.capacity(96, cfg), cfg.n_experts)
        y, aux = moe.moe_forward(q, x.to(dev), cfg)
        out[dev.type] = (top_e, d, y, aux)
    (ec, dc, yc, ac), (eh, dh, yh, ah) = out["cuda"], out["cpu"]
    assert torch.equal(ec.cpu(), eh)
    for k in ("order", "slot", "slot_token", "keep"):
        assert torch.equal(dc[k].cpu(), dh[k]), k
    assert bool((~dh["keep"]).any()) == (cf < 1)
    torch.testing.assert_close(yc.cpu(), yh, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ac.cpu(), ah, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_moe_bf16_combine_is_deterministic_on_the_card(card):
    """The bf16 combine (each token's contributions summed in sorted
    order, no atomics) gives the same bits in two calls on the card, and
    the bits of the CPU on the same expert outputs."""
    from repro_torch.models import moe

    cfg, p = _smoke_params("deepseek-v2-lite-16b", moe.init_moe)
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(96, cfg.d_model)).astype(np.float32))
    _, top_w, top_e = moe.route(p, x, cfg)
    C = moe.capacity(96, cfg.with_(capacity_factor=0.5))
    d = moe.dispatch(top_e, C, cfg.n_experts)
    oe = torch.randn(cfg.n_experts * C, cfg.d_model,
                     generator=torch.Generator().manual_seed(3))
    oe = oe.to(torch.bfloat16)
    want = moe.combine(oe, top_w, d)
    dc = {k: v.to(card) for k, v in d.items()}
    runs = [moe.combine(oe.to(card), top_w.to(card), dc) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0].cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uncached", "prefill", "decode"])
def test_mla_forward_card_equal_cpu(no_tf32, mode):
    """MLA's expanded branch (no cache) and absorbed branch (prefill at 0,
    decode at 6) on the card within rtol 1e-4 / atol 1e-5 of the CPU, the
    new cache too."""
    from repro_torch.kernels.ops import tree_map
    from repro_torch.models import attention

    cfg, p = _smoke_params("deepseek-v2-lite-16b", attention.init_mla)
    S, pos = {"uncached": (7, 0), "prefill": (7, 0), "decode": (1, 6)}[mode]
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, S, cfg.d_model)).astype(
        np.float32))
    cache = None if mode == "uncached" else {
        "c": torch.as_tensor(rng.normal(size=(2, 10, cfg.kv_lora_rank))
                             .astype(np.float32)),
        "k_pe": torch.as_tensor(rng.normal(size=(2, 10, cfg.qk_rope_dim))
                                .astype(np.float32))}
    out = {}
    for dev in (no_tf32, torch.device("cpu")):
        c = None if cache is None else tree_map(lambda t: t.to(dev), cache)
        out[dev.type] = attention.mla_forward(
            tree_map(lambda t: t.to(dev), p), x.to(dev), cfg,
            torch.arange(S, device=dev) + pos, cache=c,
            pos=None if cache is None else pos)
    (yc, cc), (yh, ch) = out["cuda"], out["cpu"]
    torch.testing.assert_close(yc.cpu(), yh, rtol=1e-4, atol=1e-5)
    if cache is not None:
        for k in ("c", "k_pe"):
            torch.testing.assert_close(cc[k].cpu(), ch[k], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.cuda
def test_moe_prefill_then_decode_on_the_card_matches_full_forward(no_tf32):
    """DeepSeek-V2-Lite's smoke config on the card: the absorbed MLA
    (prefill, decode) against the expanded one (the full forward), at cf 8
    (no drops), within the reference's 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import DecoderLM

    lm = DecoderLM(get_config("deepseek-v2-lite-16b", smoke=True))
    p = lm.init(torch.Generator(device=no_tf32).manual_seed(0))
    tok = torch.randint(0, lm.cfg.vocab_size, (2, 13), device=no_tf32,
                        generator=torch.Generator(device=no_tf32).manual_seed(1))
    with torch.no_grad():
        full, _, _ = lm.apply(p, {"tokens": tok[:, :12]})
        _, caches, _ = lm.apply(p, {"tokens": tok[:, :11]}, make_cache=True,
                                cache_len=13)
        dec, _ = lm.decode_step(p, caches, tok[:, 11:12], 11)
    assert caches["stack"]["c"].is_cuda and len(caches["first"]) == 1
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_adafactor_both_forms_card_equal_cpu(card):
    """Adafactor's pytree form (3 steps over rank-1, -2 and -3 leaves) and
    its cohort form (4 lanes of unequal budgets over the rows' leaf views)
    on the card within rtol 1e-5 / atol 1e-6 of the CPU."""
    from repro_torch.kernels.ops import RavelSpec, tree_leaves, tree_map
    from repro_torch.optim import adafactor, apply_updates

    rng = np.random.default_rng(5)
    tree = {"b": rng.normal(size=(7,)), "w": rng.normal(size=(5, 6)),
            "e": rng.normal(size=(3, 4, 5))}
    tree = {k: torch.as_tensor(v.astype(np.float32)) for k, v in tree.items()}
    grads = [tree_map(lambda t: torch.as_tensor(
        rng.normal(size=tuple(t.shape)).astype(np.float32)), tree)
        for _ in range(3)]
    spec = RavelSpec(tree)
    flat0 = torch.as_tensor(rng.normal(size=(4, spec.n_params + 4))
                            .astype(np.float32))
    g_rows = [torch.as_tensor(rng.normal(size=tuple(flat0.shape))
                              .astype(np.float32)) for _ in range(3)]
    steps = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    opt = adafactor(1e-2)
    out = {}
    for dev in (card, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), tree)
        state = opt.init(p)
        for g in grads:
            upd, state = opt.update(tree_map(lambda t: t.to(dev), g), state,
                                    p)
            p = apply_updates(p, upd)
        flat = flat0.to(dev)
        cstate = opt.cohort_init(flat, spec)
        for s, g in enumerate(g_rows):
            opt.cohort_step(flat, cstate, g.to(dev), steps.to(dev), s)
        out[dev.type] = (tree_leaves(p) + tree_leaves(state["s"]), flat)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out["cuda"][1].cpu(), out["cpu"][1],
                               rtol=1e-5, atol=1e-6)


# -- the SSM + hybrid families ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("chunk, with_h0", [(8, False), (16, True),
                                            (64, False)])
def test_ssd_chunked_card_equal_cpu(no_tf32, chunk, with_h0):
    """The chunked SSD scan on the card within rtol 1e-4 / atol 1e-5 of the
    CPU, y and the final state, and within 1e-4 of the O(S^2) oracle."""
    from repro_torch.models import ssm

    rng = np.random.default_rng(20)
    B, S, H, P, N = 2, 64, 3, 4, 5
    xd = torch.as_tensor(rng.normal(size=(B, S, H, P)).astype(np.float32))
    a = torch.as_tensor(-rng.uniform(0.01, 0.6, size=(B, S, H))
                        .astype(np.float32))
    Bm, Cm = (torch.as_tensor(rng.normal(size=(B, S, N)).astype(np.float32))
              for _ in range(2))
    h0 = (torch.as_tensor(rng.normal(size=(B, H, P, N)).astype(np.float32))
          if with_h0 else None)
    out = {}
    for dev in (no_tf32, torch.device("cpu")):
        args = [t.to(dev) for t in (xd, a, Bm, Cm)]
        out[dev.type] = ssm.ssd_chunked(*args, chunk,
                                        None if h0 is None else h0.to(dev))
        if dev.type == "cuda" and h0 is None:
            torch.testing.assert_close(out["cuda"][0],
                                       ssm.ssd_reference(*args),
                                       rtol=1e-4, atol=1e-4)
    for c, h in zip(out["cuda"], out["cpu"]):
        assert c.is_cuda
        torch.testing.assert_close(c.cpu(), h, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 17, 48])
def test_mamba2_forward_and_decode_card_equal_cpu(no_tf32, S):
    """The Mamba2 mixer on the card against the CPU from one set of
    params: the full sequence with its new cache (S = 2: the conv tail
    padded; 17: chunk 1), then one decode step from that cache; out and
    the states within rtol 1e-4 / atol 1e-5."""
    from repro_torch.kernels.ops import tree_map
    from repro_torch.models import ssm

    cfg, p = _smoke_params("mamba2-370m", ssm.init_mamba2)
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.normal(size=(2, S + 1, cfg.d_model))
                        .astype(np.float32))
    out = {}
    for dev in (no_tf32, torch.device("cpu")):
        q = tree_map(lambda t: t.to(dev), p)
        y, cache = ssm.mamba2_forward(q, x[:, :S].to(dev), cfg, cache={})
        d, cache2 = ssm.mamba2_decode_step(q, x[:, S:].to(dev), cfg, cache)
        out[dev.type] = [y, d, cache["h"], cache["conv"], cache2["h"],
                         cache2["conv"]]
    for c, h in zip(out["cuda"], out["cpu"]):
        assert c.is_cuda
        torch.testing.assert_close(c.cpu(), h, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uncached", "prefill", "decode"])
def test_zamba_shared_block_card_equal_cpu(no_tf32, mode):
    """Zamba2's shared block on (x, x0) on the card within rtol 1e-4 /
    atol 1e-5 of the CPU: without a cache, prefilled at 0, decoding at 6;
    the new K/V too."""
    from repro_torch.kernels.ops import tree_map
    from repro_torch.models import blocks

    cfg, p = _smoke_params("zamba2-2.7b", blocks.init_zamba_shared)
    S, pos = {"uncached": (7, 0), "prefill": (7, 0), "decode": (1, 6)}[mode]
    rng = np.random.default_rng(22)
    x, x0 = (torch.as_tensor(rng.normal(size=(2, S, cfg.d_model))
                             .astype(np.float32)) for _ in range(2))
    cache = None if mode == "uncached" else {
        k: torch.as_tensor(rng.normal(size=(2, 10, cfg.n_kv_heads, cfg.hd()))
                           .astype(np.float32)) for k in ("k", "v")}
    out = {}
    for dev in (no_tf32, torch.device("cpu")):
        c = None if cache is None else tree_map(lambda t: t.to(dev), cache)
        out[dev.type] = blocks.zamba_shared_block(
            tree_map(lambda t: t.to(dev), p), x.to(dev), x0.to(dev), cfg,
            torch.arange(S, device=dev) + pos, cache=c,
            pos=None if cache is None else pos)
    (yc, cc), (yh, ch) = out["cuda"], out["cpu"]
    torch.testing.assert_close(yc.cpu(), yh, rtol=1e-4, atol=1e-5)
    if cache is not None:
        for k in ("k", "v"):
            torch.testing.assert_close(cc[k].cpu(), ch[k], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_lm_loss_grads_and_decode_card_equal_cpu(no_tf32, arch):
    """A smoke-config ``DecoderLM`` of the SSM (mamba2) and the hybrid
    (zamba2) family on the card against the CPU from one set of params:
    the loss and every grad (remat on, as the config sets it) within rtol
    1e-4 / atol 1e-5; then a prefill into a cache and one decode step, the
    logits and every cache leaf likewise, and the decode within the
    reference's 2e-3 of the full forward on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import tree_leaves, tree_map
    from repro_torch.models.lm import DecoderLM

    lm = DecoderLM(get_config(arch, smoke=True))
    assert lm.cfg.remat
    params = lm.init(torch.Generator().manual_seed(0))
    tok, tgt = _lm_batch(lm.cfg.vocab_size)
    out = {}
    for dev in (no_tf32, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        loss, _ = lm.loss(p, {"tokens": torch.as_tensor(tok, device=dev),
                              "targets": torch.as_tensor(tgt, device=dev)})
        loss.backward()
        t = torch.as_tensor(tok, device=dev)
        with torch.no_grad():
            full, _, _ = lm.apply(p, {"tokens": t[:, :12]})
            _, caches, _ = lm.apply(p, {"tokens": t[:, :11]},
                                    make_cache=True, cache_len=13)
            dec, caches = lm.decode_step(p, caches, t[:, 11:12], 11)
        out[dev.type] = [loss.detach()] + [x.grad for x in tree_leaves(p)] \
            + [dec] + tree_leaves(caches)
        if dev.type == "cuda":
            torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3,
                                       atol=2e-3)
    assert len(out["cuda"]) == len(out["cpu"])
    for c, h in zip(out["cuda"], out["cpu"]):
        assert c.is_cuda
        torch.testing.assert_close(c.cpu(), h, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_xattn_lm_loss_grads_and_decode_card_equal_cpu(no_tf32, arch):
    """A smoke-config model of the VLM (``DecoderLM``, its gates set to 0.5:
    drawn as zeros they hide cross attention) and of the enc-dec
    (``EncDecLM``) on the card against the CPU from one set of params and
    one set of seeded patches or frames: the loss and every grad (remat on)
    within rtol 1e-4 / atol 1e-5; then a prefill into a cache and one
    decode step, the logits and every cache leaf (the cross K/V among
    them) likewise, and the decode within the reference's 2e-3 of the
    full forward on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import tree_leaves, tree_map
    from repro_torch.models import build_model

    lm = build_model(get_config(arch, smoke=True))
    assert lm.cfg.remat
    params = lm.init(torch.Generator().manual_seed(0))
    if lm.cfg.family == "vlm":
        params["layers"]["cross"]["xattn"]["gate"].fill_(0.5)
    tok, tgt = _lm_batch(lm.cfg.vocab_size)
    gen = torch.Generator().manual_seed(2)
    memory = ({"patches": torch.randn(2, lm.cfg.n_patches, lm.cfg.d_model,
                                      generator=gen)}
              if lm.cfg.family == "vlm" else
              {"frames": torch.randn(2, 9, lm.cfg.d_model, generator=gen)})
    out = {}
    for dev in (no_tf32, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        mem = {k: v.to(dev) for k, v in memory.items()}
        loss, _ = lm.loss(p, {"tokens": torch.as_tensor(tok, device=dev),
                              "targets": torch.as_tensor(tgt, device=dev),
                              **mem})
        loss.backward()
        t = torch.as_tensor(tok, device=dev)
        with torch.no_grad():
            full, _, _ = lm.apply(p, {"tokens": t[:, :12], **mem})
            _, caches, _ = lm.apply(p, {"tokens": t[:, :11], **mem},
                                    make_cache=True, cache_len=13)
            dec, caches = lm.decode_step(p, caches, t[:, 11:12], 11)
        out[dev.type] = [loss.detach()] + [x.grad for x in tree_leaves(p)] \
            + [dec] + tree_leaves(caches)
        if dev.type == "cuda":
            torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3,
                                       atol=2e-3)
    assert len(out["cuda"]) == len(out["cpu"])
    for c, h in zip(out["cuda"], out["cpu"]):
        assert c.is_cuda
        torch.testing.assert_close(c.cpu(), h, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_momentum_cohort_step_on_the_card_matches_the_cpu(card):
    """``build_optimizer("momentum")``'s cohort step (plain torch, no
    kernel) on [64, 4096] rows, lanes of 0 to 3 steps: params and ``m``
    equal to the CPU's (elementwise mul and add in the same order: bit
    for bit, or within rtol 1e-6); a lane of 0 steps untouched."""
    from repro_torch.optim import build_optimizer

    gen = torch.Generator(device=card).manual_seed(0)
    steps = torch.arange(64, dtype=torch.int32) % 4
    flat = torch.randn(64, 4096, device=card, generator=gen)
    flat0, cpu = flat.clone(), flat.cpu()
    opt = build_optimizer("momentum", 1e-2)
    st, st_cpu = opt.cohort_init(flat), opt.cohort_init(cpu)
    for s in range(3):
        g = torch.randn(64, 4096, device=card, generator=gen)
        opt.cohort_step(flat, st, g, steps.to(card), s)
        opt.cohort_step(cpu, st_cpu, g.cpu(), steps, s)
    torch.testing.assert_close(flat.cpu(), cpu, rtol=1e-6, atol=0)
    torch.testing.assert_close(st["m"].cpu(), st_cpu["m"], rtol=1e-6, atol=0)
    idle = steps.to(card) == 0
    assert torch.equal(flat[idle], flat0[idle])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "flround"])
def test_a_cells_flops_on_the_card_equal_its_meta_trace(card, kind):
    """Each cell kind at qwen3-1.7b's smoke config: the FLOPs the card run
    counts under ``FlopCounterMode`` equal the ``meta`` trace's exactly
    (the same ops on the same shapes), and the train step launches
    ``fused_adam`` once, where the meta trace reported its traffic."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.launch.steps import build_cell

    smoke = get_config("qwen3-1.7b", smoke=True)
    ov = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
          if f.name != "name"}
    seq, batch = (0, 3) if kind == "flround" else (16, 2)
    cell = build_cell("qwen3-1.7b", ShapeConfig("x", seq, batch, kind),
                      make_card_mesh(), overrides=ov)
    meta = cell.trace()
    args = cell.make_args(card, seed=1)
    fa.fused_adam.launches = 0
    with FlopCounterMode(display=False) as counter:
        cell.fn(*args)
    torch.cuda.synchronize(card)
    assert counter.get_total_flops() == meta.flops
    want = 1 if kind == "train" else 0
    assert fa.fused_adam.launches == want
    assert meta.kernels.get("fused_adam", {"launches": 0})["launches"] \
        == want
