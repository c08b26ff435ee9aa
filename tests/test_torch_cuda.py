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
follows them."""
import pytest
import torch

from repro_torch.kernels import flash_attention as attn
from repro_torch.kernels import fused_adam as fa
from repro_torch.kernels import ops, quant8
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
