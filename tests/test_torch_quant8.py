"""The port's int8 update compression against the reference's.

The plain ``quantize_q8`` (what a CPU tensor takes) is held to the
reference's entry point ``repro.kernels.ops.quantize_q8`` with the Pallas
kernel in interpret mode: codes and scales equal to the bit. Against the
oracle ``repro.kernels.ref.quantize_q8`` the codes are equal and the scales
within rtol 1e-6: the oracle divides by 127 where the entry point multiplies
by the fp32 reciprocal, one ulp apart in a few percent of blocks.
``compress_update`` / ``decompress_update`` follow the reference's to the
bit over three rounds of error feedback; ``compress_q8``, the one fused
step they run, equals the stepwise composition it replaces to the bit. The
CUDA kernels run only on a card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold them against the plain versions."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.paper_models import MnistCNN as JaxMnistCNN
from repro_torch.kernels import ops, quant8, ref
from repro_torch.models.convert import params_from_numpy


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _quantize_both(x: np.ndarray):
    q, s = quant8.quantize_q8(torch.as_tensor(x))
    jq, js = jops.quantize_q8(jnp.asarray(x), interpret=True)
    return q.numpy(), s.numpy(), np.asarray(jq), np.asarray(js)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2048, 2049, 5000, 582026])
def test_quantize_plain_equals_the_reference_entry_point(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    q, s, jq, js = _quantize_both(x)
    assert q.dtype == np.int8 and q.shape == (n,)
    assert s.shape == (-(-n // 256),)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(_bits(s), _bits(js))
    # the oracle takes whole blocks: zero-pad, then trim
    pad = jnp.pad(jnp.asarray(x), (0, (-n) % 256))
    rq, rs = jref.quantize_q8(pad)
    np.testing.assert_array_equal(q, np.asarray(rq)[:n])
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-6, atol=0)


def test_the_reference_disagrees_with_itself_on_the_scale():
    """``ops.quantize_q8`` scales by ``maxabs * float32(1/127)``, the oracle
    by ``maxabs / 127``: some blocks differ by one ulp, none by more, and the
    codes agree. The port follows the entry point."""
    x = (np.random.default_rng(0).standard_normal(256 * 2048) * 3.0
         ).astype(np.float32)
    _, s, _, js = _quantize_both(x)
    _, rs = jref.quantize_q8(jnp.asarray(x))
    ulps = np.abs(_bits(js) - _bits(rs))
    assert ulps.max() == 1 and 0 < (ulps == 1).sum() < len(ulps) // 10
    np.testing.assert_array_equal(_bits(s), _bits(js))


def test_quantize_nonfinite_blocks_and_negative_zero():
    """A block holding a NaN gets a NaN scale, one holding an inf an inf
    scale; every code of either block is 0. -0 quantizes to 0, and an
    all-zero block takes the 1e-12 floor."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(8 * 256) * 2.0).astype(np.float32)
    x[5] = np.nan
    x[256 + 7] = np.inf
    x[512 + 9] = -np.inf
    x[768:1024] = 0.0
    x[768 + 3] = -0.0
    x[1024 + 11] = -0.0
    q, s, jq, js = _quantize_both(x)
    np.testing.assert_array_equal(q, jq)
    assert np.isnan(s[0]) and np.isnan(js[0])
    assert s[1] == js[1] == np.inf and s[2] == js[2] == np.inf
    assert (q[:768] == 0).all()
    np.testing.assert_array_equal(_bits(s[3:]), _bits(js[3:]))
    assert s[3] == np.float32(1e-12) and q[1024 + 11] == 0


@pytest.mark.parametrize("dtype, jdtype", [(torch.float32, jnp.float32),
                                           (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("n, n_scales", [(5000, 20), (5000, 24), (2048, 8),
                                         (300, 1)])
def test_dequantize_plain_equals_the_reference(dtype, jdtype, n, n_scales):
    """fp32 or bf16 out, to the bit; scales short of the block count take
    1.0, longer ones up to the padded count are ignored, as the
    reference pads and trims."""
    rng = np.random.default_rng(n + n_scales)
    q = rng.integers(-127, 128, n).astype(np.int8)
    s = (rng.random(n_scales) * 0.1).astype(np.float32)
    got = quant8.dequantize_q8(torch.as_tensor(q), torch.as_tensor(s),
                               dtype=dtype)
    want = jops.dequantize_q8(jnp.asarray(q), jnp.asarray(s), dtype=jdtype,
                              interpret=True)
    assert got.dtype == dtype and got.shape == (n,)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quant8_rejects_malformed_input():
    with pytest.raises(ValueError):
        quant8.quantize_q8(torch.zeros(4, 256))
    with pytest.raises(ValueError):     # more scales than padded blocks
        quant8.dequantize_q8(torch.zeros(300, dtype=torch.int8),
                             torch.ones(9))


def test_quant8_wrappers_take_no_plain_fallback_off_the_cpu(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(ref, "quantize_q8", forbidden)
    monkeypatch.setattr(ref, "dequantize_q8", forbidden)
    from repro_torch.kernels import _build
    seen = []
    monkeypatch.setattr(_build, "LISTENERS", [lambda *a: seen.append(a)])
    before = (quant8.quantize_q8.launches, quant8.dequantize_q8.launches)
    # meta tensors (they raised here until the launch slice) take the
    # shape-only path: meta outputs, nothing launched, traffic reported
    q, s = quant8.quantize_q8(torch.zeros(512, device="meta"))
    assert q.is_meta and q.dtype == torch.int8 and s.shape == (2,)
    x = quant8.dequantize_q8(torch.zeros(512, dtype=torch.int8,
                                         device="meta"),
                             torch.ones(2, device="meta"))
    assert x.is_meta and x.shape == (512,) and x.dtype == torch.float32
    assert seen == [("quantize_q8", 2048, 512 + 8),
                    ("dequantize_q8", 512 + 8, 2048)]
    assert (quant8.quantize_q8.launches,
            quant8.dequantize_q8.launches) == before


# ----------------------------------------------------------------- compress
@pytest.fixture(scope="module")
def mnist_update():
    """An MnistCNN-shaped update (582,026 params): the difference of two
    reference initialisations, as numpy."""
    p0, p1 = (jax.tree.map(np.asarray,
                           JaxMnistCNN().init(jax.random.PRNGKey(i))[0])
              for i in (0, 1))
    return {k: (p1[k] - p0[k]).astype(np.float32) for k in p0}


def test_compress_update_matches_the_reference_over_three_rounds(mnist_update):
    upd = params_from_numpy(mnist_update, "cpu")
    jupd = jax.tree.map(jnp.asarray, mnist_update)
    err = jerr = None
    for _ in range(3):
        (q, s, spec), err = ops.compress_update(upd, err)
        (jq, js, jspec), jerr = jops.compress_update(jupd, jerr,
                                                     interpret=True)
        assert q.shape == (583_680,) and s.shape == (2_280,)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s), _bits(js))
        np.testing.assert_array_equal(_bits(err), _bits(jerr))
    assert spec.n_params == 582_026
    back = ops.decompress_update(q, s, spec)
    jback = jops.decompress_update(jq, js, jspec, interpret=True)
    for name, leaf in jback.items():
        assert back[name].shape == leaf.shape
        np.testing.assert_array_equal(_bits(back[name]), _bits(leaf))
    # error feedback is exact: what was sent plus what is carried is the
    # update plus the carried error of the round before
    flat = spec.ravel(upd)
    (q2, s2, _), err2 = ops.compress_update(upd, err)
    sent = ops.dequantize_q8(q2, s2)[:spec.n_params]
    torch.testing.assert_close(sent + err2, flat + err, rtol=0, atol=1e-6)


def test_compress_update_restores_leaf_dtypes():
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((300, 7)).astype(np.float32),
            "b": rng.standard_normal(13).astype(np.float32)}
    upd = params_from_numpy(tree, "cpu")
    upd["b"] = upd["b"].to(torch.bfloat16)
    jupd = {"w": jnp.asarray(tree["w"]),
            "b": jnp.asarray(tree["b"]).astype(jnp.bfloat16)}
    (q, s, spec), err = ops.compress_update(upd)
    (jq, js, jspec), jerr = jops.compress_update(jupd, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(err), _bits(jerr))
    back = ops.decompress_update(q, s, spec)
    jback = jops.decompress_update(jq, js, jspec, interpret=True)
    assert back["b"].dtype == torch.bfloat16 and back["w"].shape == (300, 7)
    for name in tree:
        np.testing.assert_array_equal(back[name].float().numpy(),
                                      np.asarray(jback[name], np.float32))


# ------------------------------------------------------- the fused step
def _small_tree(seed=3):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((300, 70)) * 0.01).astype(np.float32),
            "b": rng.standard_normal(13).astype(np.float32)}


def test_plain_compress_q8_matches_the_reference_over_three_rounds():
    """``ref.compress_q8`` on the raveled update, the error carried,
    against the reference's ``ops.compress_update`` (Pallas in interpret
    mode): codes, scales and error to the bit, each round."""
    tree = _small_tree()
    upd = params_from_numpy(tree, "cpu")
    jupd = jax.tree.map(jnp.asarray, tree)
    flat = ops.RavelSpec(upd).ravel(upd)
    n_pad = 11 * 2048                      # 21,013 params
    err = jerr = None
    for _ in range(3):
        q, s, err = ref.compress_q8(flat, err, n_pad)
        (jq, js, _), jerr = jops.compress_update(jupd, jerr, interpret=True)
        assert q.shape == (n_pad,) and s.shape == (n_pad // 256,)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s), _bits(js))
        np.testing.assert_array_equal(_bits(err), _bits(jerr))


def _stepwise(flat, ef, n_pad):
    """The composition ``ops.compress_update`` ran before it was one step:
    add, pad, ``quantize_q8``, ``dequantize_q8``, slice, subtract."""
    N = flat.shape[0]
    v = flat if ef is None else flat + ef
    q, s = quant8.quantize_q8(F.pad(v, (0, n_pad - N)))
    return q, s, v - quant8.dequantize_q8(q, s)[:N]


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("n", [1, 255, 257, 2047, 2049, 582_026])
def test_compress_q8_equals_the_stepwise_composition(n, with_ef, planted):
    """``compress_q8`` (and its plain version) against the stepwise
    composition, codes, scales and error to the bit, at lengths around
    the block and the 2048 padding, with and without error feedback, and
    with a NaN block (block 0) and an inf block (block 1, where N > 256):
    their codes 0, their scales NaN / inf, their errors NaN."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor((rng.standard_normal(n) * 0.02).astype(np.float32))
    ef = (torch.as_tensor((rng.standard_normal(n) * 1e-4).astype(np.float32))
          if with_ef else None)
    if planted:
        x[0] = float("nan")
        if n > 256:
            x[256] = float("inf")
    n_pad = n + (-n) % 2048
    want = _stepwise(x, ef, n_pad)
    for got in (quant8.compress_q8(x, ef, n_pad),
                ref.compress_q8(x, ef, n_pad)):
        assert [t.shape for t in got] == [(n_pad,), (n_pad // 256,), (n,)]
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    q, s, err = want
    if n_pad - n >= 256:                        # an all-padding block
        assert float(s[-1]) == ref.fp32(1e-12)
    if planted:
        assert bool(torch.isnan(s[0])) and not bool(q[:256].any())
        assert bool(torch.isnan(err[:min(n, 256)]).all())
        if n > 256:
            assert float(s[1]) == float("inf") and not bool(q[256:512].any())
            assert bool(torch.isnan(err[256:min(n, 512)]).all())


def test_a_single_rounding_of_the_error_differs_from_the_reference():
    """Why the card kernel computes the error as ``__fsub_rn(v,
    __fmul_rn(q, scale))``: the reference rounds ``q * scale`` to fp32
    (its dequantize) and then ``v - deq``; one FMA rounds ``v - q * scale``
    once. Emulated here in float64 (``q * scale`` and the difference are
    exact there, then one rounding to fp32), that single rounding differs
    from the reference's error on seeded inputs."""
    rng = np.random.default_rng(11)
    v = torch.as_tensor((rng.standard_normal(1 << 16) * 0.01
                         ).astype(np.float32))
    q, s, err = ref.compress_q8(v, None, v.shape[0])
    step = s.repeat_interleave(256)
    two_roundings = v - q.to(torch.float32) * step
    one_rounding = (v.double() - q.double() * step.double()).float()
    np.testing.assert_array_equal(_bits(err), _bits(two_roundings))
    differ = int((_bits(one_rounding) != _bits(err)).sum())
    assert differ > 0, "a fused multiply-subtract would give the same bits"


def test_compress_q8_rejects_malformed_input_and_takes_no_fallback(
        monkeypatch):
    x = torch.zeros(300)
    for bad in (lambda: quant8.compress_q8(x, None, 300),     # not 256k
                lambda: quant8.compress_q8(x, None, 256),     # short
                lambda: quant8.compress_q8(x, torch.zeros(299), 512),
                lambda: quant8.compress_q8(torch.zeros(2, 150), None, 512)):
        with pytest.raises(ValueError):
            bad()

    def forbidden(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(ref, "compress_q8", forbidden)
    before = quant8.compress_q8.launches
    # a meta tensor (it raised here until the launch slice) takes the
    # shape-only path: meta outputs of the kernel's shapes, no launch
    q, s, err = quant8.compress_q8(torch.zeros(300, device="meta"), None,
                                   512)
    assert (q.shape, s.shape, err.shape) == ((512,), (2,), (300,))
    assert q.is_meta and s.is_meta and err.is_meta
    assert quant8.compress_q8.launches == before
