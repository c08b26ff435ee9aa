"""The port's ravel contract and row aggregation against the reference's
``repro.kernels.ops`` / ``repro.core.aggregation`` (Pallas in interpret
mode), at rtol 1e-5 / atol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import aggregation as jagg
from repro.kernels import ops as jops
from repro.models.paper_models import MnistCNN as JaxMnistCNN
from repro_torch.core import aggregation
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_numpy, params_to_numpy

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def mnist_params():
    jparams = JaxMnistCNN().init(jax.random.PRNGKey(0))[0]
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_ravel_spec_order_and_offsets_match_reference(mnist_params):
    jparams, params = mnist_params
    jspec, spec = jops.RavelSpec(jparams), ops.RavelSpec(params)
    assert [k for k in sorted(params)] == ["c1_b", "c1_w", "c2_b", "c2_w",
                                           "fc1_b", "fc1_w", "fc2_b", "fc2_w"]
    assert spec.shapes == jspec.shapes
    assert spec.sizes == jspec.sizes
    assert spec.offsets == tuple(np.cumsum((0,) + jspec.sizes[:-1]).tolist())
    assert spec.n_params == jspec.n_params == 582_026
    flat = spec.ravel(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jspec.ravel(jparams)))
    back = params_to_numpy(spec.unravel(flat))
    for name, leaf in jparams.items():
        np.testing.assert_array_equal(back[name], np.asarray(leaf))


def test_unravel_stacked_views_write_through():
    spec = ops.RavelSpec({"b": torch.zeros(3), "a": torch.zeros(2, 2)})
    rows = torch.zeros(4, 8)
    tree = spec.unravel_stacked(rows)
    assert tree["a"].shape == (4, 2, 2) and tree["b"].shape == (4, 3)
    tree["b"][1] += 1.0                 # "a" comes first: b starts at col 4
    rows[2, 0] = 5.0
    assert rows[1, 4:7].tolist() == [1.0, 1.0, 1.0]
    assert tree["a"][2, 0, 0] == 5.0
    np.testing.assert_array_equal(spec.ravel_stacked(tree).numpy(),
                                  rows[:, :7].numpy())


def _buffer(rng, c, w):
    return rng.normal(size=(c, w)).astype(np.float32)


@pytest.mark.parametrize("c, k", [(16, 5), (16, 8), (24, 11)])
def test_aggregate_rows_sweep_and_gather_match_reference(c, k):
    """K pads to a multiple of 8 with zero-weight repeats of row 0; rows
    the set does not name enter the sweep at weight 0."""
    rng = np.random.default_rng(c * k)
    buf = _buffer(rng, c, 2048)
    idx = rng.choice(c, size=k, replace=False)
    w = rng.random(k).astype(np.float32)
    w /= w.sum()
    tb = torch.as_tensor(buf)
    sweep = ops.aggregate_rows(tb, idx, w).numpy()
    gather = ops.aggregate_rows_gather(tb, idx, w).numpy()
    want = np.asarray(jops.aggregate_rows(jnp.asarray(buf), idx, w,
                                          interpret=True))
    np.testing.assert_allclose(sweep, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gather, np.asarray(jops.aggregate_rows_gather(
        jnp.asarray(buf), idx, w)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gather, sweep, rtol=RTOL, atol=ATOL)


def test_aggregate_rows_pads_a_ragged_width():
    rng = np.random.default_rng(1)
    buf = _buffer(rng, 8, 1030)          # not a multiple of the vector width
    idx, w = np.array([1, 6]), np.array([0.25, 0.75], np.float32)
    got = ops.aggregate_rows(torch.as_tensor(buf), idx, w).numpy()
    assert got.shape == (1030,)
    np.testing.assert_allclose(got, w @ buf[idx], rtol=RTOL, atol=ATOL)


def _spec_and_store_rows(rng, c):
    tree = {"a": np.zeros(1000, np.float32), "b": np.zeros((4, 6), np.float32)}
    spec, jspec = ops.RavelSpec(tree), jops.RavelSpec(tree)
    buf = _buffer(rng, c, 1024)
    return spec, jspec, buf


def test_finiteness_guard_recomputes_over_the_referenced_rows():
    """A freed row full of NaN enters the sweep at weight 0 (0 * nan = nan):
    the guard sees the non-finite result and recomputes through the gather
    route, as the reference does (tests/test_update_plane.py)."""
    rng = np.random.default_rng(7)
    spec, jspec, buf = _spec_and_store_rows(rng, 16)
    buf[5] = np.nan                      # freed, never overwritten
    rows, w = [0, 3, 9], np.array([0.5, 0.3, 0.2], np.float32)
    before = aggregation.guard_recomputes()
    got = aggregation.weighted_aggregate_rows(torch.as_tensor(buf), rows, w,
                                              spec)
    assert aggregation.last_path() == "sweep"
    assert aggregation.guard_recomputes() == before + 1
    want = jagg.weighted_aggregate_rows(jnp.asarray(buf), rows, w, jspec)
    for name in ("a", "b"):
        assert np.isfinite(got[name].numpy()).all()
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(spec.ravel(got).numpy(),
                               (w @ buf[rows])[:spec.n_params],
                               rtol=RTOL, atol=ATOL)


def test_sparse_reference_sets_take_the_gather_route():
    """Once the set is a small share of a grown buffer (capacity >= 4 *
    max(K, 8)), only the K rows are read, as in the reference."""
    rng = np.random.default_rng(3)
    spec, jspec, buf = _spec_and_store_rows(rng, 64)
    buf[40] = np.inf                     # never read by the gather route
    rows, w = [2, 17, 33], np.array([0.2, 0.3, 0.5], np.float32)
    before = aggregation.guard_recomputes()
    got = aggregation.weighted_aggregate_rows(torch.as_tensor(buf), rows, w,
                                              spec)
    assert aggregation.last_path() == "gather"
    assert aggregation.guard_recomputes() == before
    want = jagg.weighted_aggregate_rows(jnp.asarray(buf), rows, w, jspec)
    for name in ("a", "b"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL)


def test_staleness_weights_match_reference():
    args = ([3, 2, 2, 0], [30, 10, 25, 7], 3)
    for fn in ("eq1", "eq2"):
        np.testing.assert_array_equal(aggregation.staleness_weights(*args, fn),
                                      jagg.staleness_weights(*args, fn))
