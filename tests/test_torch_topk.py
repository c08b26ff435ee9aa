"""The port's top-k selection (``kernels.ref`` / ``kernels.topk`` plain
route, ``kernels.ops.masked_topk`` / ``scored_topk``,
``FleetStore.select_topk``) against the reference's.

The port follows ``lax.top_k`` exactly: descending values in its total
order on fp32 (NaN above +inf, -NaN below -inf, -0 below +0), equal values
by ascending index, no index twice. Indices and values must be equal to
the bit, not allclose. Inputs are made with numpy from a seed and handed
to both packages."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core.fleet_store import FleetStore as JaxFleetStore
from repro.kernels import ops as jops
from repro.kernels.topk import block_topk as jax_block_topk
from repro_torch.core.fleet_store import FleetStore
from repro_torch.kernels import ops, ref, topk
from repro_torch.kernels.ref import chosen_mask
from repro_torch.kernels.topk import BLOCK_TOPK, block_topk

import torch


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _masked_inputs():
    masked = np.full(2048, -np.inf, np.float32)
    masked[[5, 900, 1999]] = [3.0, 1.0, 2.0]
    ties = np.zeros(4096, np.float32)
    ties[[7, 2000, 3000]] = 1.0
    return {"masked": (masked, 8, BLOCK_TOPK), "ties": (ties, 3, BLOCK_TOPK)}


def _cases():
    out = {}
    for m, k, block in [(64, 5, 32), (1024, 1, 256), (3000, 17, 1024),
                        (4096, 100, 1024)]:
        rng = np.random.default_rng(m * 100 + k)
        out[f"{m}-{k}-{block}"] = (rng.normal(size=m).astype(np.float32), k,
                                   block)
    out.update(_masked_inputs())
    return out


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_masked_topk_matches_reference_xla_and_pallas(name):
    s, k, block = CASES[name]
    v_x, i_x = jops.masked_topk(jnp.asarray(s), k, path="xla")
    v_p, i_p = jops.masked_topk(jnp.asarray(s), k, path="pallas",
                                interpret=True, block=block)
    # where a block holds fewer than k finite scores ("masked"), the Pallas
    # route repeats an index in its -inf slots; those slots are compared
    # with the xla route only
    finite = np.isfinite(np.asarray(v_x))
    for v, i in (ref.masked_topk(torch.as_tensor(s), k),
                 ops.masked_topk(torch.as_tensor(s), k)):
        assert i.dtype == torch.int64 and v.dtype == torch.float32
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_x))
        _bits_equal(v.numpy(), v_x)
        _bits_equal(v.numpy(), v_p)
        np.testing.assert_array_equal(i.numpy()[finite],
                                      np.asarray(i_p)[finite])
        if name != "masked":
            np.testing.assert_array_equal(i.numpy(), np.asarray(i_p))


@pytest.mark.parametrize("m, k, block", [(4096, 100, 1024), (3072, 17, 1024),
                                         (64, 5, 32)])
def test_block_topk_plain_matches_pallas_candidates(m, k, block):
    """Per-block candidates, values and global indices, equal the Pallas
    kernel's wherever every block holds at least k finite scores (where it
    holds fewer, the Pallas kernel repeats an index; see below)."""
    rng = np.random.default_rng(m + k)
    s = rng.normal(size=m).astype(np.float32)
    s[rng.choice(m, m // 8, replace=False)] = 0.5      # ties inside blocks
    v_ref, i_ref = jax_block_topk(jnp.asarray(s), k, block=block,
                                  interpret=True)
    v, i = block_topk(torch.as_tensor(s), k, block)
    assert tuple(v.shape) == tuple(i.shape) == (m // block, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _bits_equal(v.numpy(), v_ref)


def test_fewer_finite_scores_than_k_follow_lax_top_k():
    """A block with fewer finite scores than k: the reference's Pallas
    route re-picks index 0 ([0, 0, 0]) and leaves client 0 unchosen; the
    port returns lax.top_k's [0, 1, 2], distinct indices, 0 chosen."""
    s = np.full(2048, -np.inf, np.float32)
    s[0] = 1.0
    v_x, i_x = jops.masked_topk(jnp.asarray(s), 3, path="xla")
    v, i = ops.masked_topk(torch.as_tensor(s), 3)
    assert i.tolist() == np.asarray(i_x).tolist() == [0, 1, 2]
    _bits_equal(v.numpy(), v_x)
    bv, bi = block_topk(torch.as_tensor(s), 3)
    assert bi.tolist() == [[0, 1, 2], [1024, 1025, 1026]]
    chosen = chosen_mask(i, v > float("-inf"), 2048)
    assert chosen.tolist()[:2] == [True, False]


def test_nan_signed_zero_and_infinities_follow_lax_top_k():
    rng = np.random.default_rng(3)
    s = rng.normal(size=3000).astype(np.float32)
    nan = np.float32(np.nan)
    picks = rng.choice(3000, 60, replace=False)
    s[picks[:10]] = nan
    s[picks[10:20]] = -nan
    s[picks[20:30]] = np.inf
    s[picks[30:40]] = -np.inf
    s[picks[40:50]] = 0.0
    s[picks[50:]] = -0.0
    for k in (5, 40, 100):
        v_x, i_x = jax.lax.top_k(jnp.asarray(s), k)
        v, i = ops.masked_topk(torch.as_tensor(s), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_x))
        _bits_equal(v.numpy(), v_x)
    np.testing.assert_array_equal(
        ref.order_key(torch.as_tensor(np.array([-nan, -np.inf, -0.0, 0.0,
                                                np.inf, nan], np.float32))
                      ).argsort().numpy(), np.arange(6))


def test_k_outside_the_kernel_takes_the_stable_sort():
    """k > 1024 is a stable descending sort on the CPU (lax.top_k's answer
    too) and, on any other device, the sort route ``sorted_topk`` (the
    counterpart of the reference's ``lax.top_k`` route), chosen by k
    alone: counted in ``masked_topk.sorts``, no kernel launch, no raise.
    Every k on a CPU tensor is the plain version, a stable sort of the
    whole vector, which is exact (the card's one launch is pinned in
    ``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(5)
    s = np.round(rng.normal(size=3000), 1).astype(np.float32)   # many ties
    for k in (1500, 600, 1024, 40):
        v_x, i_x = jax.lax.top_k(jnp.asarray(s), k)
        v, i = ops.masked_topk(torch.as_tensor(s), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_x))
        _bits_equal(v.numpy(), v_x)
    calls = []
    real = ref.masked_topk
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "masked_topk",
                   lambda *a: calls.append(a[1:]) or real(*a))
        ops.masked_topk(torch.as_tensor(s), 600)
    assert calls == [(600,)]              # the plain version, once
    sorts, launches = topk.masked_topk.sorts, block_topk.launches
    v, i = ops.masked_topk(torch.empty(3000, device="meta"), 1500)
    assert v.shape == i.shape == (1500,) and v.device.type == "meta"
    meta = [torch.empty(3000, device="meta") for _ in range(3)] + \
        [torch.empty(3000, dtype=torch.bool, device="meta") for _ in range(2)]
    i, valid, boost = ops.scored_topk(*meta, 1.2, 1025)
    assert i.shape == valid.shape == (1025,) and boost.shape == (3000,)
    assert (topk.masked_topk.sorts, block_topk.launches) == (sorts + 2,
                                                             launches)
    with pytest.raises(ValueError):
        ops.masked_topk(torch.as_tensor(s), 3001)
    with pytest.raises(ValueError):
        block_topk(torch.as_tensor(s), 1025, 2048)


SORT_KS = (1025, 4096)


def _special_scores(kind, m, seed):
    """Rounded normals (many ties) with NaN, -NaN, +-inf, +0 and -0
    planted, or all -inf but for a few finite scores."""
    rng = np.random.default_rng(seed)
    if kind == "few_finite":
        s = np.full(m, -np.inf, np.float32)
        s[rng.choice(m, 50, replace=False)] = rng.normal(size=50)
        return s
    s = np.round(rng.normal(size=m), 1).astype(np.float32)
    nan = np.float32(np.nan)
    picks = rng.choice(m, 1200, replace=False).reshape(6, 200)
    for vals, value in zip(picks, (nan, -nan, np.inf, -np.inf, 0.0, -0.0)):
        s[vals] = value
    return s


@pytest.mark.parametrize("kind", ["special", "few_finite"])
@pytest.mark.parametrize("k", SORT_KS)
def test_sort_route_masked_topk_equals_lax_top_k(k, kind):
    """The sort route that a card tensor takes for k > 1024, called
    through its own entry on CPU tensors: values to the bit and indices
    equal ``jax.lax.top_k``'s (the reference's route for such a k), in
    its order -NaN < -inf < -0 < +0 < +inf < +NaN, ties to the lowest
    index, a short finite set filled with the lowest -inf indices."""
    s = _special_scores(kind, 10_000, k)
    v_x, i_x = jax.lax.top_k(jnp.asarray(s), k)
    v_o, i_o = jops.masked_topk(jnp.asarray(s), k)
    before = topk.masked_topk.sorts
    v, i = topk.sorted_topk(torch.as_tensor(s), k)
    assert topk.masked_topk.sorts == before + 1
    assert i.dtype == torch.int64 and v.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_o))
    _bits_equal(v.numpy(), v_x)
    _bits_equal(v.numpy(), v_o)


@pytest.mark.parametrize("k", SORT_KS)
def test_sort_route_scored_topk_equals_the_reference_step(k):
    """The sort route's selection step, through its own entry on CPU
    tensors, against the reference's ``ops.scored_topk`` (which takes
    ``lax.top_k`` for k > 1024): idx, valid and the new booster to the
    bit, with NaN num, NaN den, den = 0, +0 and -0 scores, tied scores,
    and fewer eligible slots than k = 4096 (invalid picks)."""
    m = 6000
    num, den, booster, eligible, ever = _score_state(m, k)
    num[:200], num[200:400] = 0.0, -0.0          # +0 and -0 scores
    num[400:600], den[400:600], booster[400:600] = 1.0, 0.5, 1.5   # ties
    beta = np.float32(1.2)
    ji, jv, jb = jops.scored_topk(*map(jnp.asarray, (num, den, booster,
                                                     eligible, ever)),
                                  beta, k)
    before = topk.masked_topk.sorts
    i, v, b = topk.sorted_scored_topk(*map(torch.as_tensor, (
        num, den, booster, eligible, ever)), beta, k)
    assert topk.masked_topk.sorts == before + 1
    assert i.dtype == torch.int64 and v.dtype == torch.bool
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    _bits_equal(b.numpy(), jb)
    assert int(eligible.sum()) < 4096 and bool(v[-1]) == (k == 1025)


def _score_state(m, seed):
    rng = np.random.default_rng(seed)
    num = rng.random(m).astype(np.float32) * 5
    den = rng.random(m).astype(np.float32)
    den[rng.random(m) < 0.05] = 0.0               # clamped to 1e-12
    num[rng.random(m) < 0.02] = np.nan            # a NaN EMA ranks first
    den[rng.random(m) < 0.02] = np.nan            # and is never valid
    booster = (1.0 + rng.random(m)).astype(np.float32)
    eligible = rng.random(m) < 0.6
    ever = rng.random(m) < 0.9
    return num, den, booster, eligible, ever


@pytest.mark.parametrize("m, k", [(256, 100), (3000, 17), (5000, 200),
                                  (40, 30)])
def test_scored_topk_matches_reference(m, k):
    num, den, booster, eligible, ever = _score_state(m, m + k)
    beta = np.float32(1.2)
    ji, jv, jb = jops.scored_topk(*map(jnp.asarray, (num, den, booster,
                                                     eligible, ever)),
                                  beta, k)
    i, v, b = ops.scored_topk(*map(torch.as_tensor, (num, den, booster,
                                                     eligible, ever)),
                              beta, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    _bits_equal(b.numpy(), jb)


SCORED_CASES = [(m, k) for m in (1, 40, 256, 5000)
                for k in (1, 30, 100, 1024) if k <= m]


@pytest.mark.parametrize("m, k", SCORED_CASES)
def test_plain_and_cpu_route_scored_topk_equal_the_reference(m, k):
    """``ref.scored_topk`` (the plain composition) and the CPU route of
    ``ops.scored_topk`` equal the reference's step to the bit: idx, valid
    and the new booster, with NaN num, NaN den and den = 0 planted."""
    num, den, booster, eligible, ever = _score_state(m, 7 * m + k)
    beta = np.float32(1.2)
    ji, jv, jb = jops.scored_topk(*map(jnp.asarray, (num, den, booster,
                                                     eligible, ever)),
                                  beta, k)
    args = tuple(map(torch.as_tensor, (num, den, booster, eligible, ever)))
    for i, v, b in (ref.scored_topk(*args, beta, k),
                    ops.scored_topk(*args, beta, k)):
        assert i.dtype == torch.int64 and v.dtype == torch.bool
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        _bits_equal(b.numpy(), jb)


def _fleet_pair(n, seed):
    rng = np.random.default_rng(seed)
    card = rng.integers(20, 200, n)
    stores = (JaxFleetStore(), FleetStore(device="cpu"))
    for fs in stores:
        fs.add_batch(list(range(n)), card, 10, 5)
    hist = rng.gamma(2.0, 5.0, size=(n * 7 // 10, 4))   # the rest: never
    for fs in stores:                                    # invoked
        fs.bulk_history(hist)
    return stores, rng


def _advance(stores, sel, rng):
    """Mark the cohort running, then complete most of it and fail some."""
    for cid in sel:
        for fs in stores:
            fs.mark_running(cid, 0)
    for cid in sel:
        u = rng.random()
        d = float(rng.gamma(2.0, 5.0))
        for fs in stores:
            if u < 0.8:
                fs.mark_complete(cid, d)
            elif u < 0.9:
                fs.mark_failed(cid)


def test_fleet_select_topk_matches_reference_over_rounds_and_resume():
    (jfs, fs), rng = _fleet_pair(3000, 11)
    for _ in range(5):
        sel_j = jfs.select_topk(100, 1.2)
        sel = fs.select_topk(100, 1.2)
        assert sel == sel_j and len(sel) == 100
        _bits_equal(fs._dev.booster.numpy(), jfs._dev.booster)
        _advance((jfs, fs), sel, rng)
    # the device-owned booster survives state_dict / from_state
    state = fs.state_dict()
    _bits_equal(state["dev_booster"], jfs.state_dict()["dev_booster"])
    fs2 = FleetStore.from_state(state, device="cpu")
    jfs2 = JaxFleetStore.from_state(jfs.state_dict())
    _bits_equal(fs2._dev.booster.numpy(), fs._dev.booster.numpy())
    for _ in range(2):
        sel = fs2.select_topk(100, 1.2)
        assert sel == jfs2.select_topk(100, 1.2) == fs.select_topk(100, 1.2)
        _bits_equal(fs2._dev.booster.numpy(), jfs2._dev.booster)
        _advance((jfs2, fs2, fs), sel, rng)


def test_fleet_select_topk_quarantine_and_overask_match_reference():
    (jfs, fs), rng = _fleet_pair(40, 2)
    for cid in (3, 5, 8):
        jfs.quarantine(cid, 4)
        fs.quarantine(cid, 4)
    for r in range(3):
        assert fs.select_topk(60, 1.5, now_round=r) == \
            jfs.select_topk(60, 1.5, now_round=r)
    assert FleetStore(device="cpu").select_topk(4, 1.2) == []
