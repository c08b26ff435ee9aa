"""Port cohort trainer + update store vs the reference's, on one cohort.

The two packages draw minibatch indices from different RNGs, so the port
replays the reference's draws through its ``batch_indices`` hook
(``JaxBatchIndices``). Trained rows compare at rtol 1e-4 / atol 1e-5: the
conv reductions run in another order in the two frameworks."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.client import CohortTrainer as JaxTrainer
from repro.core.data_plane import DatasetStore as JaxDatasetStore
from repro.core.update_store import UpdateStore as JaxUpdateStore
from repro.data.synthetic import make_federated_dataset
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch.core.client import CohortTrainer
from repro_torch.core.data_plane import DatasetStore
from repro_torch.core.update_store import UpdateStore
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.proxy_models import ProxyCNN

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread for the test: under pytest-xdist each
    worker's OpenMP pool spins on every core, and six such pools on eight
    cores slow a CPU-bound test some hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxBatchIndices:
    """The reference trainer's minibatch draws as an index table: per
    cohort ``key, sub = split(key); keys = split(sub, Kp)`` (its
    ``_cohort_keys``), then per lane and step ``key, k = split(key);
    randint(k, (B,), 0, max(n_i, 1))`` (its local-training scan)."""

    def __init__(self, seed: int, batch_size: int):
        self.key = jax.random.PRNGKey(seed)
        self.batch_size = batch_size

    def __call__(self, Kp, max_steps, n_i):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, Kp)
        B = self.batch_size

        def lane(key, n):
            def body(key, _):
                key, k = jax.random.split(key)
                return key, jax.random.randint(k, (B,), 0, jnp.maximum(n, 1))
            return jax.lax.scan(body, key, None, length=max_steps)[1]

        n = jnp.asarray(n_i.cpu().numpy().astype(np.int32))
        idx = jax.jit(jax.vmap(lane))(keys, n)
        return torch.as_tensor(np.array(idx), dtype=torch.int64,
                               device=n_i.device)


@pytest.fixture(scope="module")
def data():
    return make_federated_dataset("mnist", n_clients=6, scale=0.05, seed=0)


def test_train_cohort_indexed_into_store_matches_reference(data):
    jmodel, model = JaxProxyCNN(10), ProxyCNN(10)
    jparams = jmodel.init(jax.random.PRNGKey(3))[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    selection = [4, 1, 2]                      # K=3 -> Kp=4 (one pad lane)
    n_i = data.n[selection]
    steps = np.array([3, 7, 5], np.int64)      # ragged step budgets
    kw = dict(optimizer="adam", lr=1e-3, batch_size=5, prox_mu=0.01, seed=7)

    jt = JaxTrainer(jmodel, **kw)
    jstore = JaxUpdateStore(int(sum(np.size(l) for l in
                                    jax.tree.leaves(jparams))), capacity=2)
    jids, _, jloss = jt.train_cohort_indexed(
        jparams, JaxDatasetStore(data), selection, n_i, steps,
        update_sink=jstore)

    t = CohortTrainer(model, device="cpu", batch_indices=JaxBatchIndices(7, 5),
                      **kw)
    store = UpdateStore(jstore.n_params, capacity=2, device="cpu")
    ids, _, loss = t.train_cohort_indexed(
        params, DatasetStore(data, device="cpu"), selection, n_i, steps,
        update_sink=store)

    np.testing.assert_array_equal(ids, np.asarray(jids))
    assert store._free == jstore._free            # pad row freed, same order
    assert store.capacity == jstore.capacity
    assert store.row_width == jstore.row_width
    assert sorted(store._live) == sorted(jstore._live) == sorted(ids.tolist())
    np.testing.assert_allclose(store.gather(ids).numpy(),
                               np.asarray(jstore.gather(jids)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, np.asarray(jloss), rtol=RTOL, atol=ATOL)


def test_update_store_allocator_matches_reference():
    a, b = UpdateStore(1500, capacity=3, device="cpu"), JaxUpdateStore(1500, capacity=3)
    assert (a.row_width, a.capacity) == (b.row_width, b.capacity) == (2048, 8)
    rng = np.random.default_rng(0)
    for k in (5, 6, 2, 9):
        ia, ib = a.alloc(k), b.alloc(k)
        np.testing.assert_array_equal(ia, np.asarray(ib))
        drop = rng.choice(ia, size=k // 2, replace=False)
        a.free(drop)
        b.free(drop)
        assert a._free == b._free and a.capacity == b.capacity
    rows = rng.normal(size=(3, 1500)).astype(np.float32)
    ia, ib = a.put(torch.as_tensor(rows)), b.put(jnp.asarray(rows))
    np.testing.assert_array_equal(ia, np.asarray(ib))
    np.testing.assert_array_equal(a.gather(ia).numpy(), np.asarray(b.gather(ib)))
