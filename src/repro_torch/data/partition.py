"""Non-IID partitioners (paper IV-A1).

- ``label_shard_partition``: the MNIST scheme — sort by label, cut into
  shards (300 shards x 200 images in the paper), deal shards to clients.
  Produces label skew (1-2 classes per client) with mild cardinality skew.
- ``dirichlet_partition``: Dir(alpha) class mixture per client (standard
  non-IID benchmark scheme; LEAF-like unbalancedness for FEMNIST/Speech).
- ``lognormal_cardinalities``: LEAF-style power-law dataset sizes.
"""
from __future__ import annotations

import numpy as np


def label_shard_partition(labels: np.ndarray, n_clients: int,
                          shards_per_client: int = 2,
                          rng: np.random.Generator | None = None) -> list[np.ndarray]:
    """Returns per-client index arrays."""
    rng = rng or np.random.default_rng(0)
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    shard_ids = rng.permutation(n_shards)
    out = []
    for c in range(n_clients):
        ids = shard_ids[c * shards_per_client:(c + 1) * shards_per_client]
        out.append(np.concatenate([shards[i] for i in ids]))
    return out


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.3,
                        rng: np.random.Generator | None = None,
                        cardinalities: np.ndarray | None = None) -> list[np.ndarray]:
    """Per-client class mixture ~ Dir(alpha); optional target sizes."""
    rng = rng or np.random.default_rng(0)
    n_classes = int(labels.max()) + 1
    by_class = [rng.permutation(np.where(labels == k)[0]) for k in range(n_classes)]
    ptr = np.zeros(n_classes, np.int64)
    if cardinalities is None:
        cardinalities = np.full(n_clients, len(labels) // n_clients)
    out = []
    for c in range(n_clients):
        mix = rng.dirichlet(np.full(n_classes, alpha))
        counts = rng.multinomial(cardinalities[c], mix)
        idx = []
        for k, cnt in enumerate(counts):
            take = by_class[k][ptr[k]:ptr[k] + cnt]
            # wrap around if a class runs dry (sampling with replacement)
            if len(take) < cnt:
                extra = rng.choice(by_class[k], cnt - len(take)) \
                    if len(by_class[k]) else np.array([], np.int64)
                take = np.concatenate([take, extra])
            ptr[k] += cnt
            idx.append(take)
        out.append(np.concatenate(idx) if idx else np.array([], np.int64))
    return out


def lognormal_cardinalities(n_clients: int, mean: int = 200, sigma: float = 0.6,
                            lo: int = 20, hi: int | None = None,
                            rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    raw = rng.lognormal(np.log(mean), sigma, n_clients)
    hi = hi or mean * 6
    return np.clip(raw, lo, hi).astype(np.int64)
