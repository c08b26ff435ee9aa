"""Synthetic proxies for the paper's four datasets (offline container —
MNIST/FEMNIST/Shakespeare/Google-Speech are not redistributable here).

Each proxy preserves the statistical shape that drives the paper's system
behaviour: client count, non-IID scheme (label shards / Dirichlet /
power-law cardinalities), and learnability (class prototypes + noise for
the CNNs; per-client-biased Markov chains for the char-LSTM), so
time-to-accuracy curves exhibit the same relative strategy ordering.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.partition import (
    dirichlet_partition,
    label_shard_partition,
    lognormal_cardinalities,
)


@dataclass
class FederatedDataset:
    """Padded per-client arrays: X [C, N_max, ...], y [C, N_max], n [C].

    The padded layout is the contract both data planes share: the host
    plane fancy-indexes ``X[selection]`` per dispatch, the device plane
    (``core.data_plane.DatasetStore``) uploads ``X``/``y`` once and
    gathers by client index inside the jitted cohort fn."""

    X: np.ndarray
    y: np.ndarray
    n: np.ndarray
    eval_x: np.ndarray
    eval_y: np.ndarray
    name: str = ""

    @property
    def n_clients(self) -> int:
        return self.X.shape[0]

    @property
    def nbytes(self) -> int:
        """Training-input bytes (X + y): what the host plane re-uploads
        over a run and the device plane holds resident once."""
        return int(self.X.nbytes + self.y.nbytes)

    def cohort(self, selection) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side cohort slice (X, y, n) — the host-plane dispatch
        input, kept as the oracle for the on-device gather."""
        sel = np.asarray(selection)
        return self.X[sel], self.y[sel], self.n[sel]


def _pad_pack(xs: list[np.ndarray], ys: list[np.ndarray], n_max: int):
    C = len(xs)
    feat = xs[0].shape[1:]
    X = np.zeros((C, n_max) + feat, xs[0].dtype)
    y = np.zeros((C, n_max), np.int32)
    n = np.zeros((C,), np.int64)
    for c, (xc, yc) in enumerate(zip(xs, ys)):
        k = min(len(xc), n_max)
        X[c, :k] = xc[:k]
        y[c, :k] = yc[:k]
        n[c] = k
    return X, y, n


def _prototype_images(protos: np.ndarray, noise: float, n_total: int,
                      rng: np.random.Generator):
    n_classes = protos.shape[0]
    labels = rng.integers(0, n_classes, n_total)
    x = protos[labels] * 0.5 + rng.normal(0, noise, (n_total,) + protos.shape[1:]).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)


def _image_dataset(name: str, n_clients: int, n_classes: int, shape,
                   scheme: str, samples_per_client: int, noise: float,
                   seed: int, n_eval: int = 1000):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (n_classes,) + shape).astype(np.float32)
    if scheme == "shards":
        n_total = n_clients * samples_per_client
        x, yl = _prototype_images(protos, noise, n_total, rng)
        parts = label_shard_partition(yl, n_clients, shards_per_client=2, rng=rng)
    else:  # dirichlet + power-law cardinality (LEAF-like)
        card = lognormal_cardinalities(n_clients, mean=samples_per_client,
                                       sigma=0.8, rng=rng)
        n_total = int(card.sum())
        x, yl = _prototype_images(protos, noise, n_total, rng)
        parts = dirichlet_partition(yl, n_clients, alpha=0.3, rng=rng,
                                    cardinalities=card)
    xs = [x[p] for p in parts]
    ys = [yl[p] for p in parts]
    n_max = max(len(p) for p in parts)
    X, y, n = _pad_pack(xs, ys, n_max)
    ex, ey = _prototype_images(protos, noise, n_eval, rng)
    return FederatedDataset(X, y, n, ex, ey, name=name)


def _markov_chains(n_roles: int, vocab: int, rng: np.random.Generator):
    """Role-specific char transition matrices: shared backbone + role bias."""
    base = rng.dirichlet(np.full(vocab, 0.3), size=vocab)
    chains = []
    for _ in range(n_roles):
        bias = rng.dirichlet(np.full(vocab, 0.1), size=vocab)
        chains.append(0.7 * base + 0.3 * bias)
    return chains


def _shakespeare_like(n_clients: int, samples_per_client: int, seq_len: int,
                      vocab: int, seed: int, n_eval: int = 500):
    rng = np.random.default_rng(seed)
    n_roles = 12
    chains = _markov_chains(n_roles, vocab, rng)
    card = lognormal_cardinalities(n_clients, mean=samples_per_client,
                                   sigma=1.0, lo=8, rng=rng)

    def sample_seqs(chain, count):
        seqs = np.zeros((count, seq_len + 1), np.int32)
        state = rng.integers(0, vocab, count)
        seqs[:, 0] = state
        for t in range(1, seq_len + 1):
            probs = chain[state]
            cum = probs.cumsum(axis=1)
            u = rng.random((count, 1))
            state = (u < cum).argmax(axis=1)
            seqs[:, t] = state
        return seqs

    xs, ys = [], []
    roles = rng.integers(0, n_roles, n_clients)
    for c in range(n_clients):
        seqs = sample_seqs(chains[roles[c]], int(card[c]))
        xs.append(seqs[:, :-1])
        ys.append(seqs[:, -1])
    n_max = int(card.max())
    X, y, n = _pad_pack(xs, ys, n_max)
    eval_seqs = np.concatenate(
        [sample_seqs(chains[r], n_eval // n_roles + 1) for r in range(n_roles)])
    rng.shuffle(eval_seqs)
    eval_seqs = eval_seqs[:n_eval]
    return FederatedDataset(X, y.astype(np.int32), n,
                            eval_seqs[:, :-1], eval_seqs[:, -1].astype(np.int32),
                            name="shakespeare")


def make_federated_dataset(name: str, n_clients: int = 200, *,
                           scale: float = 1.0, seed: int = 0,
                           fidelity: str = "proxy") -> FederatedDataset:
    """name in {mnist, femnist, shakespeare, speech}. ``scale`` shrinks
    per-client cardinalities (benchmarks on the 1-core container use
    scale<1; the partition structure is unchanged). ``fidelity``:
    'paper' -> the paper's exact input shapes (28x28 / 32x32 / seq 80);
    'proxy' -> 8x8 images / seq 20 matching repro_torch.models.proxy_models."""
    paper = fidelity == "paper"
    img = {"mnist": (28, 28, 1), "femnist": (28, 28, 1), "speech": (32, 32, 1)}
    shape = img.get(name, (8, 8, 1)) if paper else (8, 8, 1)
    seq_len = 80 if paper else 20
    if name == "mnist":
        # paper: 60k images, 300 shards x 200 -> 2 shards/client label skew
        return _image_dataset("mnist", n_clients, 10, shape, "shards",
                              max(int(300 * scale), 20), noise=0.8, seed=seed)
    if name == "femnist":
        return _image_dataset("femnist", n_clients, 62, shape, "dirichlet",
                              max(int(400 * scale), 20), noise=0.9, seed=seed)
    if name == "speech":
        return _image_dataset("speech", n_clients, 35, shape, "dirichlet",
                              max(int(250 * scale), 16), noise=0.9, seed=seed)
    if name == "shakespeare":
        return _shakespeare_like(n_clients, max(int(160 * scale), 8), seq_len,
                                 82, seed=seed)
    raise ValueError(name)
