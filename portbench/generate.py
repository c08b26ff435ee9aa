"""Inputs of a run, made from ``--seed``: the federated dataset, the client
hardware fleet and the initial weights.

These are frozen copies of the paper's generators as the port carries
them (``repro_torch.data.synthetic._image_dataset`` and its partitions,
``repro_torch.faas.hardware.paper_fleet``): class prototypes plus noise,
a Dirichlet mixture over lognormal client sizes (FEMNIST), and the
65/25/10 hardware split. They live here so that a
change to the program cannot change what the benchmark feeds it. Both the
program and the reference get the same arrays.

One departure, so that a seed changes what is learnt and not how much
work it takes: lognormal client sizes are drawn from the configuration's
``cardinality_seed``, so every seed gives client ``i`` the same number of
samples, and the fleet's hardware is shuffled by the traffic mix's
``schedule_seed``. A run's seed deals other images and labels to the
clients, in another order, and draws other weights.

Weights are drawn on the device in one call: a truncated normal over the
whole flat vector, scaled per leaf by ``1/sqrt(fan_in)`` (fan-in = the
product of all but the last dim, conv weights HWIO), biases zero.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SEED_MOD = 2 ** 63


@dataclass
class Dataset:
    """Padded per-client arrays: X [C, N_max, H, W, 1], y [C, N_max], n [C],
    and the evaluation set."""

    X: np.ndarray
    y: np.ndarray
    n: np.ndarray
    eval_x: np.ndarray
    eval_y: np.ndarray


def streams(seed: int, n: int) -> list:
    """``n`` independent numpy generators of one run seed."""
    root = np.random.SeedSequence(int(seed) % SEED_MOD)
    return [np.random.default_rng(s) for s in root.spawn(n)]


def _prototype_images(protos, noise, n_total, rng):
    n_classes = protos.shape[0]
    labels = rng.integers(0, n_classes, n_total)
    x = protos[labels] * 0.5 + rng.normal(
        0, noise, (n_total,) + protos.shape[1:]).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)


def lognormal_cardinalities(n_clients, mean, sigma, rng, lo=20):
    raw = rng.lognormal(np.log(mean), sigma, n_clients)
    return np.clip(raw, lo, mean * 6).astype(np.int64)


def dirichlet_partition(labels, n_clients, alpha, rng, cardinalities):
    n_classes = int(labels.max()) + 1
    by_class = [rng.permutation(np.where(labels == k)[0])
                for k in range(n_classes)]
    ptr = np.zeros(n_classes, np.int64)
    out = []
    for c in range(n_clients):
        counts = rng.multinomial(cardinalities[c],
                                 rng.dirichlet(np.full(n_classes, alpha)))
        idx = []
        for k, cnt in enumerate(counts):
            take = by_class[k][ptr[k]:ptr[k] + cnt]
            if len(take) < cnt and len(by_class[k]):
                # a class ran dry: draw it again, with replacement
                take = np.concatenate(
                    [take, rng.choice(by_class[k], cnt - len(take))])
            ptr[k] += cnt
            idx.append(take)
        out.append(np.concatenate(idx).astype(np.int64))
    return out


def make_dataset(spec: dict, n_clients: int, seed: int) -> Dataset:
    """The configuration's ``dataset`` block at ``n_clients`` clients."""
    rng, = streams(seed, 1)
    shape = tuple(spec["shape"])
    protos = rng.normal(0, 1, (spec["n_classes"],) + shape).astype(np.float32)
    if spec["scheme"] != "dirichlet":
        raise ValueError(f"unknown partition scheme {spec['scheme']!r}")
    card = lognormal_cardinalities(
        n_clients, spec["samples_per_client"], spec["sigma"],
        np.random.default_rng(spec["cardinality_seed"]))
    x, yl = _prototype_images(protos, spec["noise"], int(card.sum()), rng)
    parts = dirichlet_partition(yl, n_clients, spec["alpha"], rng, card)
    n = np.array([len(p) for p in parts], np.int64)
    X = np.zeros((n_clients, int(n.max())) + shape, np.float32)
    y = np.zeros((n_clients, int(n.max())), np.int32)
    for c, p in enumerate(parts):
        X[c, :len(p)] = x[p]
        y[c, :len(p)] = yl[p]
    ex, ey = _prototype_images(protos, spec["noise"], spec["n_eval"], rng)
    return Dataset(X, y, n, ex, ey)


def make_fleet(spec: dict, n_clients: int, seed: int) -> list:
    """``[(name, speed, vcpus, mem_gib, is_gpu, gpu_fraction, variability)]``
    per client: ``spec["mix"]`` split by fractions and shuffled by ``seed``
    (the mix's schedule seed)."""
    names = []
    for name, frac in spec["mix"]:
        names += [name] * round(n_clients * frac)
    names = (names + [spec["mix"][0][0]] * n_clients)[:n_clients]
    np.random.default_rng(seed).shuffle(names)
    return [(name, *spec["profiles"][name]) for name in names]


def make_weights(leaves: dict, seed: int, device) -> dict:
    """``leaves``: name -> (shape, init) with init ``normal`` or ``zeros``.
    One truncated-normal draw on ``device`` for every leaf, in name order."""
    names = sorted(leaves)
    sizes = [math.prod(leaves[k][0]) for k in names]
    gen = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out = {}
    for name, part in zip(names, torch.split(flat, sizes)):
        shape, init = leaves[name]
        if init == "zeros":
            part.zero_()
        else:
            part.mul_(1.0 / math.sqrt(max(math.prod(shape[:-1]), 1)))
        out[name] = part.view(shape)
    return out
