"""Federated training of a transformer LM with Apodotiko on the PyTorch port
(twin of ``examples/train_fl_lm.py``).

    PYTHONPATH=src python examples/torch_train_fl_lm.py           # container-sized
    PYTHONPATH=src python examples/torch_train_fl_lm.py --full    # ~100M params
    PYTHONPATH=src python examples/torch_train_fl_lm.py --device cpu

Every client is a serverless function holding a private token stream (its
"user corpus", a biased Markov source); the controller federates a
qwen3-family decoder LM across the heterogeneous fleet with CEF scoring +
async aggregation, local training on the CUDA card (or the CPU with
``--device cpu``). Any dense, MoE, SSM or hybrid config id of
``repro_torch.configs`` works via ``--arch`` (an MoE LM's client loss is
cross entropy plus the router's load-balancing loss; ``mamba2-370m`` and
``zamba2-2.7b`` federate their smoke configs' Mamba2 layers). The VLM
and enc-dec configs fail as in the reference: its client adapter passes
only tokens, and their models need patches or frames (``KeyError``).
"""
import argparse

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.controller import Controller, FLConfig
from repro_torch.data.synthetic import FederatedDataset, _markov_chains
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.api import LMClientAdapter
from repro_torch.models.common import count_params


def make_lm_federated_data(n_clients, vocab, seq_len, samples_per_client,
                           seed=0):
    rng = np.random.default_rng(seed)
    chains = _markov_chains(8, vocab, rng)
    roles = rng.integers(0, 8, n_clients)

    def sample(chain, count):
        seqs = np.zeros((count, seq_len + 1), np.int32)
        state = rng.integers(0, vocab, count)
        seqs[:, 0] = state
        for t in range(1, seq_len + 1):
            cum = chain[state].cumsum(axis=1)
            state = (rng.random((count, 1)) < cum).argmax(axis=1)
            seqs[:, t] = state
        return seqs

    card = rng.integers(samples_per_client // 2, samples_per_client + 1,
                        n_clients)
    n_max = int(card.max())
    X = np.zeros((n_clients, n_max, seq_len), np.int32)
    Y = np.full((n_clients, n_max, seq_len), -1, np.int32)
    for c in range(n_clients):
        seqs = sample(chains[roles[c]], int(card[c]))
        X[c, :card[c]] = seqs[:, :-1]
        Y[c, :card[c]] = seqs[:, 1:]
    ev = np.concatenate([sample(ch, 8) for ch in chains])
    return FederatedDataset(X, Y, card.astype(np.int64),
                            ev[:, :-1], ev[:, 1:], name="lm")


def lm_config(arch: str, full: bool):
    """The reference example's model: the arch's smoke config, widened to
    ~100M params with ``full`` or given a 256-token vocabulary."""
    smoke = get_config(arch, smoke=True)
    if full:
        return smoke.with_(n_layers=12, d_model=768, n_heads=12,
                           n_kv_heads=4, head_dim=64, d_ff=2048,
                           vocab_size=32_000)   # ~100M params
    return smoke.with_(vocab_size=256)          # container-sized


def fl_config(clients: int, rounds: int) -> FLConfig:
    return FLConfig(
        n_clients=clients, clients_per_round=max(4, clients // 3),
        rounds=rounds, strategy="apodotiko", concurrency_ratio=0.5,
        local_epochs=1, batch_size=4, optimizer="adam", lr=3e-4,
        base_step_time=2.0, seed=0)


def main(argv=None):
    """Runs the example; returns the controller and its metrics."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config (needs the card)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg_model = lm_config(args.arch, args.full)
    model = LMClientAdapter(cfg_model)
    n_params = count_params(model.init(device="meta"))
    print(f"federating {args.arch} ({cfg_model.n_layers}L, "
          f"{n_params/1e6:.1f}M params) over {args.clients} FaaS clients")

    data = make_lm_federated_data(args.clients, cfg_model.vocab_size,
                                  seq_len=32, samples_per_client=24)
    ctl = Controller(fl_config(args.clients, args.rounds), model, data,
                     list(paper_fleet(args.clients)), device=args.device)
    m = ctl.run(progress=lambda log: print(
        f"  round {log.round:2d} sim_t={log.t_end:7.1f}s "
        f"token_acc={log.accuracy:.3f} aggregated={log.n_aggregated}"))
    print(f"done: {m['rounds']} rounds, token accuracy "
          f"{m['final_accuracy']:.3f}, cost ${m['total_cost_usd']:.3f}, "
          f"cold-start ratio {m['cold_start_ratio']:.2f}, "
          f"device={m['device']}")
    return ctl, m


if __name__ == "__main__":
    main()
