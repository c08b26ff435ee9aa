#!/usr/bin/env python3
"""Subprocess body for SIGKILL crash fuzzing of the PyTorch port's durable
runs (``repro_torch.durability``).

Builds the small MNIST setup of the port's durability tests (ProxyCNN, 10
clients on the paper fleet, 4 a round, 2 rounds, E=1, B=5), arms the crash
injector at journal record ``--crash-after`` with ``--crash-mode`` (a real
``SIGKILL`` by default) and runs: the process dies at the armed boundary.
The parent then resumes in-process (``durability.resume_durable``) and
holds the result to an uncrashed golden run of ``child_config``.

Usage:
    python scripts/torch_durable_crash_child.py <checkpoint_dir>
        [--crash-after K] [--crash-mode sigkill|raise]
        [--device cpu|cuda] [--deterministic]

Unarmed (no ``--crash-after``) it runs to completion and prints the final
journal record count. ``--device`` defaults to the card;
``--deterministic`` runs under ``torch.use_deterministic_algorithms(True)``
(needs ``CUBLAS_WORKSPACE_CONFIG`` set on the card), so that a resume on
the card can be held to a golden run bit for bit.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.core.scheduler import build_engine  # noqa: E402
from repro_torch.core.services import FLConfig  # noqa: E402
from repro_torch.data.synthetic import make_federated_dataset  # noqa: E402
from repro_torch.faas.hardware import paper_fleet  # noqa: E402
from repro_torch.models.proxy_models import build_bench_model  # noqa: E402

N_CLIENTS = 10


def child_config(checkpoint_dir: str) -> FLConfig:
    """The resume validates the child's journal against this config: the
    parent builds its golden run and its resume from it too."""
    return FLConfig(
        n_clients=N_CLIENTS, clients_per_round=4, rounds=2, local_epochs=1,
        batch_size=5, base_step_time=0.5, round_timeout=200.0, seed=0,
        strategy="apodotiko", durability="journal",
        checkpoint_dir=checkpoint_dir)


def child_setup():
    """(model, data, fleet) of the child's run."""
    data = make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)
    return build_bench_model("mnist"), data, list(paper_fleet(N_CLIENTS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--crash-after", type=int, default=None)
    ap.add_argument("--crash-mode", choices=("sigkill", "raise"),
                    default="sigkill")
    ap.add_argument("--device", default=None)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    model, data, fleet = child_setup()
    eng = build_engine(child_config(args.checkpoint_dir), model, data, fleet,
                       device=args.device)
    eng.durability.crash_after = args.crash_after
    eng.durability.crash_mode = args.crash_mode
    m = eng.run()
    print(m["journal_records"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
