"""Quickstart on the PyTorch port: federated training with Apodotiko on a
simulated serverless fleet, compared against FedAvg (twin of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

20 clients (65% 1vCPU / 25% 2vCPU / 10% GPU, the paper's mix), non-IID
Dirichlet data, real local training on the CUDA card (or the CPU with
``--device cpu``), simulated FaaS timing (cold starts, scale-to-zero).
Prints time-to-accuracy for both strategies.
"""
import argparse

from repro_torch.core.controller import Controller, FLConfig
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.proxy_models import ProxyCNN

N_CLIENTS = 20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)

    data = make_federated_dataset("speech", n_clients=N_CLIENTS, scale=0.15,
                                  seed=0)
    model = ProxyCNN(35)
    results = {}
    for strategy in ("fedavg", "apodotiko"):
        cfg = FLConfig(
            n_clients=N_CLIENTS, clients_per_round=8, rounds=args.rounds,
            strategy=strategy, concurrency_ratio=0.3,
            local_epochs=2, batch_size=5, base_step_time=1.5,
            round_timeout=400.0, seed=0)
        ctl = Controller(cfg, model, data, list(paper_fleet(N_CLIENTS)),
                         device=args.device)
        m = ctl.run(progress=lambda log: print(
            f"  [{strategy}] round {log.round:2d} t={log.t_end:7.1f}s "
            f"acc={log.accuracy:.3f} agg={log.n_aggregated} "
            f"stale={log.n_stale}"))
        results[strategy] = m
        print(f"{strategy}: sim_time={m['total_time']:.0f}s "
              f"acc={m['final_accuracy']:.3f} "
              f"cold_starts={m['cold_start_ratio']:.2f} "
              f"cost=${m['total_cost_usd']:.3f} device={m['device']}")

    # time to the accuracy FedAvg ended at
    target = results["fedavg"]["final_accuracy"]
    for s, m in results.items():
        t = next((t for t, _, a in m["history"] if a >= target), None)
        print(f"time to acc {target:.3f}: {s} = "
              f"{'n/a' if t is None else f'{t:.0f}s'}")


if __name__ == "__main__":
    main()
