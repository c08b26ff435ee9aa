"""The paper's motivating Fig. 1 on the PyTorch port (twin of
``examples/heterogeneous_cohort.py``): FedLesScan beats FedAvg on a
homogeneous fleet but collapses under hardware heterogeneity, while
Apodotiko's CEF scoring adapts. ProxyLSTM next-char clients on the poll
loop (``Controller``), trained on the CUDA card (or the CPU with
``--device cpu``).

    PYTHONPATH=src python examples/torch_heterogeneous_cohort.py [--device cpu]
"""
import argparse

from repro_torch.core.controller import Controller, FLConfig
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.faas.hardware import HARDWARE_PROFILES, paper_fleet
from repro_torch.models.proxy_models import ProxyLSTM

N = 18


def fleet(scenario: str):
    if scenario == "homogeneous":
        return [HARDWARE_PROFILES["cpu2"]] * N
    if scenario == "two-tier":
        return [HARDWARE_PROFILES["cpu1"]] * 11 + [HARDWARE_PROFILES["cpu2"]] * 7
    return list(paper_fleet(N))  # cpu1/cpu2/gpu mix


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)

    data = make_federated_dataset("shakespeare", n_clients=N, scale=0.1,
                                  seed=0)
    model = ProxyLSTM(vocab=82, seq_len=20)
    print(f"{'scenario':>14} {'strategy':>12} {'sim_time':>9} {'acc':>6} "
          f"{'cold%':>6}")
    for scenario in ("homogeneous", "two-tier", "heterogeneous"):
        for strategy in ("fedavg", "fedlesscan", "apodotiko"):
            cfg = FLConfig(n_clients=N, clients_per_round=6,
                           rounds=args.rounds, strategy=strategy,
                           local_epochs=1, batch_size=8, optimizer="sgd",
                           lr=0.8, base_step_time=4.0, round_timeout=500.0,
                           seed=0)
            ctl = Controller(cfg, model, data, fleet(scenario),
                             device=args.device)
            m = ctl.run()
            print(f"{scenario:>14} {strategy:>12} "
                  f"{m['total_time']:>8.0f}s {m['final_accuracy']:>6.3f} "
                  f"{100*m['cold_start_ratio']:>5.1f}%")


if __name__ == "__main__":
    main()
