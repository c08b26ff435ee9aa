"""Reproduce the paper's strategy-comparison tables with the PyTorch port's
sweep engine (twin of ``examples/sweep_paper_tables.py``).

    PYTHONPATH=src python examples/torch_sweep_paper_tables.py [preset] \
        [--device cpu] [--workers N]

Default preset is ``paper_mnist``: all six strategies (FedAvg, FedProx,
SCAFFOLD, FedLesScan, FedBuff, Apodotiko) on the paper's heterogeneous
65/25/10 hardware mix, rendered as three tables in the shape of the paper's
Tables IV-VI — time-to-accuracy/speedup, cost, and cold starts. Every cell
trains on the CUDA card unless ``--device cpu``. Bench scale by default
(minutes); SWEEP_FULL=1 for the paper-scale grid. Other presets:
``paper_tables`` (all four datasets), ``cr_sweep``, ``hardware_scenarios``,
``staleness_ablation``, ``smoke`` — see ``repro_torch.sweep.presets``.
"""
import argparse

from repro_torch.sweep import get_preset, run_sweep

TABLE_IV = ("dataset", "strategy", "target_acc", "time_to_target_s",
            "speedup_vs_fedavg", "final_acc", "best_acc")
TABLE_V = ("dataset", "strategy", "cost_usd", "cost_vs_fedavg",
           "n_invocations")
TABLE_VI = ("dataset", "strategy", "cold_starts", "cold_start_ratio",
            "cold_start_reduction_vs_fedavg")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", default="paper_mnist")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--workers", type=int, default=None,
                    help="concurrent cells (default: SWEEP_WORKERS or 1)")
    args = ap.parse_args(argv)

    spec = get_preset(args.preset)
    print(f"sweep {spec.name}: {spec.n_runs} runs", flush=True)
    table = run_sweep(spec, max_workers=args.workers, device=args.device,
                      progress=lambda i, n, r, m: print(
                          f"  [{i + 1}/{n}] {r.key}"
                          + (f" FAILED: {m['error']}" if "error" in m
                             else ""), flush=True))

    print("\n== Table IV: time to common accuracy & speedup vs FedAvg ==")
    print(table.to_markdown(columns=TABLE_IV))
    print("== Table V: FaaS cost ==")
    print(table.to_markdown(columns=TABLE_V))
    print("== Table VI: cold starts ==")
    print(table.to_markdown(columns=TABLE_VI))
    for s in sorted({r["strategy"] for r in table.rows} - {"fedavg"}):
        print(f"mean speedup vs fedavg [{s}]: {table.mean_speedup(s)}")


if __name__ == "__main__":
    main()
