"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload femnist_cnn.apodotiko --seed 7 \\
        --seconds 40 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted`` (client trainings dispatched in the window), ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, ``host``
(what the host and the card did over the window: CPU seconds, context
switches, load, SM clock, power, temperature), and last ``checks``: each
number compared with the reference beside its limit. The checks are also
the last lines of standard error.

It needs as many CUDA cards as the cell asks for and exits with 1,
printing no result, without them. Kernel libraries build into the
checkout's ``build/kernels/`` (the program's fixed path) on the first run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ["USE_FLAX"] = "0"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              "the port alone", file=sys.stderr)
        return 1
    base = res["base"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": base["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": base["attempted"],
            "failed": base["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["traced_window_s"])
        line["breakdown"] = res["breakdown"]
    line["host"] = base["host"]
    line["checks"] = res["checks"]
    print(f"setup_s {base['setup_s']!r} window_s {base['window_s']!r} "
          f"rounds {base['rounds']} "
          f"round_walls {' '.join(f'{t:.4f}' for t in base['round_walls'])}",
          file=sys.stderr)
    print("host " + " ".join(f"{k} {v!r}" for k, v in base["host"].items()),
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
