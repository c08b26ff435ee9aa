"""The readings that a limit of ``correct`` is set from: the program's
numbers on many seeds and the control's, in one process so that the
kernels load once.

    python3 portbench/readings.py --workload femnist_cnn.apodotiko \\
        --seconds 8 --seeds 11 12 13 --control 3

Each seed is one run of the cell with a window of ``--seconds``; the first
``--control`` seeds also read the control and the faults, planted in the
reference put in the program's place: the reference in TF32 (the
precision below the configuration's fp32 with TF32 off), the Adam moments
stored in bf16 (``moment_gap``) or left as they were read
(``moment_gap.unwritten``), half of every lane's minibatch
(``grad_gap.half_batch``) and half of one lane's
(``grad_gap_2nd.one_lane``). One JSON line a seed: the checks, the
control's readings, round_s and the window's rounds. A last line gives
each number's largest program reading and smallest control reading.
"""
import argparse
import json
import sys

import torch

import harness


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cell = harness.Cell(args.workload)
    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        res = harness.run_cell(cell, seed, args.seconds, False,
                               control=i < args.control)
        vals = {k: c["value"] for k, c in res["checks"].items()}
        for k, v in vals.items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in res.get("control", {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "checks": vals,
                          "control": res.get("control", {}),
                          "round_s": res["base"]["window_s"]
                          / res["base"]["rounds"],
                          "rounds": res["base"]["rounds"]}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "control_min": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
