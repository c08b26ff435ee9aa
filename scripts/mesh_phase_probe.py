#!/usr/bin/env python3
"""``chip_smoke.py``'s ``mesh`` phase and its kernel entry alone, on one
card.

    python3 scripts/mesh_phase_probe.py

Needs one CUDA card and ``nvcc``; imports neither ``jax`` nor ``repro``.
Builds the kernels, runs the main path's ``apodotiko`` and
``apodotiko-topk`` runs at 1x1 (the paper's MNIST setup, 3 rounds each),
then ``chip_smoke.mesh_phase`` (four ranks at 2x2 over gloo on the card,
held to those runs) and ``chip_smoke.mesh_kernel_entry``
(``staleness_agg[mesh]`` at a rank's tile). Prints the card's name and
power limit, then one JSON line a phase and one for the entry, as
chip_smoke prints them; exits non-zero if a check fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
for mod in ("jax", "repro"):          # the port must not need either
    sys.modules[mod] = None

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        return cs.fail("no CUDA card is available; this script runs only "
                       "on one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    cs.emit("build", seconds=time.perf_counter() - t0)
    dev = torch.device("cuda", 0)
    data = make_federated_dataset(**cs.MAIN_DATA)
    apo_engine, apo = cs.run_main_path("apodotiko", cs.MESH_ROUNDS, data, dev)
    topk_engine, top = cs.run_main_path("apodotiko-topk", cs.MESH_ROUNDS,
                                        data, dev)
    t0 = time.perf_counter()
    mesh = cs.mesh_phase(
        {"engines": {"apodotiko": apo_engine, "apodotiko-topk": topk_engine},
         "records": {"apodotiko": apo, "apodotiko-topk": top}}, dev,
        cs.MAIN_DATA)
    cs.emit("mesh_phase_seconds", seconds=time.perf_counter() - t0)
    cs.emit("kernel", **cs.mesh_kernel_entry(mesh, apo, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
