#!/usr/bin/env python3
"""``chip_smoke.py``'s ``launch`` phase alone, on one card.

    python3 scripts/launch_phase_probe.py

Needs one CUDA card and ``nvcc``; imports neither ``jax`` nor ``repro``.
Builds the kernels, then runs ``chip_smoke.launch_phase``: the executed
cells on the card's 1x1 mesh (qwen3-1.7b's train_4k at 1 x 4,096,
prefill_32k at 1 x 8,192, decode_32k at 4 sequences, fl_round at K = 8;
mamba2-370m's long_500k uncut), the smoke cells card against CPU,
momentum card against CPU, then the dry run's meta sweep (every arch x
shape cell on the abstract 16x16 mesh, in child processes that see no
card). Prints the card's name and power limit, then the phase's JSON
lines as chip_smoke prints them; exits non-zero if a check fails.
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
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    cs.emit("build", seconds=time.perf_counter() - t0)
    cs.launch_phase(torch.device("cuda", 0))
    cs.emit("total", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
