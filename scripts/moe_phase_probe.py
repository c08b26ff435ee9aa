#!/usr/bin/env python3
"""``chip_smoke.py``'s ``moe`` phase and its kernel entry alone, on one
card.

    python3 scripts/moe_phase_probe.py

Needs one CUDA card and ``nvcc``; imports neither ``jax`` nor ``repro``.
Builds the kernels, then runs ``chip_smoke.moe_phase`` (DeepSeek-V2-Lite
served uncut and Arctic's layer at its published width in bf16, each
decode checked against the full forward at a capacity that drops no
token, the fp32 check at DeepSeek's 3-layer cut; that cut trained through
``launch.train`` with the fused Adam and through ``train_step`` with
Adafactor; Arctic's smoke run with Adafactor card against CPU; the
federated MoE example's launches and its host trace card against CPU)
and ``chip_smoke.moe_kernel_entries`` (``fused_adam`` at [1,
1,670,135,296]), where the whole script takes ten minutes or more.
Prints the card's name and power limit, then one JSON line for the phase
and one for the kernel entry, as chip_smoke prints them; exits non-zero if
a check fails.
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
    dev = torch.device("cuda", 0)
    rec = cs.moe_phase(dev)
    for entry in cs.moe_kernel_entries(rec, dev):
        cs.emit("kernel", **entry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
