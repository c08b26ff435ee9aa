#!/usr/bin/env python3
"""``chip_smoke.py``'s ``xattn`` phase and its kernel entries alone, on one
card.

    python3 scripts/xattn_phase_probe.py

Needs one CUDA card and ``nvcc``; imports neither ``jax`` nor ``repro``.
Builds the kernels, then runs ``chip_smoke.xattn_phase``
(Llama-3.2-Vision and SeamlessM4T-large-v2 served uncut in bf16 over
random patches or frames, the VLM's gates set to 1.0, each decoded
position checked against the full forward; the fp32 checks, the VLM cut to
8 layers and SeamlessM4T uncut; the VLM's 4-layer cut and SeamlessM4T
trained through ``launch.train`` with the fused Adam; both smoke runs card
against CPU; the VLM's smoke config trained with its gates open over
random patches, card against CPU, cross attention's grads held) and ``chip_smoke.xattn_kernel_entries`` (``fused_adam`` at
[1, 2,141,237,249] and [1, 2,034,784,256]), where the whole script takes
ten minutes or more. Prints the card's name and power limit, then one
JSON line for the phase and one for each kernel entry, as chip_smoke
prints them; exits non-zero if a check fails.
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
    rec = cs.xattn_phase(dev)
    for entry in cs.xattn_kernel_entries(rec, dev):
        cs.emit("kernel", **entry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
