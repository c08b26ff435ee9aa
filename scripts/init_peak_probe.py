#!/usr/bin/env python3
"""Peak device memory of ``DecoderLM.init`` on one card, with the stacked
init as it is and as it was before it drew each stacked leaf into its slot.

    python3 scripts/init_peak_probe.py

Needs one CUDA card; imports neither ``jax`` nor ``repro``. For
DeepSeek-V2-Lite uncut (27 layers, bf16) and Arctic cut to one layer at
its published width (bf16), prints one JSON line each: the peak GB and
seconds of the init as it is (``models.common.init_stacked`` allocates
each stacked leaf once and draws every block's leaf into its slot; a
normal leaf is scaled in place) and of the former init (every block drawn
whole, then ``torch.stack``-ed; each normal leaf drawn in fp32, scaled
into a second fp32 copy, then cast), which ``former_initialize`` and
``former_init_stacked`` below restate. Both draw the same values.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]
for mod in ("jax", "repro"):          # the port must not need either
    sys.modules[mod] = None

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ops import tree_map  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402

RUNS = {"deepseek-v2-lite-16b": None, "arctic-480b": 1}


def former_initialize(gen, shape, dtype, init, scale, device=None, out=None):
    device = torch.device("cpu" if device is None else device)
    if init in ("zeros", "ones"):
        return (torch.zeros if init == "zeros" else torch.ones)(
            shape, dtype=dtype, device=device)
    if init == "normal":
        fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (
            shape[-1] if shape else 1)
        std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (x * std).to(dtype)
    std = scale if scale is not None else 0.02
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def former_init_stacked(init_fn, generator, n, dtype, *args, device=None):
    blocks = []
    for _ in range(n):
        pf = common.ParamFactory(generator, dtype, device)
        init_fn(pf, *args)
        blocks.append(pf.params)
    return tree_map(lambda *xs: torch.stack(xs), blocks[0], *blocks[1:])


def measure(cfg, dev) -> dict:
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm_mod.DecoderLM(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    rec = {"seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "params_gb": common.count_params(params) * 2 / 1e9}
    del params
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("init_peak_probe: no CUDA card is available; this script "
              "runs only on one", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    current = (common._initialize, lm_mod.init_stacked)
    for arch, layers in RUNS.items():
        cfg = get_config(arch)
        if layers:
            cfg = cfg.with_(n_layers=layers)
        now = measure(cfg, dev)
        common._initialize, lm_mod.init_stacked = (former_initialize,
                                                   former_init_stacked)
        try:
            before = measure(cfg, dev)
        finally:
            common._initialize, lm_mod.init_stacked = current
        print(json.dumps({"card": smi, "arch": arch,
                          "n_layers": cfg.n_layers, "now": now,
                          "former": before}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
