#!/usr/bin/env python3
"""Where the time of the SSM and hybrid LMs goes on one card: host wall
against device busy time for the calls chip_smoke's ``ssm`` phase makes.

    python3 scripts/ssm_time_split.py

Needs one CUDA card; imports neither ``jax`` nor ``repro``. Each case runs
once unprofiled (warm-up), then ``reps`` times under ``torch.profiler``
(device activity only): the host wall a call (synchronized), the device
busy time a call (the union of kernel intervals), the idle share (1 -
busy / wall), kernel launches a call, and the five kernels that take the
most device time. Cases, at the phase's shapes, bf16, random init from
seed 0:

- ``decode[mamba2-370m]``, ``decode[zamba2-2.7b]``: one decode step of 4
  sequences after a prefill of 4 x 512 (uncut);
- ``prefill[mamba2-370m]``: the prefill of 4 x 512 into 576 (2 scan chunks
  of 256 a layer);
- ``layer_32k[mamba2-370m]``: one Mamba2 block over 1 x 32,768 tokens (128
  chunks of 256), the 32k prefill's work a layer, and ``ssd_32k``, its
  chunked scan alone;
- ``train_step[mamba2-370m]``: one ``launch.train`` step (loss, backward
  with the per-layer recompute, fused Adam) of 4 x 4,096 tokens.

Prints the card's name and power limit, then one JSON line a case.
"""
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
for mod in ("jax", "repro"):          # the port must not need either
    sys.modules[mod] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def profiled(name: str, fn, reps: int, **fields) -> dict:
    """``fn`` once, then ``reps`` times under the profiler: wall, busy,
    idle share and launches a call, the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:                       # union of kernel intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy = busy_us / 1e6 / reps
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        entry = by_name[e.name[:80]]
        entry[0] += 1
        entry[1] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:5]
    rec = {"case": name, "reps": reps, "wall_ms": wall * 1e3,
           "device_busy_ms": busy * 1e3 if spans else None,
           "idle_share": (1 - busy / wall) if spans else None,
           "launches": len(spans) / reps, **fields,
           "top": [{"name": n, "calls": c / reps, "ms": ms}
                   for n, (c, ms) in top]}
    cs.emit("split", **rec)
    return rec


def model(arch: str, dev):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import DecoderLM

    lm = DecoderLM(get_config(arch))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    return lm, lm.init(gen), gen


@torch.no_grad()
def serve_cases(dev) -> None:
    for arch in ("mamba2-370m", "zamba2-2.7b"):
        lm, params, gen = model(arch, dev)
        prompts = torch.randint(0, lm.cfg.vocab_size, (4, 512), generator=gen,
                                device=dev)
        _, caches, _ = lm.apply(params, {"tokens": prompts}, make_cache=True,
                                cache_len=576)
        tok = prompts[:, -1:]
        profiled(f"decode[{arch}]",
                 lambda: lm.decode_step(params, caches, tok, 512), 10,
                 n_layers=lm.cfg.n_layers, batch=4)
        if arch == "mamba2-370m":
            profiled(f"prefill[{arch}]", lambda: lm.apply(
                params, {"tokens": prompts}, make_cache=True,
                cache_len=576), 3, n_layers=lm.cfg.n_layers, tokens=4 * 512,
                chunks_a_layer=2)
        del params, caches
        torch.cuda.empty_cache()


@torch.no_grad()
def long_cases(dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, ssm
    from repro_torch.models.common import ParamFactory

    cfg = get_config("mamba2-370m")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    pf = ParamFactory(gen, torch.bfloat16)
    blocks.init_mamba_block(pf, cfg)
    p = pf.params
    x = torch.randn(1, 32768, cfg.d_model, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    profiled("layer_32k[mamba2-370m]",
             lambda: blocks.mamba_block(p, x, cfg, cache={}), 3,
             tokens=32768, chunks=128)
    H, P, N = ssm.n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    xd = torch.randn(1, 32768, H, P, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    a = -torch.rand(1, 32768, H, generator=gen, device=dev) * 0.5
    Bm, Cm = (torch.randn(1, 32768, N, generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    profiled("ssd_32k[mamba2-370m]",
             lambda: ssm.ssd_chunked(xd, a, Bm, Cm, 256), 3, tokens=32768,
             chunks=128)


def train_case(dev) -> None:
    from repro_torch.launch import train
    from repro_torch.optim import build_optimizer

    lm, params, _ = model("mamba2-370m", dev)
    opt = build_optimizer(lm.cfg.optimizer, lm.cfg.learning_rate)
    state = {"params": params, "opt": opt.init(params)}
    batch = train.token_batch(np.random.default_rng(0), lm.cfg.vocab_size, 4,
                              4096, dev)

    def step():
        state["params"], state["opt"], _ = train.train_step(
            lm, opt, state["params"], state["opt"], batch)

    profiled("train_step[mamba2-370m]", step, 2, tokens=4 * 4095,
             chunks_a_layer=21, n_layers=lm.cfg.n_layers)


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
    _build.build()
    dev = torch.device("cuda", 0)
    serve_cases(dev)
    long_cases(dev)
    train_case(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
