"""Serving example on the PyTorch port: batched prefill + decode (twin of
``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen3-1.7b \
        --tokens 16 [--device cpu]

Runs the smoke-sized config of the chosen architecture (the dense family:
Qwen3, Granite, Yi; the MoE family: DeepSeek-V2-Lite, whose MLA caches the
compressed KV, and Arctic; the other families come with later slices and
raise) on the CUDA card, or the CPU with ``--device cpu``: prefills a
batch of prompts into a KV cache of prompt + tokens slots, then decodes
greedily against it, one token a step.
"""
import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model


def main(argv=None) -> torch.Tensor:
    """Runs the example; returns the decoded tokens [batch, tokens]."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    B, P, T = args.batch, args.prompt_len, args.tokens
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=device)

    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches, _ = model.apply(params, {"tokens": prompts},
                                        make_cache=True, cache_len=P + T)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        print(f"prefill {B}x{P} in {time.perf_counter() - t0:.2f}s "
              f"({args.arch}, {cfg.n_layers}L smoke config, {device})")
        out = [tok]
        t0 = time.perf_counter()
        for i in range(T - 1):
            logits, caches = model.decode_step(params, caches, tok, P + i)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            out.append(tok)
        seqs = torch.cat(out, dim=1)
        dt = time.perf_counter() - t0
    print(f"decoded {T-1} steps x {B} seqs in {dt:.2f}s "
          f"({(T-1)*B/max(dt, 1e-9):.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  seq[{b}]: {seqs[b].tolist()}")
    return seqs


if __name__ == "__main__":
    main()
