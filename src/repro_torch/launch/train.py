"""Training driver (twin of ``repro.launch.train``): centralized training
of any LM config (the ``dense``, ``moe``, ``ssm``, ``hybrid`` and ``vlm``
decoder families and the ``encdec`` family), with checkpointing and
restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 20 --smoke --batch 4 --seq 64 --ckpt-dir /tmp/ckpt \\
        [--layers N] [--device cpu]

Runs on the CUDA card unless ``--device cpu``; ``--smoke`` takes the
arch's reduced config, ``--layers N`` keeps the config's widths and cuts
its depth to N layers (DeepSeek-V2-Lite's first, dense layer among them;
for a hybrid, Zamba2, N must be a multiple of its ``attn_period``, for the
VLM of its ``cross_attn_period``; for the enc-dec, SeamlessM4T, N must be
even and is split into N/2 encoder and N/2 decoder layers). Params are
initialized from ``torch.Generator`` seed 0 on the device, the batches are
the reference's (``step_batch``: from ``numpy.random.default_rng(0)``,
``[batch, seq]`` uniform tokens a step, inputs ``[:, :-1]``, targets ``[:,
1:]``; the VLM's patches zeros, the enc-dec's frames normal draws after
the tokens), and the optimizer is the
config's (``adam``: the fused kernel, ``optim.adam_fused``; ``adafactor``,
Arctic's, ``optim.adafactor``). A checkpoint holds the params and the
optimizer state (``checkpoint.CheckpointManager``, every ``--ckpt-every``
steps and at the end: Adam's flat moments, or Adafactor's per-leaf
factored state, a tree shaped as the params; the step count as an int);
``--resume`` restarts from the newest one and skips the batches its steps
consumed, frames included, so a resumed run ends where the uninterrupted
run ends (the reference draws the stream again from its first batch). For
federated LM training see ``examples/torch_train_fl_lm.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import tree_map
from repro_torch.models import build_model
from repro_torch.models.common import count_params
from repro_torch.optim import apply_updates, build_optimizer


def _from_checkpoint(tree, device):
    """A restored tree on ``device``: arrays as tensors, a 0-d integer
    (the optimizer's step count) as a Python int."""
    def leaf(x):
        if (isinstance(x, np.ndarray) and x.ndim == 0
                and np.issubdtype(x.dtype, np.integer)):
            return int(x)
        return torch.as_tensor(x).to(device)
    return tree_map(leaf, tree)


def token_batch(data_rng: np.random.Generator, vocab: int, batch: int,
                seq: int, device) -> dict:
    """One step's batch of the reference's token stream."""
    tokens = data_rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    return {"tokens": torch.as_tensor(tokens[:, :-1]).to(device),
            "targets": torch.as_tensor(tokens[:, 1:]).to(device)}


def step_batch(data_rng: np.random.Generator, cfg, batch: int, seq: int,
               device) -> dict:
    """One step's batch of ``cfg``, drawn as the reference's launcher draws
    it: the tokens (``token_batch``); for ``vlm`` zero patches ``[batch,
    n_patches, d_model]``; for ``encdec`` frames ``[batch, seq - 1,
    d_model]`` of ``data_rng.normal``, drawn after the tokens. On the
    ``meta`` device the draws advance ``data_rng`` and nothing is kept."""
    out = token_batch(data_rng, cfg.vocab_size, batch, seq, device)
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((batch, cfg.n_patches, cfg.d_model),
                                     dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        frames = data_rng.normal(size=(batch, seq - 1, cfg.d_model))
        out["frames"] = torch.as_tensor(frames, dtype=torch.float32).to(
            device)
    return out


def memory_inputs(cfg, batch: int, length: int, gen: torch.Generator,
                  device) -> dict:
    """A serving run's stub-frontend inputs, drawn from ``gen``: normal
    patches at all ``n_patches`` positions for ``vlm``, normal frames
    ``[batch, length, d_model]`` for ``encdec``; none for the other
    families."""
    if cfg.family == "vlm":
        return {"patches": torch.randn((batch, cfg.n_patches, cfg.d_model),
                                       generator=gen, device=device)}
    if cfg.family == "encdec":
        return {"frames": torch.randn((batch, length, cfg.d_model),
                                      generator=gen, device=device)}
    return {}


def cut_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers, an enc-dec's split evenly between
    its encoder and its decoder (``ValueError`` for an odd count; a
    hybrid's or a VLM's count that is not whole chunks raises when the
    model is built)."""
    if cfg.family != "encdec":
        return cfg.with_(n_layers=layers)
    if layers % 2:
        raise ValueError(f"{cfg.name} takes an even count, split between "
                         "its encoder and its decoder")
    return cfg.with_(n_layers=layers, enc_layers=layers // 2,
                     dec_layers=layers // 2)


def train_step(model, opt, params, opt_state, batch):
    """One optimizer step; returns (params, opt_state, loss), the loss a
    detached 0-d tensor on the params' device (``meta`` tensors run it
    too: a ``launch.steps`` cell's step)."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss(params, batch)
    loss.backward()
    with torch.no_grad():
        grads = tree_map(lambda p: p.grad, params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(tree_map(torch.Tensor.detach, params), updates)
    return params, opt_state, loss.detach()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the driver; returns the final ``params`` and ``opt_state``,
    each step's ``loss`` and wall seconds (``losses``, ``step_s``, from
    the batch's upload to the loss on the host), ``start_step`` and
    ``n_params``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    try:
        if args.layers is not None:
            cfg = cut_depth(cfg, args.layers)
        model = build_model(cfg)
    except ValueError as err:           # a depth the model cannot take
        ap.error(f"--layers {args.layers}: {err}")
    opt = build_optimizer(cfg.optimizer, cfg.learning_rate)

    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = opt.init(params)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume and mgr.latest_step() is not None:
        state, _, start_step = mgr.restore()
        params = _from_checkpoint(state["params"], device)
        opt_state = _from_checkpoint(state["opt_state"], device)
        print(f"resumed from step {start_step}")

    data_rng = np.random.default_rng(0)
    for _ in range(start_step):          # the batches the resumed steps took
        step_batch(data_rng, cfg, args.batch, args.seq, "meta")
    n_params = count_params(params)
    print(f"training {args.arch} ({n_params/1e6:.1f}M params, "
          f"{cfg.optimizer}) for {args.steps} steps on {device}")
    losses, step_s = [], []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = step_batch(data_rng, cfg, args.batch, args.seq, device)
        params, opt_state, loss = train_step(model, opt, params, opt_state,
                                             batch)
        loss = float(loss)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"  step {step:4d} loss={loss:.4f} ({step_s[-1]:.2f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt_state": opt_state},
                     extra={"arch": args.arch})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt_state": opt_state},
                 extra={"arch": args.arch})
        print(f"checkpointed at {args.ckpt_dir}")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_s": step_s, "start_step": start_step, "n_params": n_params}


if __name__ == "__main__":
    main()
