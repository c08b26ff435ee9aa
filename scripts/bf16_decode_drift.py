#!/usr/bin/env python3
"""How far a bf16 decode strays from the bf16 full forward, in the JAX
reference and in the PyTorch port, for any LM config cut to a few layers.
CPU only; like the parity tests it imports both packages and starts the
port from the reference's params.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_decode_drift.py \\
        --arch mamba2-370m --layers 4 8 16 [--batch 2 --prompt 64 --steps 16]

For each depth: the prompt is prefilled into a cache, then ``steps - 1``
decode steps feed the prompt's continuation (teacher forced); each
position's logits are held against the full forward's over the same
tokens, as the relative L2 error over the vocabulary. A VLM sees normal
patches at all its positions, its gates set to ``GATE`` in the
reference's params (drawn as zeros, they would hide cross attention); an
enc-dec sees normal frames as long as the prompt (both drawn as a serving
run draws them, ``launch.train.memory_inputs``). Prints one JSON line a
depth: the reference's max and median, the port's, and the relative L2
between the two packages' full forwards (how far two faithful bf16
computations of the same model lie apart). The decode step and the
prefill round otherwise than the full forward (one query row against a
cache; for the SSM the conv as an einsum over the window against the
unrolled one, ``dt * x`` in fp32 against bf16), and a random-init stack
amplifies the difference with depth. ``--layers`` counts as
``launch.train --layers`` does (a VLM's in whole chunks, an enc-dec's
split evenly); ``drift(..., smoke=True)`` takes the smoke config's
widths. Keep the cuts small: a full-depth run is the card's job.
"""
import argparse
import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models.api import build_model as jbuild_model
from repro_torch.configs import base
from repro_torch.launch.train import cut_depth, memory_inputs
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy

GATE = 0.5


def rel_l2(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (np.linalg.norm(got - want, axis=-1)
            / np.linalg.norm(want, axis=-1))


def reference_rows(jlm, jp, tok, prompt: int, steps: int, memory: dict):
    mem = {k: jnp.asarray(v) for k, v in memory.items()}
    full = jax.jit(lambda p, t: jlm.apply(p, {"tokens": t, **mem})[0])(
        jp, jnp.asarray(tok))
    logits, cache, _ = jlm.apply(
        jp, {"tokens": jnp.asarray(tok[:, :prompt]), **mem},
        make_cache=True, cache_len=prompt + steps)
    rows = [np.asarray(logits[:, -1], np.float32)]
    step = jax.jit(jlm.decode_step)
    for i in range(steps - 1):
        logits, cache = step(jp, cache,
                             jnp.asarray(tok[:, prompt + i:prompt + i + 1]),
                             jnp.int32(prompt + i))
        rows.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(rows, 1), np.asarray(full, np.float32)


@torch.no_grad()
def port_rows(lm, p, tok, prompt: int, steps: int, memory: dict):
    t = torch.as_tensor(tok)
    mem = {k: torch.as_tensor(v) for k, v in memory.items()}
    full = lm.apply(p, {"tokens": t, **mem})[0].float().numpy()
    logits, cache, _ = lm.apply(p, {"tokens": t[:, :prompt], **mem},
                                make_cache=True, cache_len=prompt + steps)
    rows = [logits[:, -1].float().numpy()]
    for i in range(steps - 1):
        logits, cache = lm.decode_step(p, cache, t[:, prompt + i:prompt + i + 1],
                                       prompt + i)
        rows.append(logits[:, 0].float().numpy())
    return np.stack(rows, 1), full


def configs(arch: str, layers: int, dtype: str, smoke: bool = False) -> tuple:
    """(reference config, port config) of ``arch`` cut to ``layers`` in
    ``dtype``."""
    cfg = cut_depth(base.get_config(arch, smoke=smoke), layers).with_(param_dtype=dtype,
                                       compute_dtype=dtype)
    jcfg = jbase.get_config(arch, smoke=smoke).with_(**{
        k: getattr(cfg, k) for k in ("n_layers", "enc_layers", "dec_layers",
                                     "param_dtype", "compute_dtype")})
    return jcfg, cfg


def drift(arch: str, layers: int, batch: int = 2, prompt: int = 64,
          steps: int = 16, dtype: str = "bfloat16",
          smoke: bool = False) -> dict:
    """One depth's record (see the module docstring)."""
    jcfg, cfg = configs(arch, layers, dtype, smoke)
    jlm, lm = jbuild_model(jcfg), build_model(cfg)
    jp = jlm.init(jax.random.PRNGKey(0))[0]
    if cfg.family == "vlm":
        gate = jp["layers"]["cross"]["xattn"]["gate"]
        jp["layers"]["cross"]["xattn"]["gate"] = jnp.full_like(gate, GATE)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size,
                       (batch, prompt + steps)).astype(np.int32)
    memory = {k: v.numpy() for k, v in memory_inputs(
        cfg, batch, prompt, torch.Generator().manual_seed(0), "cpu").items()}
    window = slice(prompt - 1, prompt + steps - 1)
    jdec, jfull = reference_rows(jlm, jp, tok, prompt, steps, memory)
    dec, full = port_rows(lm, p, tok, prompt, steps, memory)
    ref, port = rel_l2(jdec, jfull[:, window]), rel_l2(dec, full[:, window])
    return {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": dtype, "batch": batch, "prompt": prompt, "steps": steps,
            "reference_max": float(ref.max()),
            "reference_median": float(np.median(ref)),
            "port_max": float(port.max()),
            "port_median": float(np.median(port)),
            "full_forward_port_vs_reference_median": float(
                np.median(rel_l2(full, jfull)))}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)

    out = []
    for n in args.layers:
        rec = drift(args.arch, n, args.batch, args.prompt, args.steps,
                    args.dtype)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
