#!/usr/bin/env python3
"""How far a bf16 decode strays from the bf16 full forward, in the JAX
reference and in the PyTorch port, for the SSM and hybrid LMs at their
published width cut to a few layers. CPU only; like the parity tests it
imports both packages and starts the port from the reference's params.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ssm_bf16_drift.py \\
        --arch mamba2-370m --layers 4 8 16 [--batch 2 --prompt 64 --steps 16]

For each depth: the prompt is prefilled into a cache, then ``steps - 1``
decode steps feed the prompt's continuation (teacher forced); each
position's logits are held against the full forward's over the same
tokens, as the relative L2 error over the vocabulary. Prints one JSON line
a depth: the reference's max and median, the port's, and the relative L2
between the two packages' full forwards (how far two faithful bf16
computations of the same model lie apart). The decode step and the
prefill round otherwise than the full forward (the conv as an einsum over
the window against the unrolled one; ``dt * x`` in fp32 against bf16), and
the random-init stack amplifies the difference with depth. Keep the cuts
small: a full-depth run is the card's job.
"""
import argparse
import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models.lm import DecoderLM as JaxDecoderLM
from repro_torch.configs import base
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import DecoderLM


def rel_l2(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (np.linalg.norm(got - want, axis=-1)
            / np.linalg.norm(want, axis=-1))


def reference_rows(jlm, jp, tok, prompt: int, steps: int):
    full = jax.jit(lambda p, t: jlm.apply(p, {"tokens": t})[0])(
        jp, jnp.asarray(tok))
    logits, cache, _ = jlm.apply(jp, {"tokens": jnp.asarray(tok[:, :prompt])},
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
def port_rows(lm, p, tok, prompt: int, steps: int):
    t = torch.as_tensor(tok)
    full = lm.apply(p, {"tokens": t})[0].float().numpy()
    logits, cache, _ = lm.apply(p, {"tokens": t[:, :prompt]},
                                make_cache=True, cache_len=prompt + steps)
    rows = [logits[:, -1].float().numpy()]
    for i in range(steps - 1):
        logits, cache = lm.decode_step(p, cache, t[:, prompt + i:prompt + i + 1],
                                       prompt + i)
        rows.append(logits[:, 0].float().numpy())
    return np.stack(rows, 1), full


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
        over = dict(n_layers=n, param_dtype=args.dtype,
                    compute_dtype=args.dtype)
        jlm = JaxDecoderLM(jbase.get_config(args.arch).with_(**over))
        lm = DecoderLM(base.get_config(args.arch).with_(**over))
        jp = jlm.init(jax.random.PRNGKey(0))[0]
        p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        tok = np.random.default_rng(0).integers(
            0, lm.cfg.vocab_size,
            (args.batch, args.prompt + args.steps)).astype(np.int32)
        window = slice(args.prompt - 1, args.prompt + args.steps - 1)
        jdec, jfull = reference_rows(jlm, jp, tok, args.prompt, args.steps)
        dec, full = port_rows(lm, p, tok, args.prompt, args.steps)
        ref, port = rel_l2(jdec, jfull[:, window]), rel_l2(dec, full[:, window])
        rec = {"arch": args.arch, "n_layers": n, "dtype": args.dtype,
               "batch": args.batch, "prompt": args.prompt,
               "steps": args.steps,
               "reference_max": float(ref.max()),
               "reference_median": float(np.median(ref)),
               "port_max": float(port.max()),
               "port_median": float(np.median(port)),
               "full_forward_port_vs_reference_median": float(
                   np.median(rel_l2(full, jfull)))}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
