"""The plain reference that decides ``correct``: straightforward torch and
numpy, written from the paper's definitions, importing nothing of the
program.

It follows the program from the program's own state at the sampled points
(the global model a cohort trains from, the trainer generator's position,
the fleet's scoring columns and the selection RNG's position, the rows an
aggregation reads) and works out again, from the benchmark's own dataset,
what the program computed there:

  * ``minibatch_indices``: each lane's minibatch draw (uniform in
    ``[0, n)``, one ``[Kp, steps, B]`` block a cohort);
  * ``gradient``: a lane's loss and gradient at one local step, from the
    parameters the program held there: the configuration's forward, its
    mean cross-entropy and autograd, fp32 with TF32 off;
  * ``adam_step``: Adam (Kingma & Ba) with bias correction, float64: the
    parameters and both moments it writes;
  * ``aggregate``: Eq. 2 staleness weights ``n_i / sqrt(T - t_i + 1)``,
    normalised, and the weighted sum of the rows in float64;
  * ``select_apodotiko``: Algorithm 3 (windowed CEF scores, probabilities,
    sampling without replacement, booster update).

``tf32`` rounds a tensor to TF32's 10-bit mantissa in the forward pass and
its gradient in the backward pass: the control's precision. The control
of the Adam moments, whose configuration states fp32, stores them in bf16
(the step a change that halves the optimizer's bytes would take).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (forward) with its gradient rounded alike."""
    return _TF32.apply(x)


def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def ravel(params: dict) -> torch.Tensor:
    """Leaves in sorted-name order (the published pytree order) as one
    flat fp32 vector."""
    return torch.cat([params[k].reshape(-1).float() for k in sorted(params)])


def unravel(flat: torch.Tensor, leaves: dict) -> dict:
    out, off = {}, 0
    for name in sorted(leaves):
        shape = leaves[name][0]
        n = math.prod(shape)
        out[name] = flat[off:off + n].reshape(shape)
        off += n
    return out


def bucket(k: int, floor: int = 2) -> int:
    """Lanes a cohort of ``k`` clients pads to: the next power-of-two
    multiple of ``floor``."""
    b = floor
    while b < k:
        b *= 2
    return b


def step_budget(n: np.ndarray, batch: int, epochs: int) -> np.ndarray:
    """E local epochs of ceil(n / B) minibatches, at least one step."""
    return np.maximum(np.ceil(n / batch).astype(np.int64) * epochs, 1)


def minibatch_indices(gen_state: torch.Tensor, n_lanes: np.ndarray,
                      steps: int, batch: int, device) -> torch.Tensor:
    """``[Kp, steps, B]`` indices, uniform in ``[0, max(n, 1))`` a lane,
    drawn from a generator at ``gen_state``."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    u = torch.rand((len(n_lanes), steps, batch), generator=gen,
                   device=device)
    n = torch.clamp(torch.as_tensor(n_lanes, device=device), min=1)
    n = n[:, None, None]
    return torch.minimum((u * n).long(), n - 1)


def gradient(model_ref, params: dict, xb: torch.Tensor, yb: torch.Tensor,
             cast=None):
    """The mean cross-entropy of a minibatch at ``params`` and its gradient
    by autograd: ``(grads, loss)``, fp32 with TF32 off, or with ``cast``
    rounding every product's inputs."""
    _no_tf32()
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in params.items()}
    logits = (model_ref.forward(p, xb) if cast is None
              else model_ref.forward(p, xb, cast))
    loss = F.cross_entropy(logits, yb.long())
    grads = torch.autograd.grad(loss, list(p.values()))
    return dict(zip(p, grads)), float(loss.detach())


def adam_step(p, m, v, g, t: int, lr: float, adam: dict):
    """Adam's step ``t`` (Kingma & Ba, bias-corrected) in float64: the new
    parameters and the new first and second moments."""
    b1, b2, eps = adam["b1"], adam["b2"], adam["eps"]
    p, m, v, g = (x.double() for x in (p, m, v, g))
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    p = p - lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
    return p, m, v


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


def leaf_gap(got: dict, want: dict, scale: dict) -> float:
    """The worst leaf's ``||got - want||`` over the larger of that leaf's
    ``scale`` and the median leaf's: a leaf whose scale is nought to
    rounding is measured against the median leaf."""
    med = float(np.median(list(scale.values())))
    return max(float(torch.linalg.vector_norm((got[k] - want[k]).double()))
               / max(scale[k], med) for k in want)


def moment_gap(m, v, m_ref, v_ref, leaves: dict) -> float:
    """The worse of the first and second moments' ``leaf_gap``, each leaf
    against the reference's own norm of it."""
    gaps = []
    for got, want in ((m, m_ref), (v, v_ref)):
        want = unravel(want, leaves)
        gaps.append(leaf_gap(unravel(got, leaves), want, leaf_norms(want)))
    return max(gaps)


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``||got - want|| / ||want||`` in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def eq2(t_i: float, T: float) -> float:
    """Apodotiko's staleness damping (Eq. 2): 1 / sqrt(T - t_i + 1)."""
    return 1.0 / math.sqrt(max(T - t_i, 0.0) + 1.0)


def aggregate(rows: torch.Tensor, meta: list, T: int, cast=None
              ) -> torch.Tensor:
    """The staleness-weighted mean of ``rows`` [K, W]; ``meta`` holds each
    row's ``(t_i, n_i)``. float64, or the control's ``cast`` then fp32."""
    w = np.array([eq2(t, T) * n for t, n in meta], np.float64)
    w = w / w.sum()
    if cast is None:
        wt = torch.as_tensor(w, device=rows.device)
        return (wt[:, None] * rows.double()).sum(0)
    wt = cast(torch.as_tensor(w, dtype=torch.float32, device=rows.device))
    return (wt[:, None] * cast(rows.float())).sum(0)


def select_apodotiko(state: dict, k: int, rho: float, window: int = 10):
    """Algorithm 3 on the fleet columns ``state`` (registration order).
    Returns the selected client ids and every slot's booster after."""
    idle = (state["status"] == 0) & (state["quarantined_until"]
                                     <= state["round"])
    ever = state["n_invocations"] > 0
    unv, inv = np.flatnonzero(idle & ~ever), np.flatnonzero(idle & ever)
    rng = np.random.default_rng()
    rng.bit_generator.state = state["rng"]
    ids = state["ids"]
    if len(unv) >= k:
        picks = rng.choice(len(unv), size=k, replace=False)
        sel = [int(ids[unv[i]]) for i in picks]
    else:
        sel = [int(c) for c in ids[unv]]
        need = min(k - len(sel), len(inv))
        if need > 0:
            lam = 1.0 - rho
            scores = np.zeros(len(inv))
            for j, s in enumerate(inv):
                n, e, b = (state["cardinality"][s], state["local_epochs"][s],
                           state["batch_size"][s])
                upd = n * e / max(b, 1)
                ws = norm = 0.0
                w = 1.0
                for t in state["durations"][s, :min(state["dur_len"][s],
                                                    window)]:
                    ws += w * n * (upd / max(t, 1e-9))
                    norm += w
                    w *= lam
                scores[j] = state["booster"][s] * ws / norm if norm else 0.0
            smax = scores.max()
            probs = (np.full(len(inv), 1.0 / len(inv)) if smax <= 0
                     else (scores / smax) / (scores / smax).sum())
            need = min(need, int(np.count_nonzero(probs)))
            if need > 0:
                picks = rng.choice(len(inv), size=need, replace=False,
                                   p=probs)
                sel += [int(ids[inv[i]]) for i in picks]
    booster = state["booster"].copy()
    chosen = np.isin(ids, sel)
    booster[idle & ~chosen] *= 1.0 + rho
    booster[chosen] = 1.0
    return sel, booster
