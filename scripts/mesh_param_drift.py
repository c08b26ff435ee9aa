#!/usr/bin/env python3
"""How far a 2x2 mesh run's params stray from 1x1 runs', round by round,
on one card.

    python3 scripts/mesh_param_drift.py

Needs one CUDA card and ``nvcc``; imports neither ``jax`` nor ``repro``.
Runs the paper's MNIST setup (``chip_smoke.paper_kw``, ``apodotiko``,
stepwise, ``chip_smoke.MESH_ROUNDS`` rounds) at 1x1 on the card three
times, under torch's default algorithms and twice under
deterministic ones, then four ranks at 2x2 over gloo on the card
(``scripts/torch_mesh_child.py``, deterministic), and prints one JSON line
a round: for each pair, the largest error over chip_smoke's PARAM_RTOL /
PARAM_ATOL and the largest absolute difference. The pairs: the two
deterministic 1x1 runs (the floor: 0 if the card repeats itself), default
against deterministic 1x1 (the algorithms' rounding alone), and 2x2 rank
0 against each 1x1 run (the lane split, the psum's order and the
algorithms together). Then the lane split alone, at 1x1: the first
cohort of the 1x1 run (its 128 padded lanes, one drawn index table)
trained in one call and again as two calls of 64 lanes, as a 2x2 data
rank trains them (``chip_smoke.split_lanes``), after 1 local step and after the cohort's full budget:
the largest difference of any lane's trained row.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
for mod in ("jax", "repro"):          # the port must not need either
    sys.modules[mod] = None

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


STRATEGY = "apodotiko"


def one_by_one(data, dev, deterministic: bool) -> list:
    """The params after each round of a 1x1 run, on the CPU."""
    eng = cs.paper_engine(STRATEGY, cs.MESH_ROUNDS, data, dev,
                          megastep="stepwise")
    out = []
    torch.use_deterministic_algorithms(deterministic)
    try:
        eng.run(progress=lambda log: out.append(
            {k: v.detach().cpu() for k, v in eng.params.items()}))
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def lane_split(data, dev, steps: int) -> dict:
    """One cohort trained whole and as two halves from one index table."""
    import numpy as np
    from repro_torch.core.client import CohortTrainer
    from repro_torch.core.data_plane import DatasetStore
    from repro_torch.models.paper_models import MnistCNN

    model = MnistCNN()
    params = {k: v.to(dev) for k, v in
              model.init(torch.Generator().manual_seed(cs.SEED)).items()}
    ds = DatasetStore(data, device=dev)
    t = CohortTrainer(model, optimizer="adam", lr=1e-3, batch_size=10,
                      seed=cs.SEED, device=dev)
    kp = 128
    sel = torch.arange(kp, device=dev)
    n = torch.as_tensor(np.asarray(data.n[:kp]), device=dev)
    budget = torch.full((kp,), steps, dtype=torch.int32, device=dev)
    table = t._draw_indices(kp, steps, n)
    W = -(-sum(v.numel() for v in params.values()) // 1024) * 1024
    torch.use_deterministic_algorithms(True)
    try:
        t.batch_indices = lambda Kp, ms, n_i: table
        whole = t._train_lanes(params, ds, sel, n, budget, steps, W)[0]
        cs.split_lanes(t, 2)
        halves = t._train_lanes(params, ds, sel, n, budget, steps, W)[0]
    finally:
        torch.use_deterministic_algorithms(False)
    diff = (whole - halves).abs()
    return {"steps": steps, "max_abs": float(diff.max()),
            "lanes_differing": int((diff.amax(1) > 0).sum())}


def compare(a: dict, b: dict) -> dict:
    return {"err_over_tol": cs.close_params(a, b),
            "max_abs": max(float((a[k] - b[k]).abs().max()) for k in a)}


def main() -> int:
    if not torch.cuda.is_available():
        return cs.fail("no CUDA card is available; this script runs only "
                       "on one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda", 0)
    data = make_federated_dataset(**cs.MAIN_DATA)
    default = one_by_one(data, dev, False)
    det = one_by_one(data, dev, True)
    det2 = one_by_one(data, dev, True)
    run = dict(name=STRATEGY, data=cs.MAIN_DATA, model="MnistCNN",
               fleet="paper", per_round=True,
               cfg=cs.paper_kw(STRATEGY, cs.MESH_ROUNDS,
                               megastep="stepwise"))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spec = dict(mesh=cs.MESH_SPEC, world=cs.MESH_WORLD,
                    init=str(tmp / "rendezvous"), out=str(tmp),
                    device=str(dev), runs=[run])
        (tmp / "spec.json").write_text(json.dumps(spec))
        t0 = time.perf_counter()
        cs.wait_ranks(cs.start_ranks(tmp / "spec.json", tmp, cs.MESH_WORLD),
                      tmp, cs.MESH_TIMEOUT_S)
        mesh = torch.load(tmp / f"rank0_{STRATEGY}.pt")["rounds"]
    for r in range(cs.MESH_ROUNDS):
        cs.emit("mesh_param_drift", strategy=STRATEGY, round=r,
                det_vs_det=compare(det2[r], det[r]),
                default_vs_det=compare(default[r], det[r]),
                mesh_vs_det=compare(mesh[r], det[r]),
                mesh_vs_default=compare(mesh[r], default[r]))
    cs.emit("mesh_param_drift_seconds", mesh_s=time.perf_counter() - t0)
    for steps in (1, 150):
        cs.emit("lane_split_drift", **lane_split(data, dev, steps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
