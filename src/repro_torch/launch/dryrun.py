"""Dry run of every (architecture x input-shape x mesh) cell (twin of
``repro.launch.dryrun``).

On the production meshes (16x16, 2x16x16; abstract: axis names and sizes)
each cell is built (its in / out specs from the logical axes) and its step
traced once on ``meta`` tensors at full width (``launch.roofline.
MetaTrace``: FLOPs and bytes of the whole program, nothing allocated). A
record holds the specs, the arguments' bytes per device as the specs
divide them, and the trace's global counts; a per-device roofline term
needs a partitioner the port does not have, so each is None. On the
card's ``1x1`` mesh (``--mesh card``) the counterpart of the reference's
compile and ``memory_analysis()`` is to run the cell on the card: the
record holds the step's time (CUDA events), ``max_memory_allocated``, the
meta trace's counts at the same cut and the roofline with the H100's
constants. It raises without a card: it never runs a cell on the CPU in
its place.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --cost-mode auto --out results/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card \\
      --arch qwen3-1.7b --shape train_4k --batch 1 --remat on
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,
                                      get_config, shape_supported)
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.ops import tree_leaves
from repro_torch.launch.mesh import (PEAK_FLOPS_BF16, make_card_mesh,
                                     make_production_mesh)
from repro_torch.launch.roofline import MetaTrace, analyze
from repro_torch.launch.steps import Cell, build_cell
from repro_torch.sharding.rules import P

COST_MODES = ("unroll", "extrapolate", "auto")
EXTRAPOLATED_FAMILIES = ("ssm", "hybrid")   # ``auto``: their chunk loops


def _jsonable(specs):
    """A spec tree (or a tuple of them) as JSON: each ``P`` a list of its
    entries, a multi-axis entry a list of names."""
    if isinstance(specs, P):
        return [list(e) if isinstance(e, tuple) else e for e in specs]
    if isinstance(specs, dict):
        return {k: _jsonable(v) for k, v in specs.items()}
    return [_jsonable(v) for v in specs]


def _cell_fields(cell: Cell) -> dict:
    return {"kind": cell.kind, "total_params": cell.total_params(),
            "variant": cell.variant, "rules": cell.rules,
            "argument_bytes_per_device": cell.argument_bytes_per_device(),
            "in_specs": _jsonable(cell.in_shardings),
            "out_specs": _jsonable(cell.out_shardings)}


def _error(arch: str, shape_name: str, mesh_name: str, t0: float,
           e: BaseException) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
            "compile_s": time.time() - t0}


def _skip(arch: str, shape: ShapeConfig, mesh_name: str) -> Optional[dict]:
    ok, reason = shape_supported(get_config(arch), shape)
    if ok:
        return None
    return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "status": "skipped", "reason": reason}


def _print_roofline(tag: str, rec: dict) -> None:
    if rec.get("compute_s") is None:
        print(f"  {tag}: flops={rec['flops_global']:.4g} "
              f"bytes={rec['bytes_global']:.4g} (global; per-device terms "
              "need a partitioner)")
        return
    print(f"  {tag}: compute={rec['compute_s']*1e3:.2f}ms "
          f"memory={rec['memory_s']*1e3:.2f}ms "
          f"collective={rec['collective_s']*1e3:.2f}ms "
          f"bottleneck={rec['bottleneck']} "
          f"useful_ratio={rec['useful_ratio']:.2f} mfu={rec['mfu']:.3f}")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides=None, rules_override=None, verbose: bool = True,
             roofline: bool = True, variant: str = "baseline") -> dict:
    """Build one cell on a production mesh and trace its step on ``meta``
    tensors at full depth; returns a result dict (or a skip / error
    record). With ``roofline`` False only the specs are built."""
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh.name
    skipped = _skip(arch, shape, mesh_name)
    if skipped:
        return skipped
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, overrides=overrides,
                          rules_override=rules_override, variant=variant)
        compile_s = time.time() - t0
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "ok", "compile_s": compile_s,
               "cost_mode": "meta-trace", **_cell_fields(cell)}
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] built in "
                  f"{compile_s:.1f}s, "
                  f"{rec['argument_bytes_per_device'] / 2**30:.2f} GiB of "
                  "arguments a device")
        if not roofline:
            rec["peak_memory_per_device"] = None
            return rec
        t1 = time.time()
        trace = cell.trace()
        rec["unroll_compile_s"] = time.time() - t1
        rec.update(_trace_record(cell, trace, mesh_name, mesh.size,
                                 compile_s))
        if verbose:
            _print_roofline("roofline", rec)
        return rec
    except Exception as e:  # noqa: BLE001 — report, don't die mid-sweep
        return _error(arch, shape_name, mesh_name, t0, e)


def _trace_record(cell: Cell, trace: MetaTrace, mesh_name: str,
                  n_devices: int, compile_s: float,
                  peak: Optional[float] = None) -> dict:
    roof = analyze(trace.flops, trace.bytes, arch=cell.arch,
                   shape=cell.shape, mesh_name=mesh_name, n_devices=n_devices,
                   cfg=cell.cfg, total_params=cell.total_params(),
                   kind=cell.kind, compile_s=compile_s, peak_memory=peak)
    rec = roof.to_dict()
    rec.update({"flops_global": trace.flops, "bytes_global": trace.bytes,
                "kernel_traffic": trace.kernels})
    return rec


PROBE_DEPTHS = {
    # (L1, L2) reduced depths for cost extrapolation, respecting each arch's
    # structural period (hybrid attn_period=6, vlm cross period=4, deepseek
    # first dense layer, enc-dec symmetric stacks)
    "qwen3-1.7b": (4, 8), "granite-8b": (4, 8), "yi-6b": (4, 8),
    "qwen3-4b": (4, 8), "llama-3.2-vision-11b": (4, 8),
    "zamba2-2.7b": (6, 12), "deepseek-v2-lite-16b": (4, 7),
    "arctic-480b": (4, 8), "mamba2-370m": (4, 8),
    "seamless-m4t-large-v2": (4, 8),
}


def _depth_overrides(arch: str, L: int) -> dict:
    ov = {"n_layers": L, "unroll_layers": True}
    if arch == "seamless-m4t-large-v2":
        ov["enc_layers"] = L // 2
        ov["dec_layers"] = L // 2
    return ov


def run_cell_extrapolated(arch: str, shape_name: str, *,
                          multi_pod: bool = False, overrides=None,
                          verbose: bool = True) -> dict:
    """Counts from two ``meta`` traces at ``PROBE_DEPTHS`` and the
    reference's linear extrapolation in layer count (per-layer cost is
    depth-independent for homogeneous stacks). For the SSM and hybrid
    families, whose chunk loops take tens of seconds to trace at full
    depth on a host CPU. The full-depth cell still gives the specs and
    the argument bytes."""
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh.name
    skipped = _skip(arch, shape, mesh_name)
    if skipped:
        return skipped
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, overrides=overrides)
        cfg = cell.cfg              # the depth the counts extrapolate to
        compile_s = time.time() - t0
        L1, L2 = PROBE_DEPTHS[arch]
        probes = []
        t1 = time.time()
        for L in (L1, L2):
            ov = dict(overrides or {})
            ov.update(_depth_overrides(arch, L))
            probes.append(build_cell(arch, shape, mesh, overrides=ov).trace())
        unroll_compile_s = time.time() - t1

        def extrap(v1, v2):
            slope = (v2 - v1) / (L2 - L1)
            return max(v1 + slope * (cfg.n_layers - L1), 0.0)

        p1, p2 = probes
        trace = MetaTrace()
        trace.flops = extrap(p1.flops, p2.flops)
        trace.bytes = extrap(p1.bytes, p2.bytes)
        trace.kernels = {k: {f: extrap(v[f], p2.kernels[k][f]) for f in v}
                         for k, v in p1.kernels.items()}
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "ok", "compile_s": compile_s,
               "cost_mode": "meta-trace", "probe_depths": [L1, L2],
               "unroll_compile_s": unroll_compile_s, **_cell_fields(cell)}
        rec.update(_trace_record(cell, trace, mesh_name, mesh.size,
                                 compile_s))
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] built in "
                  f"{compile_s:.1f}s, probes {unroll_compile_s:.1f}s")
            _print_roofline(f"roofline(extrap[{L1},{L2}])", rec)
        return rec
    except Exception as e:  # noqa: BLE001
        return _error(arch, shape_name, mesh_name, t0, e)


def cut_shape(shape: ShapeConfig, global_batch: Optional[int] = None,
              seq_len: Optional[int] = None) -> tuple[ShapeConfig, dict]:
    """``shape`` with its batch and / or sequence cut (so that a cell fits
    the card), and the cut as a record names it (None for no cut)."""
    cut = {}
    if global_batch is not None and global_batch != shape.global_batch:
        cut["global_batch"] = [shape.global_batch, global_batch]
    if seq_len is not None and seq_len != shape.seq_len:
        cut["seq_len"] = [shape.seq_len, seq_len]
    if not cut:
        return shape, None
    return ShapeConfig(shape.name, seq_len or shape.seq_len,
                       global_batch or shape.global_batch, shape.kind), cut


def _outputs_finite(out) -> bool:
    leaves = tree_leaves(list(out) if isinstance(out, tuple) else out)
    return all(bool(torch.isfinite(t).all()) for t in leaves
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def execute_cell(arch: str, shape_name: str, *,
                 global_batch: Optional[int] = None,
                 seq_len: Optional[int] = None, overrides=None,
                 variant: str = "baseline", device=None,
                 seed: int = 0, verbose: bool = True) -> dict:
    """Run one cell on the card's ``1x1`` mesh (``device``: the card
    unless the caller passes another), cut to ``global_batch`` /
    ``seq_len`` where given. The step runs twice on real arguments
    (``Cell.make_args``; a train step's second run takes the first's
    params and state): the first under ``FlopCounterMode``, whose count
    must equal the meta trace's at the same cut, the second timed (CUDA
    events on the card); every floating output must be finite. The record
    holds the roofline at the cut with the H100's constants, the step's
    time and ``measured_mfu`` (model FLOPs at the cut over the time and
    the card's bf16 peak), ``max_memory_allocated`` from the arguments on
    as ``peak_memory_per_device``, each hand kernel's launches in the
    timed run, and ``cut``; and, for the caller to check and drop before
    the record is written, ``args`` and ``outputs``: the timed run's."""
    device = resolve_device(device)
    shape, cut = cut_shape(SHAPES[shape_name], global_batch, seq_len)
    mesh = make_card_mesh()
    skipped = _skip(arch, shape, mesh.name)
    if skipped:
        return skipped
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, overrides=overrides,
                          variant=variant)
        compile_s = time.time() - t0
        t1 = time.time()
        trace = cell.trace()
        trace_s = time.time() - t1
        args = cell.make_args(device, seed=seed)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        counter = torch.utils.flop_counter.FlopCounterMode(display=False)
        with counter:
            out = cell.fn(*args)
        card_flops = int(counter.get_total_flops())
        if card_flops != trace.flops:
            raise AssertionError(f"{arch} x {shape_name}: the run counted "
                                 f"{card_flops} FLOPs, its meta trace "
                                 f"{trace.flops}")
        if cell.kind == "train":
            args = (out[0], out[1], args[2])
        del out
        launches = launch_counts()
        if cuda:
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
        t2 = time.perf_counter()
        out = cell.fn(*args)
        if cuda:
            stop.record()
            torch.cuda.synchronize(device)
            step_s = start.elapsed_time(stop) / 1e3
        else:
            step_s = time.perf_counter() - t2
        launches = {k: n - launches[k] for k, n in launch_counts().items()}
        finite = _outputs_finite(out)
        if not finite:
            raise AssertionError(f"{arch} x {shape_name}: a non-finite "
                                 "output")
        peak = float(torch.cuda.max_memory_allocated(device)) if cuda \
            else None
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
               "status": "ok", "compile_s": compile_s,
               "cost_mode": "meta-trace", "unroll_compile_s": trace_s,
               "cut": cut, "device": str(device), **_cell_fields(cell)}
        rec.update(_trace_record(cell, trace, mesh.name, mesh.size,
                                 compile_s, peak))
        rec.update({"step_s": step_s, "card_flops": card_flops,
                    "kernel_launches": launches, "finite": finite,
                    "measured_mfu": rec["model_flops_global"]
                    / (step_s * PEAK_FLOPS_BF16)})
        rec["args"], rec["outputs"] = args, out
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh.name}] step "
                  f"{step_s*1e3:.1f} ms, "
                  f"peak {(peak or 0) / 1e9:.2f} GB, cut {cut}")
            _print_roofline("roofline", rec)
        return rec
    except Exception as e:  # noqa: BLE001
        return _error(arch, shape_name, mesh.name, t0, e)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id, or ids comma-separated (or --all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="input shape (default: all five)")
    ap.add_argument("--all", action="store_true", help="all 10 architectures")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--remat", default=None, choices=["on", "off"])
    ap.add_argument("--zero1", default=None, choices=["on", "off"])
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--no-roofline", action="store_true",
                    help="specs only (skip the meta trace)")
    ap.add_argument("--variant", default="baseline",
                    help="cell variant (e.g. scatter_bf16 for fl_round)")
    ap.add_argument("--cost-mode", default="unroll", choices=COST_MODES,
                    help="costing: one meta trace at full depth, 2-point "
                         "depth extrapolation, or auto (extrapolate the "
                         "ssm and hybrid families, unroll the rest)")
    ap.add_argument("--mesh", default="production",
                    choices=["production", "card"],
                    help="the abstract production meshes (meta traces), or "
                         "run each cell on the card's 1x1 mesh")
    ap.add_argument("--batch", type=int, default=None,
                    help="--mesh card: cut the shape's global batch to this")
    ap.add_argument("--seq", type=int, default=None,
                    help="--mesh card: cut the shape's sequence to this")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all or not args.arch else \
        args.arch.split(",")
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]

    overrides = {}
    if args.remat:
        overrides["remat"] = args.remat == "on"
    if args.zero1:
        overrides["zero1"] = args.zero1 == "on"
    if args.optimizer:
        overrides["optimizer"] = args.optimizer
    if args.mesh == "card":
        resolve_device()        # no card: raise, never run on the CPU
        _build.build()
        pods = [None]

    n_err = 0
    for arch in archs:
        family = get_config(arch).family
        for shape in shapes:
            for mp in pods:
                extrap = args.cost_mode == "extrapolate" or (
                    args.cost_mode == "auto"
                    and family in EXTRAPOLATED_FAMILIES)
                if mp is None:
                    rec = execute_cell(arch, shape, global_batch=args.batch,
                                       seq_len=args.seq,
                                       overrides=overrides or None,
                                       variant=args.variant)
                    rec.pop("args", None)
                    rec.pop("outputs", None)
                elif extrap and not args.no_roofline:
                    rec = run_cell_extrapolated(arch, shape, multi_pod=mp,
                                                overrides=overrides or None)
                else:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   overrides=overrides or None,
                                   roofline=not args.no_roofline,
                                   variant=args.variant)
                if rec["status"] == "error":
                    n_err += 1
                    print(f"[{arch} x {shape} x {rec['mesh']}] ERROR: "
                          f"{rec['error']}", file=sys.stderr)
                    print(rec.get("traceback", ""), file=sys.stderr)
                elif rec["status"] == "skipped":
                    print(f"[{arch} x {shape}] skipped: {rec['reason']}")
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
