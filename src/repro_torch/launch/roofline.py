"""Roofline terms of a cell (twin of ``repro.launch.roofline``).

Per (arch x shape x mesh):
  compute_s    = FLOPs_per_device / PEAK_FLOPS_BF16
  memory_s     = bytes_per_device / HBM_BW
  collective_s = collective_bytes_per_device / ICI_BW

with the H100 SXM's constants (``launch.mesh``). The reference reads its
counts from XLA's ``cost_analysis()`` of the compiled, SPMD-partitioned
program. The port's counterpart is ``MetaTrace``: the cell's step run once
on ``meta`` tensors (shapes only, nothing allocated or computed), its
FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode`` and its
bytes by a dispatch mode over every aten op. Those are the counts of the
whole, unpartitioned program: per device they are the counts themselves on
the card's ``1x1`` mesh, and unknown on a wider mesh without a partitioner
(``None``, never an invented number). The port issues no collective until
its mesh slice, so the collective term is 0 on ``1x1``.
``collective_bytes_per_device``, the reference's HLO parser, is kept as
it is for that slice.

MODEL_FLOPS (analytic useful compute) = 6*N*D for dense training,
6*N_active*D for MoE; 2*N*D for pure forward (prefill/decode); attention
score/value FLOPs are added separately. The ratio MODEL_FLOPS/counted FLOPs
exposes remat recompute, full-square causal attention and dispatch waste.
"""
from __future__ import annotations

import collections
import re
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import _build
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", re.M)
_SHAPE_RE = re.compile(r"(pred|s8|u8|s16|u16|f16|bf16|s32|u32|f32|s64|u64|f64|c64|c128)"
                       r"\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes_per_device(hlo_text: str, n_devices: int) -> dict:
    """Sum effective bytes moved per device, by collective kind.

    Ring-transfer factors (payload = result bytes, group size g):
      all-reduce: 2 (g-1)/g, all-gather/reduce-scatter/all-to-all: (g-1)/g,
      collective-permute: 1.
    """
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0}
    for m in _COLL_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        payload = _shape_bytes(shape_str)
        # find the group size on the same line
        line_end = hlo_text.find("\n", m.start())
        line = hlo_text[m.start():line_end if line_end > 0 else None]
        g = n_devices
        gm = _GROUPS_RE.search(line)
        if gm:
            g = max(len(gm.group(1).split(",")), 1)
        else:
            gm2 = _GROUPS_IOTA_RE.search(line)
            if gm2:
                g = int(gm2.group(2))
        if g <= 1:
            continue
        factor = {"all-reduce": 2.0 * (g - 1) / g,
                  "all-gather": (g - 1) / g,
                  "reduce-scatter": (g - 1) / g,
                  "all-to-all": (g - 1) / g,
                  "collective-permute": 1.0}[kind]
        out[kind] += payload * factor
    out["total"] = sum(out.values())
    return out


def no_collectives() -> dict:
    """The breakdown of a program that issues none (the ``1x1`` mesh)."""
    out = {k: 0.0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                            "all-to-all", "collective-permute")}
    out["total"] = 0.0
    return out


def active_params(cfg: ModelConfig, total_params: int) -> int:
    """Per-token active parameter count (MoE: only routed top-k + shared)."""
    if not cfg.n_experts:
        return total_params
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed_total = cfg.n_experts * per_expert * (cfg.n_layers - cfg.first_dense_layers)
    active_routed = cfg.top_k * per_expert * (cfg.n_layers - cfg.first_dense_layers)
    return total_params - routed_total + active_routed


def model_flops(cfg: ModelConfig, shape: ShapeConfig, total_params: int) -> float:
    """Analytic useful FLOPs for the step (global, all devices)."""
    if shape.kind == "flround":
        # K-way weighted reduce: one multiply-add per stacked-update element
        # (total_params here counts the [K, ...] stacked input)
        return 2.0 * total_params
    n_act = active_params(cfg, total_params)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n_act * tokens
        # causal attention scores+values: 6 * L * B * S^2 * H * hd (fwd+bwd),
        # halved for causality
        hd = cfg.hd()
        attn = 6.0 * cfg.n_layers * shape.global_batch * shape.seq_len ** 2 \
            * cfg.n_heads * hd * 0.5 if cfg.family not in ("ssm",) else 0.0
        return base + attn
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        hd = cfg.hd()
        attn = 2.0 * cfg.n_layers * shape.global_batch * shape.seq_len ** 2 \
            * cfg.n_heads * hd * 0.5 if cfg.family not in ("ssm",) else 0.0
        return 2.0 * n_act * tokens + attn
    # decode: one token per sequence
    tokens = shape.global_batch
    hd = cfg.hd()
    attn = 2.0 * cfg.n_layers * shape.global_batch * shape.seq_len \
        * cfg.n_heads * hd * 2.0 if cfg.family not in ("ssm",) else 0.0
    return 2.0 * n_act * tokens + attn


def ssd_inner_scan_correction(cfg: ModelConfig, shape: ShapeConfig,
                              kind: str) -> float:
    """Global FLOPs the reference adds for the Mamba2 SSD *chunk* scan.

    XLA counts a while loop's body once, so the reference's lowering
    undercounts the intra-layer chunk scan by (nc - 1) bodies a layer.
    Analytic per-chunk-body FLOPs:
      y_diag: 2BQ^2(N + HP), states + y_off: 4BQNHP
    multiplied by (nc-1) missing iterations x mamba layers x pass multiplier
    (train with remat: fwd + recompute + 2x bwd = 4; prefill: 1).
    ``analyze`` adds none of it: the port's chunk loop is Python, so a meta
    trace runs, and counts, every chunk.
    """
    if cfg.family not in ("ssm", "hybrid") or kind not in ("train", "prefill"):
        return 0.0
    S = shape.seq_len
    if S <= 0:
        return 0.0
    Q = min(cfg.ssm_chunk, S)
    nc = S // Q
    if nc <= 1:
        return 0.0
    B = shape.global_batch
    H = (cfg.ssm_expand * cfg.d_model) // cfg.ssm_headdim
    P = cfg.ssm_headdim
    N = cfg.ssm_state
    body = 2.0 * B * Q * Q * (N + H * P) + 4.0 * B * Q * N * H * P
    mult = 4.0 if kind == "train" else 1.0
    return body * (nc - 1) * cfg.n_layers * mult


# ---------------------------------------------------------------- meta trace
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided}


def _tensor_bytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _OpBytes(TorchDispatchMode):
    """Sums the bytes of every aten op's input and output tensors, each
    counted once an op. A view reads and writes nothing; an in-place
    output (its input mutated) is counted once as written, beside the
    input read; an ``out=`` argument is written, not read; an
    allocation (``empty`` and kin) moves nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        schema = func._schema
        rets = [r.alias_info for r in schema.returns]
        if rets and all(a is not None and not a.is_write for a in rets):
            return out                      # a view returning a list
        self.ops += 1
        written_args = {a.name for a in schema.arguments
                        if a.alias_info is not None and a.alias_info.is_write
                        and a.kwarg_only}
        n = 0
        for i, a in enumerate(schema.arguments):
            v = (args[i] if i < len(args) else kwargs.get(a.name)) \
                if not a.kwarg_only else kwargs.get(a.name)
            if a.name in written_args:
                continue
            if isinstance(v, (list, tuple)):
                n += sum(_tensor_bytes(t) for t in v)
            else:
                n += _tensor_bytes(v)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for r, o in zip(rets + [None] * len(outs), outs):
            if r is not None and not r.is_write:
                continue                    # a view among the results
            if isinstance(o, (list, tuple)):
                n += sum(_tensor_bytes(t) for t in o)
            else:
                n += _tensor_bytes(o)
        self.bytes += n
        return out


class MetaTrace:
    """The counterpart of XLA's ``cost_analysis()``: counts of one run of
    a step, entered as a context.

    * ``flops``: ``FlopCounterMode``'s count (matmuls, convolutions,
      attention; elementwise ops count nothing, as in XLA's ``flops``);
    * ``bytes``: the bytes of every aten op's input and output tensors,
      each op on its own (views not counted, an in-place output once), and
      a hand kernel's own traffic as its wrapper reports it
      (``kernels._build.meta_launch``: ``fused_adam`` 28 B a param), not
      its plain version's passes. Every op is counted as if nothing were
      fused, so this is an upper bound on XLA's ``bytes accessed`` of the
      same step, which fuses: the two packages' bytes do not compare.
    * ``kernels``: each hand kernel's launches and bytes.

    Run on ``meta`` tensors it computes and allocates nothing; on the card
    the same counts come from the real run (``flops`` equal to the meta
    trace's: the same ops on the same shapes)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.kernels: dict = collections.defaultdict(
            lambda: {"launches": 0, "bytes": 0})
        self._modes = ()

    def _kernel(self, name: str, read: int, written: int) -> None:
        k = self.kernels[name]
        k["launches"] += 1
        k["bytes"] += read + written

    def __enter__(self):
        self._flop = FlopCounterMode(display=False)
        self._op = _OpBytes()
        self._flop.__enter__()
        self._op.__enter__()
        _build.LISTENERS.append(self._kernel)
        return self

    def __exit__(self, *exc):
        _build.LISTENERS.remove(self._kernel)
        self._op.__exit__(*exc)
        self._flop.__exit__(*exc)
        self.flops = int(self._flop.get_total_flops())
        self.bytes = self._op.bytes + sum(k["bytes"] for k in
                                          self.kernels.values())
        self.kernels = dict(self.kernels)
        return False


@dataclass
class Roofline:
    """The reference's record. A count the port cannot reckon per device
    (a wider mesh than ``1x1`` without a partitioner) is None, and so is
    every term computed from it."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: Optional[float]
    bytes_per_device: Optional[float]
    coll_bytes_per_device: Optional[float]
    coll_breakdown: Optional[dict]
    peak_memory_per_device: Optional[float]
    model_flops_global: float
    compile_s: float = 0.0

    @staticmethod
    def _over(x, rate):
        return None if x is None else x / rate

    @property
    def compute_s(self) -> Optional[float]:
        return self._over(self.flops_per_device, PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> Optional[float]:
        return self._over(self.bytes_per_device, HBM_BW)

    @property
    def collective_s(self) -> Optional[float]:
        return self._over(self.coll_bytes_per_device, ICI_BW)

    def _terms(self) -> Optional[dict]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return None if None in terms.values() else terms

    @property
    def bottleneck(self) -> Optional[str]:
        terms = self._terms()
        return None if terms is None else max(terms, key=terms.get)

    @property
    def step_time_s(self) -> Optional[float]:
        """Roofline step-time lower bound (perfect overlap -> max of terms)."""
        terms = self._terms()
        return None if terms is None else max(terms.values())

    @property
    def useful_ratio(self) -> Optional[float]:
        if self.flops_per_device is None:
            return None
        counted = self.flops_per_device * self.n_devices
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu(self) -> Optional[float]:
        """Model FLOPs utilization at the roofline bound."""
        if self.step_time_s is None:
            return None
        denom = self.step_time_s * self.n_devices * PEAK_FLOPS_BF16
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops_global": self.model_flops_global,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s, "useful_ratio": self.useful_ratio,
            "mfu": self.mfu, "compile_s": self.compile_s,
        }


def analyze(flops: float, byts: float, *, arch: str, shape: ShapeConfig,
            mesh_name: str, n_devices: int, cfg: ModelConfig,
            total_params: int, kind: str, compile_s: float = 0.0,
            peak_memory: Optional[float] = None) -> Roofline:
    """The roofline of a cell from a ``MetaTrace``'s global ``flops`` and
    ``bytes`` (where the reference takes the compiled program and its HLO
    text). On ``1x1`` they are the device's counts and no collective runs;
    on a wider mesh every per-device term is None. ``peak_memory`` is the
    card run's ``max_memory_allocated`` (None when the cell did not run).
    No SSD chunk-scan correction is added (see
    ``ssd_inner_scan_correction``)."""
    one = n_devices == 1
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=float(flops) if one else None,
        bytes_per_device=float(byts) if one else None,
        coll_bytes_per_device=0.0 if one else None,
        coll_breakdown=no_collectives() if one else None,
        peak_memory_per_device=peak_memory,
        model_flops_global=model_flops(cfg, shape, total_params),
        compile_s=compile_s)
