#!/usr/bin/env python3
"""Designs of the ``staleness_agg`` kernel side by side on one card.

    python3 scripts/staleness_agg_designs.py [--source NAME=PATH ...]

Needs one CUDA card and ``nvcc``. Times, at the main path's two shapes
(the MnistCNN update store, 208 rows of 582,656 fp32: the rows form of an
``apodotiko`` round, 30 rows padded to 32 with zero-weight repeats of the
first, and the sweep form of a ``fedavg`` round, all 208 rows):

- ``tma``: the port's kernel, ``src/repro_torch/kernels/csrc/
  staleness_agg.cu`` (persistent grid, TMA bulk copies into a ring of
  shared-memory stages);
- ``regs1`` / ``regs2``: the register design built from ``SOURCE`` below
  (persistent and balanced like ``tma``, each thread two float4 columns,
  K unrolled by 8, so 16 loads of 16 B in flight a thread), with one or
  two CTAs of 256 threads a SM; ``regs0`` the same kernel not persistent,
  one CTA for every 512 float4 columns;
- each ``--source NAME=PATH``: any other ``.cu`` that exports
  ``staleness_agg_f32`` with the port's C signature (for example the same
  file of another checkout, unpacked with ``git archive``).

Each design is held to the plain version (``ref.staleness_agg`` on the
card) at rtol 1e-5 / atol 1e-6 * K and compared bit for bit with ``tma``.
Times on the card, medians: ``warm_ms`` is the CUDA-event time of a run
of 50 launches back to back over 50 (the L2 holds what the last one
left), ``flushed_ms`` that of one launch after 256 MB of scratch were
written and read back (outside the events, so the 50 MB L2 holds none of
the inputs and no dirty line to write back), ``flushed_device_ms`` the
kernel's own time after such a flush (``torch.profiler``). Prints a line with
the card's name and power limit, then one JSON line per design and form.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
C, W, K_ROWS = 208, 582_656, 30
FLUSH_BYTES = 256 << 20
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kThreads = 256;
constexpr int kCols = 2;      // float4 columns a thread
constexpr int kUnroll = 8;    // rows a batch: kCols * kUnroll loads in flight
constexpr int kChunk = 1024;  // weights staged per shared-memory pass

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& u) {
  acc.x = fmaf(w, u.x, acc.x);
  acc.y = fmaf(w, u.y, acc.y);
  acc.z = fmaf(w, u.z, acc.z);
  acc.w = fmaf(w, u.w, acc.w);
}

__global__ void __launch_bounds__(kThreads)
regs_agg_kernel(const float4* __restrict__ u, const float* __restrict__ w,
            const int64_t* __restrict__ rows, float4* __restrict__ out,
            int64_t K, int64_t n4, int64_t ld4) {
  __shared__ float sw[kChunk];
  __shared__ int64_t soff[kChunk];
  const int64_t c0 = blockIdx.x * n4 / gridDim.x;
  const int64_t c1 = (blockIdx.x + 1) * n4 / gridDim.x;
  for (int64_t base = c0; base < c1; base += kThreads * kCols) {
    int64_t c[kCols];
    bool ok[kCols];
    float4 acc[kCols];
#pragma unroll
    for (int v = 0; v < kCols; ++v) {
      c[v] = base + threadIdx.x + v * kThreads;
      ok[v] = c[v] < c1;
      acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
      const int kc = static_cast<int>(K - k0 < kChunk ? K - k0 : kChunk);
      __syncthreads();
      for (int i = threadIdx.x; i < kc; i += kThreads) {
        sw[i] = w[k0 + i];
        soff[i] = (rows != nullptr ? rows[k0 + i] : k0 + i) * ld4;
      }
      __syncthreads();
      int i = 0;
      for (; i + kUnroll <= kc; i += kUnroll) {
        float4 x[kUnroll][kCols];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r)
#pragma unroll
          for (int v = 0; v < kCols; ++v)
            x[r][v] = ok[v] ? __ldg(u + soff[i + r] + c[v])
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kUnroll; ++r)
#pragma unroll
          for (int v = 0; v < kCols; ++v) fma4(acc[v], sw[i + r], x[r][v]);
      }
      for (; i < kc; ++i)
#pragma unroll
        for (int v = 0; v < kCols; ++v)
          if (ok[v]) fma4(acc[v], sw[i], __ldg(u + soff[i] + c[v]));
    }
#pragma unroll
    for (int v = 0; v < kCols; ++v)
      if (ok[v]) out[c[v]] = acc[v];
  }
}

int launch(const void* u, const void* w, const void* rows, void* out,
           int64_t K, int64_t N, int64_t ld, void* stream, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t n4 = N / 4;
  int64_t grid = int64_t{sms} * per_sm;   // per_sm 0: one CTA a pass
  if (per_sm == 0 || grid > n4)
    grid = per_sm == 0 ? (n4 + kThreads * kCols - 1) / (kThreads * kCols) : n4;
  if (grid > 0)
    regs_agg_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(u), static_cast<const float*>(w),
        static_cast<const int64_t*>(rows), static_cast<float4*>(out), K, n4,
        ld / 4);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int regs0_agg_f32(const void* u, const void* w, const void* rows,
                             void* out, int64_t K, int64_t N, int64_t ld,
                             void* stream) {
  return launch(u, w, rows, out, K, N, ld, stream, 0);
}
extern "C" int regs1_agg_f32(const void* u, const void* w, const void* rows,
                             void* out, int64_t K, int64_t N, int64_t ld,
                             void* stream) {
  return launch(u, w, rows, out, K, N, ld, stream, 1);
}
extern "C" int regs2_agg_f32(const void* u, const void* w, const void* rows,
                             void* out, int64_t K, int64_t N, int64_t ld,
                             void* stream) {
  return launch(u, w, rows, out, K, N, ld, stream, 2);
}
"""
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def build(name: str, path: Path, build_dir: Path, nvcc_cmd: list) -> Path:
    """Compile ``path`` into a shared library named by its content."""
    tag = hashlib.sha256(path.read_bytes() + " ".join(nvcc_cmd).encode())
    lib = build_dir / f"lib{name}-{tag.hexdigest()[:16]}.so"
    if not lib.exists():
        subprocess.run([*nvcc_cmd, "-I", str(path.parent), "-o", str(lib),
                        str(path)], check=True, capture_output=True,
                       text=True)
    return lib


def c_function(lib: Path, symbol: str):
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.restype, fn.argtypes = ctypes.c_int, ARGTYPES
    return fn


def inputs(rows_form: bool, dev) -> tuple:
    """Seeded inputs of one form, as chip_smoke's kernel entries make them:
    (buffer, weights, rows or None, K read, bytes the function needs)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    buf = torch.randn(C, W, device=dev, generator=gen) * 0.05
    rows = torch.randperm(C, device=dev, generator=gen)[:K_ROWS]
    w = torch.rand(K_ROWS, device=dev, generator=gen)
    w = w / w.sum()
    if rows_form:
        kp = K_ROWS + (-K_ROWS) % 8
        rows = torch.cat([rows, rows[:1].repeat(kp - K_ROWS)])
        w = torch.cat([w, torch.zeros(kp - K_ROWS, device=dev)])
        return buf, w, rows, kp, (K_ROWS * W + W) * 4 + kp * 12
    full_w = torch.zeros(C, device=dev).index_add_(0, rows, w)
    return buf, full_w, None, C, (C * W + C + W) * 4


def timings(call, flush) -> dict:
    """warm: 50 launches back to back, mean; flushed: one launch after the
    L2 was flushed, median of 30; flushed_device: the kernel's own time
    after a flush (``torch.profiler``, median of 10; None unless the
    profiler saw each of the 10 launches)."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    warm = []
    for _ in range(5):
        start.record()
        for _ in range(50):
            call()
        end.record()
        end.synchronize()
        warm.append(start.elapsed_time(end) / 50)
    flushed = []
    for _ in range(30):
        flush()
        start.record()
        call()
        end.record()
        end.synchronize()
        flushed.append(start.elapsed_time(end))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush()
            call()
        torch.cuda.synchronize()
    kernel = [(e.time_range.end - e.time_range.start) / 1e3
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "agg_kernel" in e.name]
    return {"warm_ms": statistics.median(warm),
            "flushed_ms": statistics.median(flushed),
            "flushed_device_ms": (statistics.median(kernel)
                                  if len(kernel) == 10 else None)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append", default=[],
                        metavar="NAME=PATH")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("staleness_agg_designs: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc_cmd = [_build._nvcc(), *_build.NVCC_FLAGS]
    regs_src = _build.BUILD_DIR / "staleness_agg_regs.cu"
    regs_src.write_text(SOURCE)
    regs_lib = build("staleness_agg_regs", regs_src, _build.BUILD_DIR,
                     nvcc_cmd)
    designs = {"tma": _build.function("staleness_agg", "staleness_agg_f32",
                                      ctypes.c_int, ARGTYPES),
               "regs0": c_function(regs_lib, "regs0_agg_f32"),
               "regs1": c_function(regs_lib, "regs1_agg_f32"),
               "regs2": c_function(regs_lib, "regs2_agg_f32")}
    for spec in args.source:
        name, path = spec.split("=", 1)
        lib = build(f"staleness_agg_{name}", Path(path).resolve(),
                    _build.BUILD_DIR, nvcc_cmd)
        designs[name] = c_function(lib, "staleness_agg_f32")

    dev = torch.device("cuda", 0)
    scratch = torch.empty(FLUSH_BYTES // 4, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for form in ("rows", "sweep"):
        buf, w, rows, k, nbytes = inputs(form == "rows", dev)
        want = ref.staleness_agg(buf, w, rows)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        first = None
        for name, fn in designs.items():
            out = torch.empty(W, device=dev)
            c_args = (buf.data_ptr(), w.data_ptr(),
                      None if rows is None else rows.data_ptr(),
                      out.data_ptr(), k, W, W, stream)

            def call(fn=fn, c_args=c_args, name=name):
                rc = fn(*c_args)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6 * k)
            first = out.clone() if first is None else first
            t = timings(call, lambda: scratch.fill_(1.0).sum())
            print(json.dumps({
                "design": name, "form": form, "K": k, "bytes": nbytes,
                "bound_ms": bound_ms, **t,
                "flushed_bound_share": bound_ms / t["flushed_ms"],
                "flushed_device_bound_share": (
                    bound_ms / t["flushed_device_ms"]
                    if t["flushed_device_ms"] else None),
                "max_abs_err": float((out - want).abs().max()),
                "bit_equal_to_tma": bool(torch.equal(
                    out.view(torch.int32), first.view(torch.int32)))}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
