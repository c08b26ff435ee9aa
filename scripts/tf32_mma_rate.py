#!/usr/bin/env python3
"""The card's TF32 tensor-core rate through ``mma.sync.m16n8k8``, the
instruction the fp32 attention kernel runs its three TF32 products on.

    python3 scripts/tf32_mma_rate.py

Needs one CUDA card and ``nvcc``. Builds a kernel in which every warp
issues ``ITERS`` rounds of eight independent ``hopper::mma_m16n8k8_tf32``
(``src/repro_torch/kernels/csrc/hopper.cuh``, the kernel's own wrapper)
into ``build/kernels/``, launches it with 8, 16 and 32 warps on each SM,
and prints one JSON line per launch shape (median of CUDA-event times,
2,048 flops an instruction) after a line with the card's name and power
limit. The rate bounds the fp32 kernel: three TF32 products cost three
of these instructions for each one of fp32-accurate work.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ITERS = 4096
SOURCE = r"""
#include "hopper.cuh"
__global__ void mma_rate_kernel(float* out, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * i) & 0xFFFFE000u;
  const uint32_t b0 = __float_as_uint(0.5f), b1 = __float_as_uint(0.25f);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) hopper::mma_m16n8k8_tf32(d[j], a, b0, b1);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(float* out, int blocks, int threads, int iters,
                        void* stream) {
  mma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_mma_rate: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "tf32_mma_rate.cu"
    lib_path = _build.BUILD_DIR / "libtf32_mma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).mma_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for warps in (8, 16, 32):
        threads = min(warps, 16) * 32
        blocks = sms * warps * 32 // threads
        out = torch.empty(blocks * threads, device="cuda")
        times = []
        for rep in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(out.data_ptr(), blocks, threads, ITERS, stream)
            end.record()
            end.synchronize()
            if rc != 0:
                raise RuntimeError(f"mma_rate launch failed: CUDA error {rc}")
            if rep:                       # the first is a warm-up
                times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        flops = blocks * threads // 32 * ITERS * 8 * 2048
        print(json.dumps({"warps_per_sm": warps, "ms": ms,
                          "tf32_tflops": flops / ms / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
