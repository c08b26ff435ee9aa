// Staleness-weighted row reduction: out[n] = sum_k w[k] * u[row(k), n].
//
// Replaces: src/repro/kernels/staleness_agg.py::staleness_agg (the Pallas
//   _agg_kernel, reached through ops._scatter_w_agg: the [C] scattered weight
//   vector times the whole [C, W] update buffer, free rows at weight 0). With
//   a row-index vector the same kernel also computes the exact-rows reduction
//   that the reference left to XLA (ops._gather_weighted_sum: gather the K
//   referenced rows, einsum), without materialising the gathered rows.
//   row(k) = rows[k] when rows is given, else k. fp32 accumulation.
//
// Bound on the H100: device memory. A call reads K rows of N fp32 and writes
//   N fp32, (K*N + K + N) * 4 bytes, for 2 flops an element (~0.25 flop per
//   byte, far under the ~20 flop/byte fp32 ridge). At the full sweep of the
//   MnistCNN store (C=208 rows of W=582,656) that is ~487 MB a call.
//
// Design: every byte of the buffer is read exactly once. Each thread owns 4
//   consecutive columns and loads them as one 16-byte float4, so a warp reads
//   512 contiguous bytes a row. The block stages the weights and row offsets
//   in shared memory (in chunks, so any K fits) and each thread walks the K
//   rows four at a time, keeping four independent 16-byte loads in flight to
//   cover memory latency. A column's whole sum lives in one thread's
//   registers, taken in ascending k: no atomics, no second pass, and the
//   result does not change from run to run. Rows of weight 0 are read like
//   any other row: 0 * NaN = NaN is what the caller's finiteness guard
//   relies on to catch garbage in freed rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;   // weights staged per shared-memory pass

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& u) {
  acc.x += w * u.x;
  acc.y += w * u.y;
  acc.z += w * u.z;
  acc.w += w * u.w;
}

__global__ void __launch_bounds__(kThreads)
staleness_agg_kernel(const float4* __restrict__ u, const float* __restrict__ w,
                     const int64_t* __restrict__ rows, float4* __restrict__ out,
                     int64_t K, int64_t n4, int64_t ld4) {
  __shared__ float sw[kChunk];
  __shared__ int64_t soff[kChunk];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = static_cast<int>(K - k0 < kChunk ? K - k0 : kChunk);
    __syncthreads();   // the previous chunk is no longer read
    for (int i = threadIdx.x; i < kc; i += kThreads) {
      sw[i] = w[k0 + i];
      soff[i] = (rows != nullptr ? rows[k0 + i] : k0 + i) * ld4;
    }
    __syncthreads();
    if (c < n4) {
      int i = 0;
      for (; i + 4 <= kc; i += 4) {
        const float4 a = __ldg(u + soff[i] + c);
        const float4 b = __ldg(u + soff[i + 1] + c);
        const float4 d = __ldg(u + soff[i + 2] + c);
        const float4 e = __ldg(u + soff[i + 3] + c);
        fma4(acc, sw[i], a);
        fma4(acc, sw[i + 1], b);
        fma4(acc, sw[i + 2], d);
        fma4(acc, sw[i + 3], e);
      }
      for (; i < kc; ++i) fma4(acc, sw[i], __ldg(u + soff[i] + c));
    }
  }
  if (c < n4) out[c] = acc;
}

}  // namespace

// u: [*, ld] fp32 rows (16-byte aligned, ld % 4 == 0); w: [K] fp32;
// rows: [K] int64 row ids or null (row k = k); out: [N] fp32, N % 4 == 0.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int staleness_agg_f32(const void* u, const void* w, const void* rows,
                                 void* out, int64_t K, int64_t N, int64_t ld,
                                 void* stream) {
  const int64_t n4 = N / 4;
  const int64_t blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 0) {
    staleness_agg_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(u), static_cast<const float*>(w),
        static_cast<const int64_t*>(rows), static_cast<float4*>(out), K, n4,
        ld / 4);
  }
  return static_cast<int>(cudaGetLastError());
}
