// Block-scaled int8 quantization and its inverse, for any length N.
//
// Replaces: src/repro/kernels/quant8.py::quantize_q8 (the Pallas
//   _quant_kernel, quant8.py:58) and ::dequantize_q8 (_dequant_kernel,
//   quant8.py:89). The reference zero-pads x to a multiple of 8 x 256 and
//   trims the outputs; these kernels read positions past N as zeros (and a
//   block past the last scale as scale 1.0) and write nothing past N, which
//   gives the same outputs without a padded copy.
//
// Exact parity with the reference entry point (ops.quantize_q8, where XLA
//   folds "/ 127" into a multiply by the fp32 reciprocal):
//   - max-abs is an unsigned max of the |x| bit patterns: for non-negative
//     floats the integer order is the float order, and every NaN lies above
//     +inf, so a NaN in the block gives a NaN scale (fmaxf would drop it);
//   - scale = maxabs * (1.0f / 127.0f), then raised to 1e-12 by a compare
//     that keeps a NaN (not fmaxf);
//   - codes are rintf (round half to even) of an IEEE-rounded x / scale:
//     built without --use_fast_math, so "/" is the correctly rounded
//     division, never __fdividef or a reciprocal multiply;
//   - a block whose scale is not finite (it holds a NaN or an inf) gets
//     all-zero codes, which is what the reference's NaN -> int8 cast gives;
//     a fminf/fmaxf clamp would give -127 or 127 instead;
//   - the inverse is q * scale in fp32, cast to bf16 by __float2bfloat16_rn
//     (round to nearest even, as XLA's convert).
//
// Bound on the H100: device memory. Quantizing N values reads 4N bytes and
//   writes N codes and N/256 scales; dequantizing reads those and writes 4N
//   (or 2N) bytes. At the MnistCNN update (583,680 padded values) each call
//   moves ~2.93 MB, 0.87 us at 3.35 TB/s; a few operations per element.
//
// Design: one warp per 256-element block, eight blocks (ROWS, as in the
//   reference) per CTA of 256 threads. Lane l handles elements l + 32 j,
//   j < 8, so every load and store of the warp is coalesced and any N, any
//   alignment works without a vector path. The max is one __reduce_max_sync.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;                 // elements per scale (QBLOCK)
constexpr int kRows = 8;                    // blocks per CTA (ROWS)
constexpr int kThreads = 32 * kRows;
constexpr int kPer = kBlock / 32;           // elements per lane

__global__ void __launch_bounds__(kThreads)
quantize_q8_kernel(const float* __restrict__ x, int64_t n, int64_t nb,
                   int8_t* __restrict__ q, float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  if (b >= nb) return;                      // whole warp: no partial shuffle
  const int64_t base = b * kBlock + lane;
  float v[kPer];
  unsigned amax = 0u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = base + 32 * j;
    v[j] = i < n ? x[i] : 0.0f;
    const unsigned a = __float_as_uint(v[j]) & 0x7FFFFFFFu;
    amax = a > amax ? a : amax;
  }
  amax = __reduce_max_sync(0xFFFFFFFFu, amax);
  float scale = __uint_as_float(amax) * (1.0f / 127.0f);
  scale = scale < 1e-12f ? 1e-12f : scale;  // a NaN stays NaN
  const bool finite = isfinite(scale);
  if (lane == 0) scales[b] = scale;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = base + 32 * j;
    if (i < n) {
      float c = rintf(v[j] / scale);
      c = c > 127.0f ? 127.0f : (c < -127.0f ? -127.0f : c);
      q[i] = finite ? static_cast<int8_t>(static_cast<int>(c)) : int8_t{0};
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_q8_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ scales, int64_t n, int64_t ns,
                     int64_t nb, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  if (b >= nb) return;
  const float scale = b < ns ? scales[b] : 1.0f;
  const int64_t base = b * kBlock + lane;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = base + 32 * j;
    if (i < n) out[i] = from_float<T>(static_cast<float>(q[i]) * scale);
  }
}

unsigned grid_for(int64_t nb) {
  return static_cast<unsigned>((nb + kRows - 1) / kRows);
}

}  // namespace

// x: [n] fp32; q: [n] int8; scales: [ceil(n/256)] fp32. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int quantize_q8_f32(const void* x, int64_t n, void* q, void* scales,
                               void* stream) {
  const int64_t nb = (n + kBlock - 1) / kBlock;
  if (nb > 0) {
    quantize_q8_kernel<<<grid_for(nb), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, nb, static_cast<int8_t*>(q),
        static_cast<float*>(scales));
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [n] int8; scales: [ns] fp32, ns <= ceil(n/256) (blocks past ns take
// 1.0); out: [n] fp32 (bf16 = 0) or bf16 (bf16 = 1). Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int dequantize_q8(const void* q, const void* scales, int64_t n,
                             int64_t ns, void* out, int bf16, void* stream) {
  const int64_t nb = (n + kBlock - 1) / kBlock;
  if (nb > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* qp = static_cast<const int8_t*>(q);
    const float* sp = static_cast<const float*>(scales);
    if (bf16) {
      dequantize_q8_kernel<__nv_bfloat16><<<grid_for(nb), kThreads, 0, s>>>(
          qp, sp, n, ns, nb, static_cast<__nv_bfloat16*>(out));
    } else {
      dequantize_q8_kernel<float><<<grid_for(nb), kThreads, 0, s>>>(
          qp, sp, n, ns, nb, static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
