// Block-scaled int8 quantization, its inverse, and the two fused with the
// error feedback of a compressed update, for any length N.
//
// Replaces: src/repro/kernels/quant8.py::quantize_q8 (the Pallas
//   _quant_kernel, quant8.py:58) and ::dequantize_q8 (_dequant_kernel,
//   quant8.py:89), and the stepwise composition of the two in
//   src/repro/kernels/ops.py::compress_update (add the error feedback,
//   zero-pad, quantize, dequantize, trim, subtract). The reference zero-pads
//   x to a multiple of 8 x 256 and trims the outputs; these kernels read
//   positions past N as zeros (and a block past the last scale as scale
//   1.0) and write nothing past N, which gives the same outputs without a
//   padded copy.
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
//     (round to nearest even, as XLA's convert);
//   - the fused error is v - q * scale rounded twice, as the reference's
//     dequantize then subtract: __fmul_rn and __fsub_rn, which nvcc never
//     contracts into one FMA (a plain "v - q * s" would be, under the
//     default -fmad=true, and round once). A non-finite block's error is
//     NaN, from 0 * NaN or 0 * inf, computed literally.
//
// Bound on the H100: device memory, two orders of magnitude below the
//   ridge (a few operations per element). At the MnistCNN update (N =
//   582,026, padded to 583,680) the fused call reads flat and the error
//   feedback (4N + 4N bytes) and writes the codes, the scales and the new
//   error (n_pad + 4 n_pad / 256 + 4N): 7.57 MB, 2.26 us at 3.35 TB/s.
//   Quantize or dequantize alone moves ~2.93 MB, 0.87 us.
//
// Design: bytes and launches, not tensor cores. One warp per 256-value
//   block, eight blocks (ROWS, as in the reference) per CTA of 256
//   threads, so the MnistCNN update is 2,280 warps in 285 CTAs, more than
//   one wave on 132 SMs. Lane l holds 8 values of its block in two runs
//   of 4, at 4l and 128 + 4l: one 16-byte load of each fp32 input a run,
//   one 4-byte store of its codes, one 16-byte store of its error (8
//   bytes of bf16), so every access of the warp covers 512 (or 128, 256)
//   contiguous bytes. (8 consecutive values a lane, two 16-byte accesses
//   32 bytes apart, ran slower on the H100: each warp access then touches
//   every other 16 bytes of 1 KB.) A run that crosses N, or an input that
//   is not 16-byte aligned (a view such as buf[1:]), takes a scalar path
//   in the same kernel. The max is one __reduce_max_sync. Quantize is the
//   fused kernel without error feedback or error; the fused kernel keeps
//   the sum, the codes and the dequantized values in registers, so one
//   launch replaces six and nothing intermediate reaches device memory.
//   Dequantize, a few instructions a value, is as fast as its code is
//   short: every block that lies wholly before N takes a branch-free path
//   (the branch is the same for the whole warp), and the last block one
//   value at a time in a loop kept rolled (unrolled, its guards made the
//   kernel slower on the H100, though no block but the last runs them).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;                 // elements per scale (QBLOCK)
constexpr int kRows = 8;                    // blocks per CTA (ROWS)
constexpr int kThreads = 32 * kRows;
constexpr int kRun = 4;                     // consecutive values a lane, twice

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Where lane's run r (0 or 1) of block b starts.
__device__ __forceinline__ int64_t run_start(int64_t b, int lane, int r) {
  return b * kBlock + r * (kBlock / 2) + lane * kRun;
}

// v[j] = p[i + j] for i + j < n, else 0: one 16-byte load where the run
// lies before n and p is 16-byte aligned, else scalar.
__device__ __forceinline__ void load4(const float* __restrict__ p, int64_t i,
                                      int64_t n, bool vec, float* v) {
  if (vec && i + kRun <= n) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[j] = i + j < n ? p[i + j] : 0.0f;
  }
}

// p[0..3] = v, one 16-byte store (8 bytes for bf16), p aligned to it; bf16
// is rounded to nearest even (__float2bfloat16_rn, as XLA's convert).
__device__ __forceinline__ void put4(float* __restrict__ p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* __restrict__ p,
                                     const float* v) {
  uint32_t w[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    w[j] = static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]))) |
           static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1])))
               << 16;
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p[i + j] = v[j] for i + j < n; p as torch allocates it (aligned).
template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, int64_t i,
                                       int64_t n, const float* v) {
  if (i + kRun <= n) {
    put4(p + i, v);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) if (i + j < n) put1(p + i + j, v[j]);
  }
}

__device__ __forceinline__ int code(float v, float scale, bool finite) {
  float c = rintf(v / scale);
  c = c > 127.0f ? 127.0f : (c < -127.0f ? -127.0f : c);
  return finite ? static_cast<int>(c) : 0;
}

// One warp per block b < nb of 256 values: v = x + ef (x alone where ef
// is null; 0 at and past n), the block's scale (all nb written) and its
// codes (the first n_q written), and where err is not null, for i < n the
// error v - q * scale, rounded as the reference's two steps round it.
// Quantize is this kernel with ef and err null and n_q = n; compress
// has n_q = nb * 256.
__global__ void __launch_bounds__(kThreads)
compress_q8_kernel(const float* __restrict__ x, const float* __restrict__ ef,
                   int64_t n, int64_t nb, int vec_x, int vec_ef,
                   int8_t* __restrict__ q, int64_t n_q,
                   float* __restrict__ scales, float* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  if (b >= nb) return;                      // whole warp: no partial shuffle
  float v[2 * kRun];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t i = run_start(b, lane, r);
    load4(x, i, n, vec_x, v + kRun * r);
    if (ef != nullptr) {
      float e[kRun];
      load4(ef, i, n, vec_ef, e);
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        v[kRun * r + j] = __fadd_rn(v[kRun * r + j], e[j]);
    }
  }
  unsigned amax = 0u;
#pragma unroll
  for (int j = 0; j < 2 * kRun; ++j) {
    const unsigned a = __float_as_uint(v[j]) & 0x7FFFFFFFu;
    amax = a > amax ? a : amax;
  }
  amax = __reduce_max_sync(0xFFFFFFFFu, amax);
  float scale = __uint_as_float(amax) * (1.0f / 127.0f);
  scale = scale < 1e-12f ? 1e-12f : scale;  // a NaN stays NaN
  const bool finite = isfinite(scale);
  if (lane == 0) scales[b] = scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t i = run_start(b, lane, r);
    int c[kRun];
    float e[kRun];
    uint32_t packed = 0u;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      c[j] = code(v[kRun * r + j], scale, finite);
      packed |= (static_cast<uint32_t>(c[j]) & 0xFFu) << (8 * j);
      e[j] = __fsub_rn(v[kRun * r + j], __fmul_rn(static_cast<float>(c[j]),
                                                  scale));
    }
    if (i + kRun <= n_q) {
      *reinterpret_cast<uint32_t*>(q + i) = packed;   // q aligned, as torch
    } else {                                          // allocates it
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (i + j < n_q) q[i + j] = static_cast<int8_t>(c[j]);
    }
    if (err != nullptr) store4(err, i, n, e);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_q8_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ scales, int64_t n, int64_t ns,
                     int64_t nb, int vec_q, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  if (b >= nb) return;
  const float scale = b < ns ? scales[b] : 1.0f;
  if (vec_q && (b + 1) * kBlock <= n) {
    // The whole block lies before n (every block but the last): no guard,
    // both runs' 4-byte loads issued first.
    uint32_t w[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(q + run_start(b, lane, r));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        v[j] = static_cast<float>(static_cast<int8_t>(
                   static_cast<uint8_t>(w[r] >> (8 * j)))) * scale;
      put4(out + run_start(b, lane, r), v);
    }
    return;
  }
  // The last block, or codes not 4-byte aligned: one value at a time, in a
  // loop kept rolled (short code; see the design note at the top).
#pragma unroll 1
  for (int k = 0; k < 2 * kRun; ++k) {
    const int64_t i = run_start(b, lane, k / kRun) + k % kRun;
    if (i < n) put1(out + i, static_cast<float>(q[i]) * scale);
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
    compress_q8_kernel<<<grid_for(nb), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), nullptr, n, nb, aligned(x, 16), 0,
        static_cast<int8_t*>(q), n, static_cast<float*>(scales), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// flat: [n] fp32; ef: [n] fp32 or null (no error feedback); n_pad: a
// multiple of 256, >= n; q: [n_pad] int8; scales: [n_pad/256] fp32; err:
// [n] fp32 (q and err aligned, as torch allocates them). Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int compress_q8_f32(const void* flat, const void* ef, int64_t n,
                               int64_t n_pad, void* q, void* scales, void* err,
                               void* stream) {
  const int64_t nb = n_pad / kBlock;
  if (nb > 0) {
    compress_q8_kernel<<<grid_for(nb), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(flat), static_cast<const float*>(ef), n, nb,
        aligned(flat, 16), ef != nullptr && aligned(ef, 16),
        static_cast<int8_t*>(q), n_pad, static_cast<float*>(scales),
        static_cast<float*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [n] int8; scales: [ns] fp32, ns <= ceil(n/256) (blocks past ns take
// 1.0); out: [n] fp32 (bf16 = 0) or bf16 (bf16 = 1), aligned as torch
// allocates it. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int dequantize_q8(const void* q, const void* scales, int64_t n,
                             int64_t ns, void* out, int bf16, void* stream) {
  const int64_t nb = (n + kBlock - 1) / kBlock;
  if (nb > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* qp = static_cast<const int8_t*>(q);
    const float* sp = static_cast<const float*>(scales);
    const int vec_q = aligned(q, 4);
    if (bf16) {
      dequantize_q8_kernel<__nv_bfloat16><<<grid_for(nb), kThreads, 0, s>>>(
          qp, sp, n, ns, nb, vec_q, static_cast<__nv_bfloat16*>(out));
    } else {
      dequantize_q8_kernel<float><<<grid_for(nb), kThreads, 0, s>>>(
          qp, sp, n, ns, nb, vec_q, static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
