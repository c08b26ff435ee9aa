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
//   MnistCNN store (C=208 rows of W=582,656) that is ~487 MB a call; the
//   rows form of an apodotiko round (30 rows, padded to 32) ~72 MB.
//
// Design: a persistent grid, one CTA per SM, each streaming the same bytes.
//   - The N/4 float4 columns are split into one contiguous range per CTA, in
//     whole 128-byte units (sizes differ by at most one unit, plus the
//     N/4 % 8 float4s past the last whole unit), so no partial wave is left
//     over and every copy starts on a 128-byte boundary of its row (on the
//     H100, copies that started on any 16-byte boundary held the sweep well
//     short of its bound). A CTA cuts its range into the fewest near-equal
//     tiles of at most kPiece4 float4s (32 KB); at the MnistCNN width a
//     CTA's whole range is one tile.
//   - One producer thread walks (tile, row k) in that order and copies each
//     row's tile (a "piece") into a ring of shared-memory stages with a 1-D
//     TMA bulk copy, marked evict-first in the L2 (each piece is read once).
//     The ring is 96 KB, cut into as many stages as pieces of the CTA's
//     widest tile fit. Large pieces are what keep the device memory busy:
//     on the H100, 4 and 8 KB pieces ran both forms slower, and a deeper
//     ring (up to 200 KB) did not help.
//   - Each stage has a full and an empty mbarrier; the weight of the piece
//     travels with it in the stage's slot of `sw`. The producer warp stages
//     the weights and row ids 32 at a time in its registers, so any K fits;
//     it asks for the first 32 at entry, since the start of a call (cold
//     loads of the row ids, then of the kernel's code) is what the rows
//     form's 32 pieces a CTA cannot hide. Eight consumer warps own the
//     tile's columns (up to kVec float4s a thread), wait on full, take
//     acc = fma(w[k], u, acc) from shared memory and release the stage.
//   - A column's whole sum lives in one thread's registers, taken in
//     ascending k: no atomics, no split of K across CTAs, and the result
//     does not change from run to run (the same order and roundings as a
//     register loop of `acc += w * u`, which nvcc contracts into the same
//     FMA). Rows of weight 0 are read like any other row: 0 * NaN = NaN is
//     what the caller's finiteness guard relies on to catch garbage in freed
//     rows. The rows form reads only the referenced rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;   // threads 0..255
constexpr int kThreads = kConsumers + 32;         // + the producer warp
constexpr int kVec = 8;                           // float4s a thread a tile
constexpr int kPiece4 = kVec * kConsumers;        // float4s: 32 KB a piece
constexpr int kRingBytes = 96 * 1024;             // the ring of stages
constexpr int kMaxStages = 64;
constexpr int kSmemBytes = kRingBytes + kMaxStages * (8 + 8 + 4);
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& u) {
  acc.x = fmaf(w, u.x, acc.x);
  acc.y = fmaf(w, u.y, acc.y);
  acc.z = fmaf(w, u.z, acc.z);
  acc.w = fmaf(w, u.w, acc.w);
}

// Start of part i of n items cut into `parts` near-equal contiguous parts;
// a 32-bit division where the product fits (a 64-bit one is slow).
__device__ __forceinline__ uint32_t cut(uint32_t n, uint32_t parts,
                                        uint32_t i) {
  const uint64_t p = static_cast<uint64_t>(i) * n;
  return p >> 32 ? static_cast<uint32_t>(p / parts)
                 : static_cast<uint32_t>(p) / parts;
}

// One CTA's float4 columns [c0, c1): whole 128-byte units (8 float4s)
// [b U / G, (b + 1) U / G) of the row's U = n4 / 8, and for the last CTA
// also the n4 % 8 float4s past them. Cut into `tiles` near-equal runs of
// whole units (the last one maybe partial), each at most kPiece4 float4s.
// 32-bit arithmetic (n4 < 2^31): its code is on the path to the first copy.
struct Columns {
  uint32_t c0, c1, units, tiles;
  __device__ Columns(uint32_t n4, uint32_t grid, uint32_t b) {
    const uint32_t all = n4 / 8;
    c0 = 8 * cut(all, grid, b);
    c1 = b + 1 == grid ? n4 : 8 * cut(all, grid, b + 1);
    units = (c1 - c0 + 7) / 8;
    tiles = (c1 - c0 + kPiece4 - 1) / kPiece4;
  }
  __device__ uint32_t begin(uint32_t j) const {
    return c0 + 8 * cut(units, tiles, j);
  }
  __device__ uint32_t end(uint32_t j) const {
    return min(c1, c0 + 8 * cut(units, tiles, j + 1));
  }
};

__global__ void __launch_bounds__(kThreads, 1)
staleness_agg_kernel(const float* __restrict__ u, const float* __restrict__ w,
                     const int64_t* __restrict__ rows,
                     float4* __restrict__ out, int64_t K, int64_t n4,
                     int64_t ld) {
  extern __shared__ __align__(128) uint8_t smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* empty = full + kMaxStages;
  float* sw = reinterpret_cast<float*>(empty + kMaxStages);
  const int t = threadIdx.x, lane = t & 31;

  // the producer warp's chunk of 32 weights and row ids from k0; the first
  // is asked for before anything else, as its latency is the start's
  float wl = 0.f;
  int64_t row = 0;
  auto stage_chunk = [&](int64_t k0) {
    if (k0 + lane < K) {
      wl = w[k0 + lane];
      row = rows != nullptr ? rows[k0 + lane] : k0 + lane;
    }
  };
  if (t >= kConsumers) stage_chunk(0);

  // a stage holds the widest tile, the ring as many stages as fit
  const Columns cols(static_cast<uint32_t>(n4), gridDim.x, blockIdx.x);
  const uint32_t tiles = cols.tiles;
  const int slot4 = 8 * static_cast<int>((cols.units + tiles - 1) / tiles);
  const int stages = min(kMaxStages, kRingBytes / (16 * slot4));
  if (t == 0) {
    for (int i = 0; i < stages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kConsumerWarps);   // one arrival a warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  int s = 0;          // ring stage of the current piece
  uint32_t ph = 0;    // parity of that stage's current use
  if (t >= kConsumers) {
    // producer warp: lane 0 issues every copy
    const uint64_t policy = hopper::l2_evict_first();
    int64_t staged = 0;   // k0 of the chunk in registers
    for (uint32_t j = 0; j < tiles; ++j) {
      const uint32_t a = cols.begin(j);
      const uint32_t bytes = 16u * (cols.end(j) - a);
      for (int64_t k0 = 0; k0 < K; k0 += 32) {
        if (k0 != staged) {
          stage_chunk(k0);
          staged = k0;
        }
        const int kc = static_cast<int>(K - k0 < 32 ? K - k0 : 32);
        for (int i = 0; i < kc; ++i) {
          const float wi = __shfl_sync(0xffffffffu, wl, i);
          const int64_t ri = __shfl_sync(0xffffffffu, row, i);
          if (lane == 0) {
            hopper::mbar_wait(&empty[s], ph ^ 1);
            sw[s] = wi;
            hopper::mbar_expect_tx(&full[s], bytes);
            hopper::bulk_load(ring + s * slot4, u + ri * ld + 4 * a, bytes,
                              &full[s], policy);
          }
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: thread t owns float4 columns t + v kConsumers of a tile
  for (uint32_t j = 0; j < tiles; ++j) {
    const uint32_t a = cols.begin(j);
    const int width = static_cast<int>(cols.end(j) - a);
    float4 acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t k = 0; k < K; ++k) {
      hopper::mbar_wait(&full[s], ph);
      const float wk = sw[s];
      const float4* piece = ring + s * slot4;
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (t + v * kConsumers < width)
          fma4(acc[v], wk, piece[t + v * kConsumers]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (t + v * kConsumers < width) out[a + t + v * kConsumers] = acc[v];
  }
}

}  // namespace

// u: [*, ld] fp32 rows (16-byte aligned, ld % 4 == 0); w: [K] fp32;
// rows: [K] int64 row ids or null (row k = k); out: [N] fp32, N % 4 == 0,
// N < 2^33 (else returns cudaErrorInvalidValue).
// The grid is min(SMs, N / 32) CTAs, at least one; the SM count is read,
// and the kernel's shared-memory limit raised, once a device. Launches on
// `stream`, does not synchronise, returns the first CUDA error.
extern "C" int staleness_agg_f32(const void* u, const void* w, const void* rows,
                                 void* out, int64_t K, int64_t N, int64_t ld,
                                 void* stream) {
  static int sms[kMaxDevices];   // SMs by device; 0 until set up
  const int64_t n4 = N / 4;
  if (n4 <= 0) return static_cast<int>(cudaSuccess);
  if (n4 > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(staleness_agg_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = count;
  }
  const int64_t units = n4 / 8 > 0 ? n4 / 8 : 1;   // 128-byte units
  const int64_t grid = units < sms[dev] ? units : sms[dev];
  staleness_agg_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const int64_t*>(rows), static_cast<float4*>(out), K, n4,
      ld);
  return static_cast<int>(cudaGetLastError());
}
