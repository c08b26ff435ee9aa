// Blockwise top-k: for each block of B <= 1024 scores, the k largest
// (value, index) pairs, in lax.top_k's order.
//
// Replaces: src/repro/kernels/topk.py::block_topk (the Pallas _topk_kernel,
//   topk.py:61), and, launched again on its own candidates until one block
//   remains, the lax.top_k reduce of the G*k candidates in ops.masked_topk
//   (ops.py:303-305). M need not be a multiple of B: positions past M act as
//   -inf scores, as the reference's -inf padding does.
//
// Order: lax.top_k's total order on fp32 (-NaN < -inf < ... < -0 < +0 < ...
//   < +inf < +NaN), read as an unsigned 32-bit key; equal keys go to the
//   lower index. A taken element is marked by clearing its packed entry, not
//   by writing -inf over its value: the reference's Pallas kernel does the
//   latter and re-picks an index it already took once a block has fewer
//   finite scores than k.
//
// Bound on the H100: a call reads M fp32 scores once and writes G*k values
//   and indices, 4*M + 12*G*k bytes; the extraction does k comparisons per
//   score. At M = 2^20 and k = 100 that is ~5.4 MB (1.6 us at 3.35 TB/s) and
//   1e8 comparisons (1.6 us at 67 Tops/s). This simple design is far from
//   either: it is bound by the k rounds of block-wide synchronisation.
//
// Design: one CTA of 256 threads per block of scores. Each thread keeps four
//   scores in registers as packed 64-bit entries (key << 32 | 1024 - local
//   index), so one unsigned max is the whole comparison, ties included, and
//   0 means "taken or not an element". Each of the k rounds takes a
//   warp-shuffle max, one shared-memory slot per warp (double-buffered by
//   round parity, so one __syncthreads a round suffices), and every thread
//   reads the eight warp winners. Only the thread that owns the winner
//   clears it and rescans its four entries. k <= B is the caller's
//   precondition, so a round always finds an element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kMaxBlock = kThreads * kPer;   // 1024
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ scores, int64_t M, int block,
                  int k, float* __restrict__ vals, int64_t* __restrict__ idx) {
  __shared__ unsigned long long warp_best[2][kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const int64_t out = static_cast<int64_t>(blockIdx.x) * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neg_inf = __uint_as_float(0xFF800000u);

  unsigned long long e[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int local = tid + r * kThreads;
    if (local < block) {
      const int64_t g = base + local;
      const float x = g < M ? scores[g] : neg_inf;
      e[r] = (static_cast<unsigned long long>(order_key(x)) << 32) |
             static_cast<unsigned>(kMaxBlock - local);
    } else {
      e[r] = 0ull;
    }
  }
  unsigned long long mine = umax64(umax64(e[0], e[1]), umax64(e[2], e[3]));

  for (int j = 0; j < k; ++j) {
    unsigned long long w = mine;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w = umax64(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (lane == 0) warp_best[j & 1][warp] = w;
    __syncthreads();
    unsigned long long best = warp_best[j & 1][0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) best = umax64(best, warp_best[j & 1][i]);
    const int local = kMaxBlock - static_cast<int>(best & 0xFFFFFFFFull);
    if (tid == 0) {
      vals[out + j] = key_value(static_cast<uint32_t>(best >> 32));
      idx[out + j] = base + local;
    }
    if (local % kThreads == tid) {
      const int slot = local / kThreads;
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        if (r == slot) e[r] = 0ull;
      mine = umax64(umax64(e[0], e[1]), umax64(e[2], e[3]));
    }
  }
}

}  // namespace

// scores: [M] fp32; vals: [G, k] fp32; idx: [G, k] int64 (index into scores),
// G = ceil(M / block), 1 <= k <= block <= 1024. Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
extern "C" int block_topk_f32(const void* scores, int64_t M, int block, int k,
                              void* vals, void* idx, void* stream) {
  const int64_t G = (M + block - 1) / block;
  if (G > 0) {
    block_topk_kernel<<<static_cast<unsigned>(G), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), M, block, k,
        static_cast<float*>(vals), static_cast<int64_t*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}
