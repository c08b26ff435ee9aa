// Attention forward, causal or full, with an online softmax: out = softmax(
// q k^T * sm_scale, masked) v for q [BH, S, D], k/v [BH, T, D], fp32, bf16
// or fp16, D = 64 or 128 (the wrapper pads any other D <= 128 with zero
// columns). bf16 and fp16 go to one Hopper kernel (wgmma fed by TMA), fp32
// to a kernel of three TF32 tensor-core products for each product.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
//   _fa_kernel, flash_attention.py:28, launched at :82). Same arithmetic:
//   scores, the running max m, the running sum l and the accumulator are
//   fp32; a causal mask writes -2^30 (not -inf) where a key lies after the
//   query; each kv tile updates m_new = max(m, rowmax), p = exp(s - m_new),
//   alpha = exp(m - m_new), l = l * alpha + sum(p), acc = acc * alpha + p v;
//   the output is acc / max(l, 1e-30) cast to q's dtype. For causal
//   attention the kv loop stops at the last tile that holds a key at or
//   before the tile's last query (:37-39). Keys past T (a ragged last tile)
//   get p = 0; query rows past S are not written. A query row's result
//   depends only on its own tile's loop, so the first rows of a longer
//   causal run equal, to the bit, the run on their prefix.
//
// Grid (both kernels): one CTA per (batch*head, tile of 128 queries), on
//   one dimension, batch*head fastest and query tiles last first: the first
//   wave holds every head's longest causal rows, and B*H is bounded only by
//   the 2^31 - 1 blocks of gridDim.x.
//
// Bound on the H100: operations. The causal forward does 4*B*H*D*S(S+1)/2
//   flops (two products over the lower triangle) and moves 4*B*H*S*D values:
//   at [1, 16, 4096, 128] in 16 bits, 6.87e10 flops (0.069 ms at the 989
//   TFLOP/s dense bf16/fp16 tensor rate) against 67 MB (0.020 ms). fp32
//   products as three TF32 products are 2.06e11 TF32 flops, 0.416 ms at 495
//   TFLOP/s (the 67 TFLOP/s of fp32 FMA would take 1.03 ms).
//
// 16-bit design (flash_fwd_kernel_wgmma<T, D>, T bf16 or fp16): one CTA of
//   three warpgroups per (batch*head, tile of 128 queries). Warpgroup 0 is
//   the producer: it gives up registers (setmaxnreg.dec) and one thread
//   issues every TMA load: the q tile once, then K and V tiles of 128 keys
//   into a two-stage ring, each stage with a full barrier per tile
//   (expect-tx bytes) and an empty one (one arrival per consumer). The
//   tensor maps are 3-D over [BH, rows, D], so a ragged last tile reads
//   zeros, never the next head. Tiles lie in 64-column panels with the
//   128-byte swizzle (a D = 128 row is two TMA boxes); at D = 128 shared
//   memory holds q 32 KB + 2 x (K 32 KB + V 32 KB), one CTA an SM.
//   Warpgroups 1 and 2 (setmaxnreg.inc) own 64 query rows each, one wgmma M
//   tile: S = Q K^T by wgmma m64n128k16 with Q and K both K-major from
//   shared memory; the online softmax runs in registers in the
//   accumulator's layout (a row's max and sum over the four lanes that
//   share it), with the masks applied only on the diagonal tile and the
//   ragged last tile; sm_scale scales the fp32 scores (16-bit x 16-bit
//   products are exact in fp32, so this differs from the reference's
//   pre-scaled q only by fp32 rounding). P goes straight into the register
//   A fragments of O += P V, whose V stays in shared memory as an MN-major
//   (transposed) B operand. The reference keeps p in fp32; p rounded once
//   to bf16 exceeds the per-block check on some inputs (few-key rows whose
//   v terms cancel), so p is split into p_hi and p_lo = T(p - p_hi) of the
//   input's type, two wgmmas into the same accumulator
//   (tests/test_torch_flash_attention.py emulates both roundings). The
//   epilogue divides by max(l, 1e-30) and stores 16-bit pairs from
//   registers. bf16 and fp16 differ only in the wgmma type, the tensor
//   map's element type and the conversions.
//
// fp32 design (flash_fwd_kernel_tf32<D>): TF32 keeps 10 of fp32's 23
//   mantissa bits, and one TF32 product misses the fp32 check
//   (tests/test_torch_flash_attention.py emulates it). Three do not: with
//   hi = x with its low 13 bits cleared and lo = (x - hi) likewise,
//   a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi (what is dropped, a_lo b_lo and
//   lo's own low bits, is ~2^-21 of the product), for S = Q K^T and for
//   O += P V. The kernel clears the bits itself, so every operand is exact
//   in TF32 whatever the tensor core does with low bits.
//   Why mma.sync.m16n8k8 and not wgmma: TF32 wgmma reads B only K-major
//   from shared memory. For P V that is V^T, so every V tile would be
//   transposed into shared memory as hi and lo beside K's lo and q's hi and
//   lo: at D = 128 one 64-key stage is 160 KB (K, K_lo, V, V^T hi, V^T lo),
//   which leaves one consumer warpgroup and one stage. mma.sync loads its
//   fragments from the fp32 tiles as they land, splits them in registers,
//   and needs no transposed copy: a thread's P fragment is its own score
//   accumulator with the keys of each 8-key step permuted (k slot t <- key
//   2t, slot t + 4 <- key 2t + 1), and V's fragment rows are permuted the
//   same way (b0 <- V row 2t, b1 <- V row 2t + 1). What it costs: mma.sync
//   runs below wgmma's rate, so the 165 TFLOP/s fp32-equivalent of three
//   TF32 wgmmas is out of reach (PERF.md holds the measured rate).
//   Tiling: one CTA of eight warps per 128 queries, each warp 16 query rows
//   (one m16 tile). q, scaled by sm_scale in fp32 as the reference does,
//   stays in shared memory and is split per fragment; K and V tiles of 64
//   keys come through a two-stage cp.async ring, zero-filled past T (a
//   ragged tile reads zeros, never the next head's rows). Rows are D + 4
//   floats apart, so every fragment load (q and k: row g, column t; v: row
//   2t, column g) hits 32 distinct banks. Shared memory is (128 + 2 x 2 x
//   64) x (D + 4) x 4 bytes: 202,752 at D = 128 (one CTA an SM), 104,448 at
//   D = 64 (two). A warp's scores (eight n8 tiles, 32 registers) and output
//   (D / 8 n8 tiles, 64 registers at D = 128) stay in registers; the online
//   softmax runs in the accumulator's layout as in the 16-bit kernel, exp
//   as exp2 of s log2(e) - m log2(e) (one fma; its rounding is ~1e-6 of p,
//   far inside the check). Per
//   kv tile a warp issues 3 x 2 x 8 x D / 8 mma.sync (768 at D = 128). A
//   warp skips a causal tile whose keys all lie after its rows: there p is
//   0 and alpha 1 exactly, so skipping changes no bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF
constexpr int kBQ = 128;                    // queries per CTA (both kernels)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// The CTA's (batch*head, first query): batch*head fastest, query tiles
// last first.
__device__ __forceinline__ void cta_tile(int BH, int nq, int& bh, int& q0) {
  bh = static_cast<int>(blockIdx.x % static_cast<unsigned>(BH));
  q0 = (nq - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(BH)))
       * kBQ;
}

// Number of kv tiles of `bk` keys that queries q0 .. q0 + kBQ - 1 see.
__device__ __forceinline__ int kv_tiles(int q0, int S, int T_len, int bk,
                                        int causal) {
  int nkb = (T_len + bk - 1) / bk;
  if (causal) {
    const int last_q = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
    nkb = nkb < last_q / bk + 1 ? nkb : last_q / bk + 1;
  }
  return nkb;
}

// ------------------------------------------- fp32: three TF32 products
constexpr int kTfBK = 64;                   // keys per kv tile
constexpr int kTfThreads = 256;             // eight warps of 16 query rows
constexpr int kTfStages = 2;                // K/V ring depth

template <int D>
struct TfTile {
  static constexpr int kLd = D + 4;         // row stride, floats
  static constexpr int kQ = kBQ * kLd;      // floats
  static constexpr int kKV = kTfBK * kLd;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + 2 * kTfStages * kKV);
};

// x as TF32 hi + lo: hi is x with its low 13 mantissa bits cleared, lo is
// what hi leaves out with its own low 13 bits cleared.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}

// A[16 x 8] B[8 x 8] as three TF32 products into d: lo terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           float b0, float b1) {
  uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
  split_tf32(b0, b0_hi, b0_lo);
  split_tf32(b1, b1_hi, b1_lo);
  hopper::mma_m16n8k8_tf32(d, a_lo, b0_hi, b1_hi);
  hopper::mma_m16n8k8_tf32(d, a_hi, b0_lo, b1_lo);
  hopper::mma_m16n8k8_tf32(d, a_hi, b0_hi, b1_hi);
}

// Rows k0 .. k0 + kTfBK - 1 of a [T_len, D] matrix into a [kTfBK, D + 4]
// tile, asynchronously; rows at or past T_len are zeros.
template <int D>
__device__ __forceinline__ void load_kv_tile(float* dst,
                                             const float* __restrict__ src,
                                             int k0, int T_len) {
  constexpr int kChunks = kTfBK * D / 4;
  for (int c = threadIdx.x; c < kChunks; c += kTfThreads) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    const bool valid = k0 + r < T_len;
    const float* from = valid ? src + static_cast<int64_t>(k0 + r) * D + col
                              : src;
    hopper::cp_async16(dst + r * TfTile<D>::kLd + col, from, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kTfThreads, 1)
flash_fwd_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int BH, int nq, int S, int T_len, float sm_scale,
                      int causal) {
  using L = TfTile<D>;
  constexpr int kLd = L::kLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::kQ;                   // [stage][kTfBK][kLd]
  float* vs = ks + kTfStages * L::kKV;

  int bh, q0;
  cta_tile(BH, nq, bh, q0);
  const int nkb = kv_tiles(q0, S, T_len, kTfBK, causal);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp;          // the warp's first query
  const float* kb = k + static_cast<int64_t>(bh) * T_len * D;
  const float* vb = v + static_cast<int64_t>(bh) * T_len * D;

  if (nkb > 0) {
    load_kv_tile<D>(ks, kb, 0, T_len);
    load_kv_tile<D>(vs, vb, 0, T_len);
  }
  hopper::cp_async_commit();
  {   // q, scaled in fp32; rows past S are zeros
    const float* qb = q + static_cast<int64_t>(bh) * S * D;
    for (int c = threadIdx.x; c < kBQ * D / 4; c += kTfThreads) {
      const int r = c / (D / 4);
      const int col = (c % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < S) {
        x = *reinterpret_cast<const float4*>(
            qb + static_cast<int64_t>(q0 + r) * D + col);
        x.x *= sm_scale; x.y *= sm_scale; x.z *= sm_scale; x.w *= sm_scale;
      }
      *reinterpret_cast<float4*>(qs + r * kLd + col) = x;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums
  const float* qw = qs + 16 * warp * kLd;

  for (int j = 0; j < nkb; ++j) {
    const int st = j % kTfStages;
    if (j + 1 < nkb) {
      const int nxt = (j + 1) % kTfStages;
      load_kv_tile<D>(ks + nxt * L::kKV, kb, (j + 1) * kTfBK, T_len);
      load_kv_tile<D>(vs + nxt * L::kKV, vb, (j + 1) * kTfBK, T_len);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();             // tile j has landed
    __syncthreads();                        // ... for every thread (and q)
    const int k0 = j * kTfBK;
    if (!causal || k0 <= row0 + 15) {       // else p = 0, alpha = 1 exactly
      const float* kt = ks + st * L::kKV;
      const float* vt = vs + st * L::kKV;

      // S = Q K^T: a row's scores s[n][e], n8 tile n; rows g (e < 2) and
      // g + 8, keys 8n + 2t + e % 2
      float s[kTfBK / 8][4];
#pragma unroll
      for (int n = 0; n < kTfBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(qw[g * kLd + 8 * kk + t], a_hi[0], a_lo[0]);
        split_tf32(qw[(g + 8) * kLd + 8 * kk + t], a_hi[1], a_lo[1]);
        split_tf32(qw[g * kLd + 8 * kk + t + 4], a_hi[2], a_lo[2]);
        split_tf32(qw[(g + 8) * kLd + 8 * kk + t + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int n = 0; n < kTfBK / 8; ++n) {
          const float* kr = kt + (8 * n + g) * kLd + 8 * kk + t;
          mma_3xtf32(s[n], a_hi, a_lo, kr[0], kr[4]);
        }
      }

      const int qa = row0 + g;
      if (k0 + kTfBK > T_len || (causal && k0 + kTfBK - 1 > row0)) {
#pragma unroll
        for (int n = 0; n < kTfBK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            const int qpos = qa + 8 * (e >> 1);
            if (kpos >= T_len) s[n][e] = -INFINITY;       // no key: p = 0
            else if (causal && kpos > qpos) s[n][e] = kNegInf;
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kTfBK / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        alpha[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        const float mb = m_new * kLog2e;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < kTfBK / 8; ++n) {
          s[n][2 * r] = exp2f(fmaf(s[n][2 * r], kLog2e, -mb));
          s[n][2 * r + 1] = exp2f(fmaf(s[n][2 * r + 1], kLog2e, -mb));
          rs += s[n][2 * r] + s[n][2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + rs;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V over the tile's eight 8-key steps. A step's A fragment is
      // the scores of n8 tile kb with its keys permuted (slot t <- key 2t,
      // slot t + 4 <- key 2t + 1); V's rows are read in the same order.
#pragma unroll
      for (int kb8 = 0; kb8 < kTfBK / 8; ++kb8) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(s[kb8][0], a_hi[0], a_lo[0]);
        split_tf32(s[kb8][2], a_hi[1], a_lo[1]);
        split_tf32(s[kb8][1], a_hi[2], a_lo[2]);
        split_tf32(s[kb8][3], a_hi[3], a_lo[3]);
        const float* vr = vt + (8 * kb8 + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          mma_3xtf32(acc[n], a_hi, a_lo, vr[8 * n], vr[kLd + 8 * n]);
      }
    }
    __syncthreads();                        // stage st is free to refill
  }

  float* ob = o + static_cast<int64_t>(bh) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float sum = quad_sum(l[r]);
    const float den = sum < 1e-30f ? 1e-30f : sum;
    if (row >= S) continue;
    float* orow = ob + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int BH,
                int nq, int S, int T_len, int causal, float sm_scale,
                cudaStream_t stream) {
  auto kernel = flash_fwd_kernel_tf32<D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TfTile<D>::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(BH) * static_cast<unsigned>(nq), kTfThreads,
           TfTile<D>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, nq, S, T_len,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------- bf16 / fp16: wgmma + TMA
constexpr int kWgBK = 128;                  // keys per kv tile
constexpr int kWgThreads = 384;             // producer + two consumers
constexpr int kStages = 2;                  // K/V ring depth

// What differs between the two 16-bit types: the wgmma form, the tensor
// map's element type, and the conversions from fp32 pairs.
template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  static constexpr bool kF16 = false;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
};

template <>
struct Half16<__half> {
  static constexpr bool kF16 = true;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
};

template <int D>
struct WgTile {
  static constexpr int kPanels = D / 64;            // 128-byte boxes a row
  static constexpr int kPanelBytes = 128 * 128;     // 128 rows x 128 bytes
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kQ = 0;                      // byte offsets
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kNumBars = 1 + 3 * kStages;  // q, k/v full, empty
  // + 1,024 so the tiles can start on a 1,024-byte boundary
  static constexpr size_t kBytes = kBar + 8 * kNumBars + 1024;
};

// p0, p1 (adjacent k) as a 16-bit pair `hi` and the 16-bit pair of what hi
// leaves out, `lo`: hi + lo carries about twice the type's bits of each p.
template <typename T>
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = Half16<T>::pack(p0, p1);
  const float2 hf = Half16<T>::unpack(hi);
  lo = Half16<T>::pack(p0 - hf.x, p1 - hf.y);
}

// O[64 x D] += P[64 x 16] V[16 x D] for one k16 step; V MN-major.
template <bool kF16>
__device__ __forceinline__ void pv_step(float (&o)[64], const uint32_t (&a)[4],
                                        uint64_t desc_v) {
  hopper::wgmma_m64n128k16_rs<kF16>(o, a, desc_v);
}

template <bool kF16>
__device__ __forceinline__ void pv_step(float (&o)[32], const uint32_t (&a)[4],
                                        uint64_t desc_v) {
  hopper::wgmma_m64n64k16_rs<kF16>(o, a, desc_v);
}

// One consumer warpgroup: query rows q0 + 64c .. +63 of head bh.
template <typename T, int D>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
    uint64_t* empty, int c, int q0, int nkb, int bh, int S, int T_len,
    float sm_scale, int causal, T* __restrict__ o) {
  using L = WgTile<D>;
  constexpr bool kF16 = Half16<T>::kF16;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int row_a = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);   // and +8
  const int col0 = 2 * (lane & 3);
  const uint32_t q_base = hopper::smem_addr(smem + L::kQ) + 64 * c * 128;

  float acc[D / 2];
  float s[kWgBK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kWgBK / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};            // this thread's part of the row sums

  hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < nkb; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const uint32_t k_base = hopper::smem_addr(smem + L::kK + st * L::kTileBytes);
    const uint32_t v_base = hopper::smem_addr(smem + L::kV + st * L::kTileBytes);

    // S = Q K^T: Q and K K-major; a k16 step is 32 bytes into a panel
    hopper::mbar_wait(&k_full[st], ph);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kPanelBytes + (kk % 4) * 32;
      hopper::wgmma_m64n128k16_ss<kF16>(
          s, hopper::desc_sw128(q_base + off, 16, 1024),
          hopper::desc_sw128(k_base + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // online softmax in the accumulator's layout: a thread holds rows
    // row_a (s[4j], s[4j+1]) and row_a + 8 (s[4j+2], s[4j+3])
    const int k0 = j * kWgBK;
    const bool ragged = k0 + kWgBK > T_len;
    const bool diagonal = causal && k0 + kWgBK - 1 > q0 + 64 * c;
#pragma unroll
    for (int i = 0; i < kWgBK / 2; ++i) s[i] *= sm_scale;
    if (ragged || diagonal) {
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + col0 + (i & 1);
        const int qpos = row_a + 8 * ((i >> 1) & 1);
        if (kpos >= T_len) s[i] = -INFINITY;             // no key: p = 0
        else if (causal && kpos > qpos) s[i] = kNegInf;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kWgBK / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      const float mb = m_new * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < kWgBK / 8; ++i) {
        s[4 * i + 2 * r] = exp2f(fmaf(s[4 * i + 2 * r], kLog2e, -mb));
        s[4 * i + 2 * r + 1] = exp2f(fmaf(s[4 * i + 2 * r + 1], kLog2e, -mb));
        rs += s[4 * i + 2 * r] + s[4 * i + 2 * r + 1];
      }
      l[r] = l[r] * alpha[r] + rs;
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i + 0] *= alpha[0];
      acc[4 * i + 1] *= alpha[0];
      acc[4 * i + 2] *= alpha[1];
      acc[4 * i + 3] *= alpha[1];
    }

    // P straight into the A fragments of O += P V, split into a 16-bit
    // high and low part: O += P_hi V + P_lo V keeps p to about fp32's
    // accuracy
    uint32_t p_hi[kWgBK / 16][4], p_lo[kWgBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_pair<T>(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], p_hi[kk][f],
                      p_lo[kk][f]);
    hopper::mbar_wait(&v_full[st], ph);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t desc_v = hopper::desc_sw128(v_base + kk * 2048,
                                                 L::kPanelBytes, 1024);
      pv_step<kF16>(acc, p_hi[kk], desc_v);
      pv_step<kF16>(acc, p_lo[kk], desc_v);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (t == 0) hopper::mbar_arrive(&empty[st]);   // K and V read: free
  }

  T* ob = o + static_cast<int64_t>(bh) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const float sum = quad_sum(l[r]);
    const float den = sum < 1e-30f ? 1e-30f : sum;
    if (row >= S) continue;
    T* orow = ob + static_cast<int64_t>(row) * D + col0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) = Half16<T>::pack(
          acc[4 * i + 2 * r] / den, acc[4 * i + 2 * r + 1] / den);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       T* __restrict__ o, int BH, int nq, int S, int T_len,
                       float sm_scale, int causal) {
  using L = WgTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  int bh, q0;
  cta_tile(BH, nq, bh, q0);
  const int nkb = kv_tiles(q0, S, T_len, kWgBK, causal);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], 2);       // one arrival per consumer
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      hopper::mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        hopper::tma_load_3d(smem + L::kQ + p * L::kPanelBytes, &tm_q, q_full,
                            64 * p, q0, bh);
      for (int j = 0; j < nkb; ++j) {
        const int st = j % kStages;
        hopper::mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        uint8_t* kt = smem + L::kK + st * L::kTileBytes;
        uint8_t* vt = smem + L::kV + st * L::kTileBytes;
        hopper::mbar_expect_tx(&k_full[st], L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          hopper::tma_load_3d(kt + p * L::kPanelBytes, &tm_k, &k_full[st],
                              64 * p, j * kWgBK, bh);
        hopper::mbar_expect_tx(&v_full[st], L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          hopper::tma_load_3d(vt + p * L::kPanelBytes, &tm_v, &v_full[st],
                              64 * p, j * kWgBK, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<T, D>(smem, q_full, k_full, v_full, empty, threadIdx.x / 128 - 1,
                  q0, nkb, bh, S, T_len, sm_scale, causal, o);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched through the runtime,
// so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over [BH, rows, D] of 16-bit `type` (D innermost), boxes of
// 64 x 128 rows with the 128-byte swizzle. Being 3-D, a box that runs past
// `rows` reads zeros, never the next head's rows.
bool tensor_map_3d(CUtensorMap* map, EncodeTiled encode,
                   CUtensorMapDataType type, const void* base, int64_t BH,
                   int64_t rows, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int BH,
                 int nq, int S, int T_len, int causal, float sm_scale,
                 cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr CUtensorMapDataType type = Half16<T>::kMapType;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map_3d(&tm_q, encode, type, q, BH, S, D)
      || !tensor_map_3d(&tm_k, encode, type, k, BH, T_len > 0 ? T_len : 1, D)
      || !tensor_map_3d(&tm_v, encode, type, v, BH, T_len > 0 ? T_len : 1, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel_wgmma<T, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(WgTile<D>::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(BH) * static_cast<unsigned>(nq), kWgThreads,
           WgTile<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(o), BH, nq, S, T_len, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int T_len, int dtype, int causal, float sm_scale,
           cudaStream_t stream) {
  const int nq = (S + kBQ - 1) / kBQ;
  switch (dtype) {
    case 0:
      return launch_tf32<D>(q, k, v, o, BH, nq, S, T_len, causal, sm_scale,
                            stream);
    case 1:
      return launch_wgmma<__nv_bfloat16, D>(q, k, v, o, BH, nq, S, T_len,
                                            causal, sm_scale, stream);
    case 2:
      return launch_wgmma<__half, D>(q, k, v, o, BH, nq, S, T_len, causal,
                                     sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [BH, S, D], k/v: [BH, T, D], o: [BH, S, D], contiguous and 16-byte
// aligned, of one type: fp32 (dtype 0), bf16 (1) or fp16 (2); D is 64 or
// 128; 1 <= S < 2^31, 0 <= T < 2^31 and BH * ceil(S / 128) < 2^31 (else
// returns cudaErrorInvalidValue). Launches on `stream`, does not
// synchronise, returns the first CUDA error.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int64_t BH, int64_t S, int64_t T,
                                   int D, int dtype, int causal, float sm_scale,
                                   void* stream) {
  const int64_t blocks = BH * ((S + kBQ - 1) / kBQ);
  if (BH < 1 || S < 1 || T < 0 || S > INT32_MAX || T > INT32_MAX
      || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = static_cast<int>(BH), si = static_cast<int>(S),
            ti = static_cast<int>(T);
  if (D == 64) return launch<64>(q, k, v, o, bh, si, ti, dtype, causal,
                                 sm_scale, s);
  if (D == 128) return launch<128>(q, k, v, o, bh, si, ti, dtype, causal,
                                   sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
