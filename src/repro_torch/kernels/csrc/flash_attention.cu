// Attention forward, causal or full, with an online softmax: out = softmax(
// q k^T * sm_scale, masked) v for q [BH, S, D], k/v [BH, T, D], fp32 or bf16.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
//   _fa_kernel, flash_attention.py:28, launched at :82). Same arithmetic: q
//   is read in fp32 and scaled by sm_scale before the product; scores, the
//   running max m, the running sum l and the accumulator are fp32; a causal
//   mask writes -2^30 (not -inf) where a key lies after the query; each kv
//   tile updates m_new = max(m, rowmax), p = exp(s - m_new), alpha =
//   exp(m - m_new), l = l * alpha + sum(p), acc = acc * alpha + p v; the
//   output is acc / max(l, 1e-30) cast to q's dtype. As in the reference, p
//   stays fp32 in the p v product (the reference casts p to v's dtype after
//   reading v as fp32). For causal attention the kv loop stops at the last
//   tile that holds a key at or before the tile's last query (:37-39).
//   Keys past T (a ragged last tile) get p = 0; query rows past S are not
//   written. A query row's result depends only on the keys its loop visits,
//   so the first rows of a longer causal run equal, to the bit, the run on
//   their prefix.
//
// Bound on the H100: operations. The causal forward does 4*B*H*D*S(S+1)/2
//   flops (two products over the lower triangle) and moves 4*B*H*S*D values:
//   at [1, 16, 4096, 128] bf16, 6.87e10 flops (0.069 ms at the 989 TFLOP/s
//   dense bf16 tensor rate) against 67 MB (0.020 ms). This first kernel uses
//   no tensor cores (no wgmma, no TMA): its own ceiling is the 67 TFLOP/s of
//   fp32 FMA, 1.03 ms at that shape.
//
// Design: one CTA of 256 threads per (batch*head, tile of 64 queries); the
//   query tiles are walked last first, so the longest causal rows start
//   first. The q tile (pre-scaled, fp32) stays in shared memory; each kv
//   tile of 64 keys is staged into one shared buffer, first K for the
//   scores, then V for the product, converted to fp32 on the way in. Thread
//   (ty, tx) owns query rows ty + 16a and keys tx + 16b (a, b < 4) of the
//   score tile, reading q and k rows as float4 along D (rows padded by four
//   floats, so the 16 distinct k rows of a warp spread over all banks), and
//   the same query rows times columns 64c + 4tx.. of the output. Row max
//   and row sum reduce over the 16 lanes of a row with shuffles, so m, l,
//   alpha and the accumulator stay in the thread's registers; p goes through
//   shared memory (row stride 80: the two rows of a warp land on disjoint
//   banks). D = 128 takes 88 KB of shared memory, two CTAs an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                     // queries per CTA
constexpr int kBK = 64;                     // keys per kv tile
constexpr int kThreads = 256;
constexpr int kLdP = kBK + 16;              // p tile row stride, floats
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

template <int D>
struct Tile {
  static constexpr int kLd = D + 4;         // q and kv row stride, floats
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kKV = kBK * kLd;
  static constexpr int kP = kBQ * kLdP;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKV + kP);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);   // little endian
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Rows row0.. of a [rows, D] matrix into a [R, D + 4] fp32 tile, times
// `scale`; rows at or past `rows` are zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row0, int64_t rows,
                                          float scale) {
  constexpr int kChunks = R * D / 4;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      v = load4(src + (row0 + r) * D + col);
      v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * Tile<D>::kLd + col) = v;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t S,
                 int64_t T_len, float sm_scale, int causal) {
  constexpr int kLd = Tile<D>::kLd;
  constexpr int kC = D / 64;                // float4 output columns a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kvs = qs + Tile<D>::kQ;
  float* ps = kvs + Tile<D>::kKV;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t bh = blockIdx.y;
  const T* kb_ptr = k + bh * T_len * D;
  const T* vb_ptr = v + bh * T_len * D;

  load_tile<T, D, kBQ>(qs, q + bh * S * D, q0, S, sm_scale);

  float m[4], l[4], acc[4][4 * kC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kC; ++c) acc[a][c] = 0.f;
  }

  int64_t nkb = (T_len + kBK - 1) / kBK;
  if (causal) {
    const int64_t last_q = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
    nkb = nkb < last_q / kBK + 1 ? nkb : last_q / kBK + 1;
  }

  for (int64_t kt = 0; kt < nkb; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();                        // the last tile's p v is done
    load_tile<T, D, kBK>(kvs, kb_ptr, k0, T_len, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kk[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * kLd + d);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        kk[b] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * b) * kLd + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qa[a].x, kk[b].x, s[a][b]);
          s[a][b] = fmaf(qa[a].y, kk[b].y, s[a][b]);
          s[a][b] = fmaf(qa[a].z, kk[b].z, s[a][b]);
          s[a][b] = fmaf(qa[a].w, kk[b].w, s[a][b]);
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int64_t qpos = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t kpos = k0 + tx + 16 * b;
        if (kpos >= T_len) s[a][b] = -INFINITY;          // no key: p = 0
        else if (causal && kpos > qpos) s[a][b] = kNegInf;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max16(mx));
      const float alpha = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = expf(s[a][b] - m_new);
        rs += s[a][b];
      }
      l[a] = l[a] * alpha + row_sum16(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kC; ++c) acc[a][c] *= alpha;
    }

    __syncthreads();                        // every score read k
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        ps[(ty + 16 * a) * kLdP + tx + 16 * b] = s[a][b];
    load_tile<T, D, kBK>(kvs, vb_ptr, k0, T_len, 1.0f);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(ps + (ty + 16 * a) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              kvs + (j + jj) * kLd + c * 64 + tx * 4);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = comp(pa[a], jj);
            acc[a][4 * c + 0] = fmaf(p, vv.x, acc[a][4 * c + 0]);
            acc[a][4 * c + 1] = fmaf(p, vv.y, acc[a][4 * c + 1]);
            acc[a][4 * c + 2] = fmaf(p, vv.z, acc[a][4 * c + 2]);
            acc[a][4 * c + 3] = fmaf(p, vv.w, acc[a][4 * c + 3]);
          }
        }
      }
    }
  }

  T* ob = o + bh * S * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = q0 + ty + 16 * a;
    if (row >= S) continue;
    const float den = l[a] < 1e-30f ? 1e-30f : l[a];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      store4(ob + row * D + c * 64 + tx * 4,
             make_float4(acc[a][4 * c + 0] / den, acc[a][4 * c + 1] / den,
                         acc[a][4 * c + 2] / den, acc[a][4 * c + 3] / den));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t BH,
           int64_t S, int64_t T_len, int causal, float sm_scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile<D>::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(BH));
  kernel<<<grid, kThreads, Tile<D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [BH, S, D], k/v: [BH, T, D], o: [BH, S, D], contiguous and 16-byte
// aligned, fp32 (bf16 = 0) or bf16 (bf16 = 1); D is 64 or 128 (else
// returns cudaErrorInvalidValue); S >= 1, 1 <= BH <= 65535. Launches on
// `stream`, does not synchronise, returns the first CUDA error.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int64_t BH, int64_t S, int64_t T,
                                   int D, int bf16, int causal, float sm_scale,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && !bf16)
    return launch<float, 64>(q, k, v, o, BH, S, T, causal, sm_scale, s);
  if (D == 128 && !bf16)
    return launch<float, 128>(q, k, v, o, BH, S, T, causal, sm_scale, s);
  if (D == 64 && bf16)
    return launch<__nv_bfloat16, 64>(q, k, v, o, BH, S, T, causal, sm_scale, s);
  if (D == 128 && bf16)
    return launch<__nv_bfloat16, 128>(q, k, v, o, BH, S, T, causal, sm_scale,
                                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
