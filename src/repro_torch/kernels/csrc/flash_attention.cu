// Attention forward, causal or full, with an online softmax: out = softmax(
// q k^T * sm_scale, masked) v for q [BH, S, D], k/v [BH, T, D], fp32 or bf16,
// D = 64 or 128. Each input type has one kernel: bf16 goes to a Hopper
// kernel (wgmma fed by TMA), fp32 to a kernel on the CUDA cores.
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
// Bound on the H100: operations. The causal forward does 4*B*H*D*S(S+1)/2
//   flops (two products over the lower triangle) and moves 4*B*H*S*D values:
//   at [1, 16, 4096, 128] bf16, 6.87e10 flops (0.069 ms at the 989 TFLOP/s
//   dense bf16 tensor rate) against 67 MB (0.020 ms); in fp32, 1.03 ms at
//   the 67 TFLOP/s of fp32 FMA.
//
// bf16 design (flash_fwd_kernel_wgmma): one CTA of three warpgroups per
//   (batch*head, tile of 128 queries), query tiles walked last first so the
//   longest causal rows start first. Warpgroup 0 is the producer: it gives
//   up registers (setmaxnreg.dec) and one thread issues every TMA load: the
//   q tile once, then K and V tiles of 128 keys into a two-stage ring, each
//   stage with a full barrier per tile (expect-tx bytes) and an empty one
//   (one arrival per consumer). The tensor maps are 3-D over [BH, rows, D],
//   so a ragged last tile reads zeros, never the next head. Tiles lie in
//   64-column panels with the 128-byte swizzle (a D = 128 row is two TMA
//   boxes); at D = 128 shared memory holds q 32 KB + 2 x (K 32 KB + V 32 KB),
//   one CTA an SM. Warpgroups 1 and 2 (setmaxnreg.inc) own 64 query rows
//   each, one wgmma M tile: S = Q K^T by wgmma m64n128k16 with Q and K both
//   K-major from shared memory; the online softmax runs in registers in the
//   accumulator's layout (a row's max and sum over the four lanes that share
//   it), with the masks applied only on the diagonal tile and the ragged
//   last tile; sm_scale scales the fp32 scores (bf16 x bf16 products are
//   exact in fp32, so this differs from the reference's pre-scaled q only by
//   fp32 rounding). P goes straight into the register A fragments of
//   O += P V, whose V stays in shared memory as an MN-major (transposed) B
//   operand. The reference keeps p in fp32; p rounded to bf16 once exceeds
//   the per-block check on some inputs (few-key rows whose v terms cancel),
//   so p is split into bf16 p_hi and p_lo = bf16(p - p_hi), two wgmmas into
//   the same accumulator (tests/test_torch_flash_attention.py emulates both
//   roundings). The epilogue divides by max(l, 1e-30) and stores bf16 pairs
//   from registers.
//
// fp32 design (flash_fwd_kernel<float, D>, no tensor cores: TF32 would not
//   meet the fp32 check): one CTA of 256 threads per (batch*head, tile of 64
//   queries), query tiles last first. The q tile (pre-scaled) stays in
//   shared memory; each kv tile of 64 keys is staged into one shared buffer,
//   first K for the scores, then V for the product. Thread (ty, tx) owns
//   query rows ty + 16a and keys tx + 16b (a, b < 4) of the score tile,
//   reading q and k rows as float4 along D (rows padded by four floats, so
//   the 16 distinct k rows of a warp spread over all banks), and the same
//   query rows times columns 64c + 4tx.. of the output. Row max and row sum
//   reduce over the 16 lanes of a row with shuffles, so m, l, alpha and the
//   accumulator stay in the thread's registers; p stays fp32 and goes
//   through shared memory (row stride 80: the two rows of a warp land on
//   disjoint banks). D = 128 takes 88 KB of shared memory, two CTAs an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// ------------------------------------------------------ bf16: wgmma + TMA
constexpr int kWgBQ = 128;                  // queries per CTA (two consumers)
constexpr int kWgBK = 128;                  // keys per kv tile
constexpr int kWgThreads = 384;             // producer + two consumers
constexpr int kStages = 2;                  // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

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

// p0, p1 (adjacent k) as a bf16 pair `hi` and the bf16 pair of what hi
// leaves out, `lo`: hi + lo carries about 16 bits of each p.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// O[64 x D] += P[64 x 16] V[16 x D] for one k16 step; V MN-major.
__device__ __forceinline__ void pv_step(float (&o)[64], const uint32_t (&a)[4],
                                        uint64_t desc_v) {
  hopper::wgmma_m64n128k16_rs(o, a, desc_v);
}

__device__ __forceinline__ void pv_step(float (&o)[32], const uint32_t (&a)[4],
                                        uint64_t desc_v) {
  hopper::wgmma_m64n64k16_rs(o, a, desc_v);
}

// One consumer warpgroup: query rows q0 + 64c .. +63 of head bh.
template <int D>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
    uint64_t* empty, int c, int q0, int nkb, int bh, int S, int T_len,
    float sm_scale, int causal, __nv_bfloat16* __restrict__ o) {
  using L = WgTile<D>;
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
      hopper::wgmma_m64n128k16_ss(s, hopper::desc_sw128(q_base + off, 16, 1024),
                                  hopper::desc_sw128(k_base + off, 16, 1024),
                                  kk > 0);
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

    // P straight into the A fragments of O += P V, split into a bf16 high
    // and low part: O += P_hi V + P_lo V keeps p to about fp32's accuracy
    uint32_t p_hi[kWgBK / 16][4], p_lo[kWgBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16(s[8 * kk + 2 * f], s[8 * kk + 2 * f + 1], p_hi[kk][f],
                   p_lo[kk][f]);
    hopper::mbar_wait(&v_full[st], ph);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t desc_v = hopper::desc_sw128(v_base + kk * 2048,
                                                 L::kPanelBytes, 1024);
      pv_step(acc, p_hi[kk], desc_v);
      pv_step(acc, p_lo[kk], desc_v);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (t == 0) hopper::mbar_arrive(&empty[st]);   // K and V read: free
  }

  __nv_bfloat16* ob = o + static_cast<int64_t>(bh) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const float sum = quad_sum(l[r]);
    const float den = sum < 1e-30f ? 1e-30f : sum;
    if (row >= S) continue;
    __nv_bfloat16* orow = ob + static_cast<int64_t>(row) * D + col0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * r] / den, acc[4 * i + 2 * r + 1] / den);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int S, int T_len,
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

  const int q0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int bh = blockIdx.y;
  int nkb = (T_len + kWgBK - 1) / kWgBK;
  if (causal) {
    const int last_q = (q0 + kWgBQ < S ? q0 + kWgBQ : S) - 1;
    nkb = nkb < last_q / kWgBK + 1 ? nkb : last_q / kWgBK + 1;
  }

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
    consume<D>(smem, q_full, k_full, v_full, empty, threadIdx.x / 128 - 1, q0,
               nkb, bh, S, T_len, sm_scale, causal, o);
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

// A 3-D map over [BH, rows, D] bf16 (D innermost), boxes of 64 x 128 rows
// with the 128-byte swizzle. Being 3-D, a box that runs past `rows` reads
// zeros, never the next head's rows.
bool tensor_map_3d(CUtensorMap* map, EncodeTiled encode, const void* base,
                   int64_t BH, int64_t rows, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int64_t BH, int64_t S, int64_t T_len, int causal,
                 float sm_scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map_3d(&tm_q, encode, q, BH, S, D)
      || !tensor_map_3d(&tm_k, encode, k, BH, T_len > 0 ? T_len : 1, D)
      || !tensor_map_3d(&tm_v, encode, v, BH, T_len > 0 ? T_len : 1, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel_wgmma<D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(WgTile<D>::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((S + kWgBQ - 1) / kWgBQ),
                  static_cast<unsigned>(BH));
  kernel<<<grid, kWgThreads, WgTile<D>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<int>(S), static_cast<int>(T_len), sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [BH, S, D], k/v: [BH, T, D], o: [BH, S, D], contiguous and 16-byte
// aligned, fp32 (bf16 = 0) or bf16 (bf16 = 1); D is 64 or 128 (else
// returns cudaErrorInvalidValue); 1 <= S, T < 2^31, 1 <= BH <= 65535.
// Launches on `stream`, does not synchronise, returns the first CUDA error.
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
    return launch_wgmma<64>(q, k, v, o, BH, S, T, causal, sm_scale, s);
  if (D == 128 && bf16)
    return launch_wgmma<128>(q, k, v, o, BH, S, T, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
