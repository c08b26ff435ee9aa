// Top-k selection in lax.top_k's order, by radix select: per-block
// candidates, the whole masked top-k in one launch, and the fused
// Algorithm-3 selection step (score, masks, top-k, booster update) in one
// launch.
//
// Replaces: src/repro/kernels/topk.py::block_topk (the Pallas _topk_kernel,
//   topk.py:61), the lax.top_k reduce of its G*k candidates in
//   ops.masked_topk (ops.py:283-305), and the elementwise composition around
//   them in ops.scored_topk (ops.py:308-329).
//
// Order: lax.top_k's total order on fp32 (-NaN < -inf < ... < -0 < +0 < ...
//   < +inf < +NaN), read as an unsigned 32-bit key (order_key); equal keys go
//   to the lower index. An element is a packed 64-bit key, order key high and
//   the inverted global index low, so one unsigned comparison ranks it, ties
//   included, and no two elements are equal. The key 0 means "no element"
//   (a real element's low half is never ~0u: indices stay below 2^31).
//
// Bound on the H100: masked_topk reads M fp32 scores once and writes k
//   values and indices (4*M + 12*k bytes, 1.25 us at M = 2^20, k = 100 and
//   3.35 TB/s); the fused step reads num, den, booster (fp32) and eligible,
//   ever (bool) and writes the new booster: 18 bytes a slot, 5.6 us at
//   2^20. About one comparison per score, far below the 67 Tops/s rate, so
//   both are bound by bytes. No tensor cores and no TMA: this is SIMT work
//   (comparisons, shared-memory histograms, atomics, a bitonic sort).
//
// Design: one CTA of 1,024 threads per tile of kTile = 8,192 scores, so
//   M = 2^20 is 128 CTAs (one wave on 132 SMs) and M <= 8,192 is one CTA
//   (block_topk: one CTA per block of <= 1,024 scores). A CTA stages its
//   tile's order keys in shared memory (every load of a thread issued
//   before the first is used) and selects its top k without k serial
//   rounds:
//   1. radix select on the 32-bit order key, 8 bits a pass, most
//      significant first: a 256-bin histogram of the digit of the elements
//      that match the threshold's prefix so far (the first pass is counted
//      while staging), then one warp finds the bin where the count from the
//      top reaches k. Half a fleet's scores are -inf and ties are common, so
//      one bin may take most of a tile: each warp adds a digit once
//      (__match_any_sync + popc), not once a thread. A bin that holds
//      exactly the elements still needed ends the passes early;
//   2. compaction: elements above the threshold prefix are taken in any
//      order; of those equal to it, the lowest positions, by a block-wide
//      ordered scan (ballots), which are the lowest indices;
//   3. a bitonic sort of the <= k survivors, descending, in shared memory
//      (steps inside a warp synchronise the warp only).
//   Each CTA writes its k candidates (packed keys, tile-major, each tile
//   sorted) to a scratch buffer, fences, and takes a ticket; the CTA that
//   draws the last one selects the global top k from the G*k candidates the
//   same way, reading them from L2 (eight loads in flight a thread). In the
//   scratch, equal order keys lie in ascending index order, so step 2's
//   position order is still index order. The last CTA writes vals, idx
//   (and, fused, valid and the booster reset of the chosen slots, after
//   every other CTA's booster writes) and resets the ticket to 0, so the
//   next call, or a CUDA-graph replay, starts clean. Copying the candidates
//   into shared memory before the merge was tried and gained next to
//   nothing: the merge is bound by its barriers and scans, not by L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;          // scores per CTA of the one-launch modes
constexpr int kMaxK = 1024;
constexpr int kBins = 256;
constexpr int kBatch = 8;            // positions a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == kMaxK, "sort_desc: thread i owns element i");

enum Mode { kBlock = 0, kMasked = 1, kScored = 2 };

struct Args {
  const float* scores;          // kBlock, kMasked
  const float* num;             // kScored
  const float* den;
  const float* booster;
  const uint8_t* eligible;
  const uint8_t* ever;
  float beta;
  int64_t M;
  int tile;                     // scores per CTA
  int k;
  unsigned long long* scratch;  // [G, k] packed candidates (G > 1)
  unsigned* ticket;             // one counter, 0 between calls
  float* vals;                  // kBlock: [G, k]; else [k]
  int64_t* idx;
  bool* valid;                  // kScored: [k]
  float* new_booster;           // kScored: [M]
};

struct Shared {
  uint32_t keys[kTile];                 // the tile's order keys
  unsigned long long sel[kMaxK];        // survivors, then sorted
  uint32_t hist[kBins];
  uint32_t warp_off[kWarps];
  uint32_t total;
  uint32_t digit, above, bin_count, taken;
  int last;
};

__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ unsigned long long pack(uint32_t key, int64_t i) {
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(i));
}

// The tile's element at position p: its order key from shared memory and
// its global index base + p.
struct TileSrc {
  const uint32_t* keys;
  int64_t base;
  __device__ unsigned long long operator()(int p) const {
    return pack(keys[p], base + p);
  }
};

// The candidates in the scratch buffer, written by other CTAs before their
// fence: read past L1.
struct ScratchSrc {
  const unsigned long long* cand;
  __device__ unsigned long long operator()(int p) const {
    return __ldcg(cand + p);
  }
};

// src's positions t*kThreads + tid for t in [t0, t0 + kBatch), 0 past n:
// the loads of a batch are issued together, so a pass over the scratch in
// L2 waits on its latency once a batch, not once a position.
template <class Src>
__device__ __forceinline__ void load_batch(const Src& src, int n, int t0,
                                           unsigned long long (&e)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int p = (t0 + u) * kThreads + static_cast<int>(threadIdx.x);
    e[u] = p < n ? src(p) : 0ull;
  }
}

// The top k (k <= present elements) of src's n positions into sh.sel[0..k),
// unordered. Position order must be index order among equal order keys.
// With top_hist, sh.hist already holds the first pass's histogram (the
// top digit of every element).
template <class Src>
__device__ void select_top(const Src& src, int n, int k, bool top_hist,
                           Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int trips = (n + kThreads - 1) / kThreads;   // uniform loop bound
  const unsigned below = (1u << lane) - 1u;
  uint32_t prefix = 0, pmask = 0;
  int remaining = k;
  bool exact = false;
  for (int shift = 24; shift >= 0 && !exact; shift -= 8) {
    const bool counted = top_hist && shift == 24;
    if (!counted) {
      for (int b = tid; b < kBins; b += kThreads) sh.hist[b] = 0;
      __syncthreads();
    }
    for (int t0 = 0; t0 < (counted ? 0 : trips); t0 += kBatch) {
      unsigned long long e[kBatch];
      load_batch(src, n, t0, e);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const uint32_t hi = static_cast<uint32_t>(e[u] >> 32);
        const uint32_t d = (e[u] != 0ull && (hi & pmask) == prefix)
                               ? (hi >> shift) & 0xFFu : kBins;
        const unsigned peers = __match_any_sync(kFull, d);
        if (d < kBins && lane == __ffs(peers) - 1)
          atomicAdd(&sh.hist[d], static_cast<uint32_t>(__popc(peers)));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255-8l .. 248-8l; count from the top
      uint32_t c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sh.hist[kBins - 1 - 8 * lane - j];
        s += c[j];
      }
      uint32_t incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      uint32_t above = incl - s;
      const uint32_t need = static_cast<uint32_t>(remaining);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (above < need && above + c[j] >= need) {
          sh.digit = kBins - 1 - 8 * lane - j;
          sh.above = above;
          sh.bin_count = c[j];
        }
        above += c[j];
      }
    }
    __syncthreads();
    prefix |= sh.digit << shift;
    pmask |= 0xFFu << shift;
    remaining -= static_cast<int>(sh.above);
    // the bin holds exactly the elements still needed: take them all
    exact = sh.bin_count == static_cast<uint32_t>(remaining);
    __syncthreads();                   // sh.* read before it is written again
  }
  // compaction: above the prefix (and, when exact, equal to it) anywhere in
  // sh.sel[0..); otherwise equal to it by position into
  // sh.sel[k-remaining..k), the lowest positions first
  if (tid == 0) sh.taken = 0;
  __syncthreads();
  const int eq_base = k - remaining;
  uint32_t running = 0;
  bool eq_done = exact;                // uniform across the CTA
  for (int t0 = 0; t0 < trips; t0 += kBatch) {
    unsigned long long e[kBatch];
    load_batch(src, n, t0, e);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const uint32_t m = static_cast<uint32_t>(e[u] >> 32) & pmask;
      const bool up = e[u] != 0ull && (m > prefix || (exact && m == prefix));
      const unsigned up_ballot = __ballot_sync(kFull, up);
      if (up_ballot) {
        uint32_t slot = 0;
        if (lane == 0) slot = atomicAdd(&sh.taken, __popc(up_ballot));
        slot = __shfl_sync(kFull, slot, 0);
        if (up) sh.sel[slot + __popc(up_ballot & below)] = e[u];
      }
      if (eq_done) continue;
      const bool eq = e[u] != 0ull && m == prefix;
      const unsigned eq_ballot = __ballot_sync(kFull, eq);
      if (lane == 0) sh.warp_off[warp] = __popc(eq_ballot);
      __syncthreads();
      if (warp == 0) {
        const uint32_t c = sh.warp_off[lane];
        uint32_t incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const uint32_t v = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += v;
        }
        sh.warp_off[lane] = incl - c;
        if (lane == 31) sh.total = incl;
      }
      __syncthreads();
      const uint32_t rank = running + sh.warp_off[warp] +
                            __popc(eq_ballot & below);
      if (eq && rank < static_cast<uint32_t>(remaining))
        sh.sel[eq_base + rank] = e[u];
      running += sh.total;
      eq_done = running >= static_cast<uint32_t>(remaining);
      __syncthreads();               // warp_off read before the next write
    }
  }
  __syncthreads();
}

// sh.sel[0..cnt) sorted descending; cnt <= kMaxK.
__device__ void sort_desc(int cnt, Shared& sh) {
  int P = 1;
  while (P < cnt) P <<= 1;
  const int tid = threadIdx.x;
  for (int i = cnt + tid; i < P; i += kThreads) sh.sel[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = sh.sel[i], b = sh.sel[j];
          if (((i & size) == 0) ? (a < b) : (a > b)) {
            sh.sel[i] = b;
            sh.sel[j] = a;
          }
        }
      }
      // a step of stride < 32 stays inside each warp (thread i owns
      // element i, kThreads == kMaxK): between two such steps the warp
      // alone has to agree; a step that crosses warps, the step before
      // one, and the last step need the whole CTA
      const int next = stride > 1 ? stride >> 1 : size;
      if (stride >= 32 || next >= 32 || (size == P && stride == 1))
        __syncthreads();
      else
        __syncwarp();
    }
  }
}

// The top min(k, n) of src's n positions into sh.sel[0..), sorted; the rest
// of sh.sel[0..k) set to 0 (no element).
template <class Src>
__device__ void top_sorted(const Src& src, int n, int k, bool top_hist,
                           Shared& sh) {
  if (n <= k) {                     // every element survives
    for (int p = threadIdx.x; p < n; p += kThreads) sh.sel[p] = src(p);
    __syncthreads();
    sort_desc(n, sh);
    for (int i = n + threadIdx.x; i < k; i += kThreads) sh.sel[i] = 0ull;
    __syncthreads();
    return;
  }
  select_top(src, n, k, top_hist, sh);
  sort_desc(k, sh);
}

__device__ void write_final(const Args& a, int mode, Shared& sh) {
  for (int j = threadIdx.x; j < a.k; j += kThreads) {
    const unsigned long long e = sh.sel[j];
    const float v = key_value(static_cast<uint32_t>(e >> 32));
    const int64_t i = static_cast<uint32_t>(~static_cast<uint32_t>(e));
    a.vals[j] = v;
    a.idx[j] = i;
    if (mode == kScored) {
      const bool ok = v > __uint_as_float(0xFF800000u);   // NaN: false
      a.valid[j] = ok;
      if (ok) a.new_booster[i] = 1.0f;
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
topk_select_kernel(Args a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * a.tile;
  const float neg_inf = __uint_as_float(0xFF800000u);
  const float pos_inf = __uint_as_float(0x7F800000u);

  // stage the tile's order keys (block mode reads past M as -inf) and
  // count their top digits, the radix select's first pass; every load of a
  // thread is issued before the first is used
  const int64_t left = a.M - base;
  const int n = kMode == kBlock ? a.tile
                                : static_cast<int>(left < a.tile ? left
                                                                 : a.tile);
  for (int b = tid; b < kBins; b += kThreads) sh.hist[b] = 0;
  __syncthreads();
  constexpr int kPer = kTile / kThreads;
  uint32_t key[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int p = r * kThreads + tid;
    if (p < n) {
      const int64_t g = base + p;
      float s;
      if (kMode == kScored) {
        const float b = a.booster[g];
        const bool elig = a.eligible[g] != 0;
        float den = a.den[g];
        den = den < 1e-12f ? 1e-12f : den;    // clamp_min: NaN stays NaN
        s = __fmul_rn(b, __fdiv_rn(a.num[g], den));
        s = a.ever[g] != 0 ? s : pos_inf;
        s = elig ? s : neg_inf;
        a.new_booster[g] = elig ? __fmul_rn(b, a.beta) : b;
      } else {
        s = g < a.M ? a.scores[g] : neg_inf;
      }
      key[r] = order_key(s);
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int p = r * kThreads + tid;
    uint32_t d = kBins;
    if (p < n) {
      sh.keys[p] = key[r];
      d = key[r] >> 24;
    }
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < kBins && (tid & 31) == __ffs(peers) - 1)
      atomicAdd(&sh.hist[d], static_cast<uint32_t>(__popc(peers)));
  }
  __syncthreads();

  const TileSrc tile{sh.keys, base};
  top_sorted(tile, n, a.k, true, sh);
  if (kMode == kBlock) {
    const int64_t out = static_cast<int64_t>(blockIdx.x) * a.k;
    for (int j = tid; j < a.k; j += kThreads) {
      const unsigned long long e = sh.sel[j];
      a.vals[out + j] = key_value(static_cast<uint32_t>(e >> 32));
      a.idx[out + j] = static_cast<uint32_t>(~static_cast<uint32_t>(e));
    }
    return;
  }
  if (gridDim.x == 1) {
    write_final(a, kMode, sh);
    return;
  }
  unsigned long long* cand =
      a.scratch + static_cast<int64_t>(blockIdx.x) * a.k;
  for (int j = tid; j < a.k; j += kThreads) cand[j] = sh.sel[j];
  __threadfence();                  // candidates and booster before the ticket
  __syncthreads();
  if (tid == 0) sh.last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();

  const ScratchSrc all{a.scratch};
  const int nc = static_cast<int>(gridDim.x) * a.k;
  select_top(all, nc, a.k, false, sh);   // present >= k: M >= k
  sort_desc(a.k, sh);
  write_final(a, kMode, sh);
  if (tid == 0) *a.ticket = 0u;
}

template <int kMode>
int launch(const Args& a, void* stream) {
  const int64_t G = (a.M + a.tile - 1) / a.tile;
  if (G > 0) {
    topk_select_kernel<kMode><<<static_cast<unsigned>(G), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Per-block candidates. scores: [M] fp32; vals: [G, k] fp32; idx: [G, k]
// int64 (index into scores), G = ceil(M / block), 1 <= k <= block <= 1024;
// positions past M act as -inf scores. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int block_topk_f32(const void* scores, int64_t M, int block, int k,
                              void* vals, void* idx, void* stream) {
  Args a{};
  a.scores = static_cast<const float*>(scores);
  a.M = M;
  a.tile = block;
  a.k = k;
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int64_t*>(idx);
  return launch<kBlock>(a, stream);
}

// The top k of scores [M] fp32 (1 <= k <= min(M, 1024), M < 2^31) into
// vals [k] fp32 and idx [k] int64, one launch. scratch: [ceil(M/8192), k]
// int64, and ticket, one uint32 that is 0 on entry and on exit: both unused
// (may be null) when M <= 8192.
extern "C" int masked_topk_f32(const void* scores, int64_t M, int k,
                               void* scratch, void* ticket, void* vals,
                               void* idx, void* stream) {
  Args a{};
  a.scores = static_cast<const float*>(scores);
  a.M = M;
  a.tile = kTile;
  a.k = k;
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.ticket = static_cast<unsigned*>(ticket);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int64_t*>(idx);
  return launch<kMasked>(a, stream);
}

// The fused selection step over [M] slots (num, den, booster fp32;
// eligible, ever bool), one launch: score booster * (num / max(den, 1e-12))
// (NaN kept), +inf where never invoked, then -inf where ineligible; its top
// k into vals, idx, valid (= vals > -inf); new_booster = eligible ?
// booster * beta : booster, then 1 at every valid pick. scratch and ticket
// as for masked_topk_f32.
extern "C" int scored_topk_f32(const void* num, const void* den,
                               const void* booster, const void* eligible,
                               const void* ever, float beta, int64_t M, int k,
                               void* scratch, void* ticket, void* vals,
                               void* idx, void* valid, void* new_booster,
                               void* stream) {
  Args a{};
  a.num = static_cast<const float*>(num);
  a.den = static_cast<const float*>(den);
  a.booster = static_cast<const float*>(booster);
  a.eligible = static_cast<const uint8_t*>(eligible);
  a.ever = static_cast<const uint8_t*>(ever);
  a.beta = beta;
  a.M = M;
  a.tile = kTile;
  a.k = k;
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.ticket = static_cast<unsigned*>(ticket);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int64_t*>(idx);
  a.valid = static_cast<bool*>(valid);
  a.new_booster = static_cast<float*>(new_booster);
  return launch<kScored>(a, stream);
}
