// Fused Adam step over a whole cohort of flat client models, in place.
//
// Replaces: src/repro/kernels/fused_adam.py::fused_adam (the Pallas
//   _adam_kernel), which the reference calls once per client inside the
//   vmapped local-training scan (optim.adam_fused). Here one launch steps
//   every lane of the stacked [Kp, W] cohort:
//     m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2;
//     p = p - lr * (m*bc1) / (sqrt(v*bc2) + eps),
//   bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t), t = s+1 (computed in fp32 by the
//   caller, as the reference does). A lane with s >= steps[lane] has finished
//   its local epochs and keeps p, m and v as they are (the reference's
//   `active` select, core/client.py).
//
// Bound on the H100: device memory. An active element reads p, m, v, g and
//   writes p, m, v: 28 bytes for ~12 flops (one sqrt, one divide).
//   At Kp=128 lanes of W=582,656 that is ~2.09 GB a step with every lane
//   active.
//
// Design: a 2-D grid, blockIdx.y = lane. A finished lane's blocks return
//   before touching memory, so masked lanes move no bytes (the reference's
//   select reads and rewrites them). Each thread updates 4 consecutive
//   elements with 16-byte float4 loads and stores; the update is in place, so
//   the stacked params the trainer's per-leaf views read ARE the new models
//   and nothing is copied back.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct AdamConsts {
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2;
};

__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g,
                                      const AdamConsts& k) {
  m = k.b1 * m + k.omb1 * g;
  v = k.b2 * v + k.omb2 * g * g;
  p = p - k.lr * ((m * k.bc1) / (sqrtf(v * k.bc2) + k.eps));
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float4* __restrict__ p, float4* __restrict__ m,
                  float4* __restrict__ v, const float4* __restrict__ g,
                  const int32_t* __restrict__ steps, int32_t s, int64_t w4,
                  AdamConsts k) {
  const int64_t lane = blockIdx.y;
  if (s >= steps[lane]) return;   // finished lane: untouched
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= w4) return;
  const int64_t i = lane * w4 + c;
  float4 pp = p[i], mm = m[i], vv = v[i];
  const float4 gg = __ldg(g + i);
  adam1(pp.x, mm.x, vv.x, gg.x, k);
  adam1(pp.y, mm.y, vv.y, gg.y, k);
  adam1(pp.z, mm.z, vv.z, gg.z, k);
  adam1(pp.w, mm.w, vv.w, gg.w, k);
  p[i] = pp;
  m[i] = mm;
  v[i] = vv;
}

}  // namespace

// p, m, v, g: [Kp, W] fp32, contiguous, 16-byte aligned, W % 4 == 0;
// steps: [Kp] int32. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int fused_adam_f32(void* p, void* m, void* v, const void* g,
                              const void* steps, int32_t s, int64_t Kp,
                              int64_t W, float lr, float b1, float omb1,
                              float b2, float omb2, float eps, float bc1,
                              float bc2, void* stream) {
  const int64_t w4 = W / 4;
  const int64_t bx = (w4 + kThreads - 1) / kThreads;
  if (bx > 0 && Kp > 0) {
    const AdamConsts k{lr, b1, omb1, b2, omb2, eps, bc1, bc2};
    const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(Kp));
    fused_adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float4*>(p), static_cast<float4*>(m),
        static_cast<float4*>(v), static_cast<const float4*>(g),
        static_cast<const int32_t*>(steps), s, w4, k);
  }
  return static_cast<int>(cudaGetLastError());
}
