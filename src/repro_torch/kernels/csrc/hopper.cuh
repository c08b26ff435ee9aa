// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// tile loads through a tensor map, warpgroup matrix multiplies (wgmma, bf16
// or fp16) with their shared-memory descriptors, the warp-level TF32
// mma.sync and cp.async copies. Inline PTX only; no CUTLASS.
//
// Layout that every descriptor here assumes: a tile of 16-bit values is
// stored as "panels" of 64 columns (128 bytes a row), each panel written by
// one TMA box with the 128-byte swizzle, rows 128 bytes apart, so that
// eight rows make one 1,024-byte swizzle atom. Panels start on 1,024-byte
// boundaries.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. (A timeout that
// traps instead of hanging cost the D = 128 attention kernel 92 bytes of
// spills and serialised its wgmmas, so there is none.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
}

// ------------------------------------------------------------------- TMA
// One box of a 3-D tensor map at element coordinates (c0 innermost) into
// shared memory; completion is counted in bytes on `bar`. Parts of the
// box outside the tensor are filled with zeros (and still counted).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ----------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for the 128-byte swizzle. Offsets in
// bytes. K-major operand (rows of K contiguous): `sbo` is the step between
// 8-row atoms (1,024 for one 128-byte panel row); `lbo` is unused. MN-major
// operand (B transposed): `lbo` is the step between 64-column panels along
// N, `sbo` the step between atoms of 8 rows along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Accumulator layout of m64nNk16 (fp32), thread t of the warpgroup, warp
// w = t / 32, lane l: d[4j + e] is row 16w + l/4 + 8(e/2), column 8j +
// 2(l%4) + e%2. The A fragment from registers (16-bit) is the same layout
// at k16: a[0] = row r, k 2(l%4)..+1; a[1] = row r+8; a[2] = row r, k +8;
// a[3] = row r+8, k +8; the lower k in the lower 16 bits.

// The wgmma forms below take the 16-bit input type as a flag: kF16 picks
// .f16 (fp16), else .bf16. Their accumulator operand lists are shared.
#define HOPPER_ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
// D[64 x 128] (+)= A[64 x 16] B[16 x 128], 16-bit in, fp32 accumulator;
// A and B from shared memory, both K-major; scale_d = 0 overwrites D.
template <bool kF16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
#define HOPPER_SS(ty)                                                     \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {"       \
      HOPPER_D64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                       \
      : HOPPER_ACC64 : "l"(desc_a), "l"(desc_b), "r"(scale_d))
  if constexpr (kF16) HOPPER_SS("f16"); else HOPPER_SS("bf16");
#undef HOPPER_SS
}

// D[64 x 128] += A[64 x 16] B[16 x 128], 16-bit in, fp32 accumulator; A
// from registers (four 16-bit pairs a thread, the m16n8k16 A-fragment
// layout), B from shared memory, MN-major (transposed).
template <bool kF16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
#define HOPPER_RS(ty)                                                     \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." ty "." ty " {"       \
      HOPPER_D64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"         \
      : HOPPER_ACC64                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
  if constexpr (kF16) HOPPER_RS("f16"); else HOPPER_RS("bf16");
#undef HOPPER_RS
}

// D[64 x 64] += A[64 x 16] B[16 x 64], 16-bit in, fp32 accumulator; A from
// registers (four 16-bit pairs a thread, the m16n8k16 A-fragment layout),
// B from shared memory, MN-major (transposed).
template <bool kF16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
#define HOPPER_RS(ty)                                                     \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." ty "." ty " {"        \
      HOPPER_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"         \
      : HOPPER_ACC32                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
  if constexpr (kF16) HOPPER_RS("f16"); else HOPPER_RS("bf16");
#undef HOPPER_RS
}

// ------------------------------------------------------- mma.sync (TF32)
// D[16 x 8] += A[16 x 8] B[8 x 8], TF32 in (each operand a 32-bit pattern
// whose low 13 bits the caller has cleared), fp32 accumulator. Thread
// layout, g = lane / 4, t = lane % 4: a[0] row g col t, a[1] row g + 8 col
// t, a[2] row g col t + 4, a[3] row g + 8 col t + 4; b0 row t col g, b1
// row t + 4 col g; d[0], d[1] row g cols 2t, 2t + 1, d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------- cp.async
// 16 bytes from global to shared memory, asynchronously; with `valid`
// false nothing is read and the 16 bytes are zeros (`src` must still be a
// mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace hopper
