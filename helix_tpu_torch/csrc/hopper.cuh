// Hopper (sm_90a) building blocks shared by the port's kernels: 16-byte
// cp.async with zero fill, the async-proxy fence, the shared-memory matrix
// descriptor of a 128-byte-swizzled tile, and the wgmma.mma_async forms
// K2 uses (bf16 in, f32 accumulate) with their fence / commit / wait.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace helix {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes 16 zero
// bytes (the source address must still be valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously, with the same zero fill.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 64-column
// (128-byte) bf16 halves [half][row][128 B], 128-byte swizzled: chunk c of
// row r sits at position c ^ (r % 8) of its row, as wgmma's B128 layout
// reads it.  The tile must start 1024-byte aligned.
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk,
                                                 int rows) {
  const int half = chunk >> 3, c = chunk & 7;
  return (uint32_t)(half * rows * 128 + row * 128 + ((c ^ (row & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major
// operands: lbo 16 (unused), sbo 1024 (the next 8 rows of 128 B).
// MN-major operands: lbo is the stride between 64-element halves along MN,
// sbo 1024 (the next 8 rows along K).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads/writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define HELIX_ACC8(d, i)                                                  \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64x64] (+)= A[64x16] * B[16x64]: A and B from shared memory, both
// K-major (A rows = queries, B rows = keys, d contiguous).
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HELIX_ACC8(d, 0), HELIX_ACC8(d, 8), HELIX_ACC8(d, 16),
        HELIX_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x64] += A[64x16] * B[16x64]: A from registers (four packed bf16
// pairs per thread), B from shared memory MN-major (rows = keys, the 64
// output columns contiguous).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HELIX_ACC8(d, 0), HELIX_ACC8(d, 8), HELIX_ACC8(d, 16),
        HELIX_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// As above with 128 output columns (two 64-column halves, lbo apart).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HELIX_ACC8(d, 0), HELIX_ACC8(d, 8), HELIX_ACC8(d, 16),
        HELIX_ACC8(d, 24), HELIX_ACC8(d, 32), HELIX_ACC8(d, 40),
        HELIX_ACC8(d, 48), HELIX_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HELIX_ACC8

}  // namespace helix
