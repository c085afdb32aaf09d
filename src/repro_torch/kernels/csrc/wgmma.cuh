// Hopper warpgroup MMA (`wgmma`) and `cp.async` helpers for bf16 tiles in
// shared memory, shared by K4's tensor-core path (flash_attention.cu) and
// the operand-form probe (tools/wgmma_probe.cu).  Needs sm_90a.
//
// Tiles: rows of 64 bf16 (128 bytes) with the 128-byte swizzle: 16-byte
// chunk c of row r sits at byte r * 128 + ((c ^ (r % 8)) * 16), so 8 rows
// form one 1024-byte atom.  A wider row (D 128) is two such tiles side by
// side, `kBlockBytes` apart.  A tile starts 1024-byte aligned, which the
// swizzle and the descriptors' base offset of 0 assume.
//
// Operand forms (PTX ISA, wgmma.mma_async; CUTLASS's GMMA canonical
// layouts):
// - K-major, 128-byte swizzle (A and B of S = Q K^T): the stride byte
//   offset (SBO) is 1024, from one 8-row atom to the next along M or N; the
//   leading byte offset is unused (a k16 step reads 32 bytes of one row);
//   step kk along K starts 32 * kk bytes in (the swizzle is applied to the
//   address the hardware forms).
// - MN-major, 128-byte swizzle, transpose bit set (B = V [keys, D] of
//   O = P V): a 128-byte row holds 64 consecutive n of one k; SBO is 1024,
//   from one 8-k atom to the next; LBO is the stride from one 64-wide n
//   block to the next (`kBlockBytes`); step kk along K starts 2048 * kk
//   bytes in (16 rows).
// - A from registers (P of O = P V): a thread's four 32-bit registers hold
//   bf16 pairs of rows (w16 + l/4, +8) and k (2 (l%4) + {0,1}, +8), w the
//   warp and l the lane: the layout of the f32 accumulator of m64nNk16 for
//   n 16 kk .. 16 kk + 15, so S's accumulator becomes P's A in place.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

constexpr uint32_t kBlockBytes = 64 * 128;  // 64 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Shared-memory matrix descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// 16-byte copy to shared memory, zero-filled when !in (no bytes read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + 63 of a bf16 matrix with row stride `stride`
// elements and D columns (D a multiple of 8, at most 128) into a swizzled
// tile at `dst`, 16 bytes a copy, by kThreads threads (this one is `tid`);
// rows at or past `rows` are zero-filled.  A thread copies one 16-byte
// column of rows kStep apart, so its copies share one source pointer and
// their destinations differ by constants (kStep is a multiple of 8, so the
// swizzle is the same on each).
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int64_t stride, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kStep = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && kStep % 8 == 0 && 64 % kStep == 0,
                "a thread's copies share one column");
  const int c = tid % kChunks, r0 = tid / kChunks;
  const uint32_t d = dst + (c / 8) * kBlockBytes + sw128(r0, c % 8);
  const __nv_bfloat16* g = src + (int64_t)(row0 + r0) * stride + c * 8;
#pragma unroll
  for (int i = 0; i < 64 / kStep; ++i) {
    const bool in = row0 + r0 + i * kStep < rows;
    cp16(d + i * kStep * 128, in ? g + i * kStep * stride : src, in);
  }
}

// Make this thread's generic-proxy writes to shared memory (cp.async and
// plain stores) visible to wgmma's async-proxy reads; a barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous products (after `wait`, before `arrive`).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&t);
}

#define WG_D8(o)                                                      \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),         \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A from registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef WG_D8
#undef WG_D32
#undef WG_D64
#undef WG_R32
#undef WG_R64

}  // namespace wg
