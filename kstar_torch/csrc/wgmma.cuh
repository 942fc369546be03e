// Warpgroup matrix multiply (wgmma) for Hopper (sm_90a): the pieces the
// spatial-table kernel needs, written on the PTX instruction directly.
//
// wgmma.mma_async.m64nNk16 (bf16 operands, f32 sum; N 64 or 32): the four
// warps of a warpgroup (warp index a multiple of 4) multiply a 64 x 16 tile
// of A by a 16 x N tile of B. A comes from registers, each warp its own 16
// rows in the mma.m16n8k16 A-fragment layout (so ldmatrix loads it from any
// row-major tile); B comes from shared memory through a 64-bit matrix
// descriptor; the sum stays in registers, warp w holding rows 16 w .. 16 w
// + 15 as N / 8 m16n8 C fragments: d[j][i] is row lane / 4 + 8 * (i / 2),
// column 8 j + 2 * (lane % 4) + i % 2.
//
// B is "K-major" (row n of B holds output column n's k run) without
// swizzle, in the blocked layout the instruction reads: 8 x 8 core matrices
// of 128 contiguous bytes (8 rows of 16 bytes), the core matrices of one
// 8-row group side by side along k. Element (n, k) of an (N x K) panel sits
// at ((n / 8) * (K / 8) + k / 8) * 64 + (n % 8) * 8 + k % 8 elements. In the
// descriptor the leading-dimension byte offset is the step between core
// matrices along k (128) and the stride byte offset the step between 8-row
// groups (K * 16). The hardware reads whole core matrices, so there are no
// bank conflicts to pad away, and ldmatrix can read the same panel (each
// core-matrix row is 16 aligned bytes).
#pragma once

#include "common.cuh"

constexpr int kCoreElems = 64;              // one 8 x 8 bf16 core matrix

// Element offset of (n, k) in a blocked (N x K) panel.
__host__ __device__ constexpr int blocked_off(int n, int k, int K) {
  return ((n / 8) * (K / 8) + k / 8) * kCoreElems + (n % 8) * 8 + k % 8;
}

// Descriptor of a blocked K-major panel with K columns, starting at p (the
// first row of an 8-row group, k a multiple of 8).
__device__ __forceinline__ uint64_t wgmma_desc(const bf16* p, int K) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  const uint64_t lbo = 128, sbo = static_cast<uint64_t>(K) * 16;
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}
// One k step (16 columns) further along the panel: two core matrices.
__device__ __forceinline__ uint64_t wgmma_desc_next_k(uint64_t desc) {
  return desc + ((2 * 128) >> 4);
}

// Orders the warpgroup's register and shared-memory accesses before the
// wgmma instructions that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes shared memory written through the generic proxy (st.shared,
// cp.async) visible to wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[0..7] += A(regs) * B(desc)^T, asynchronous: a and d must not be touched until
// wgmma_wait() after the wgmma_commit() that follows.
__device__ __forceinline__ void wgmma_m64n64k16(float (*d)[4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The same with a 16 x 32 tile of B: d[0..3].
__device__ __forceinline__ void wgmma_m64n32k16(float (*d)[4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (+)= A * B^T on the instruction of width N (64 or 32)
template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (*d)[4], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  static_assert(N == 64 || N == 32, "wgmma widths compiled here: 64 and 32");
  if constexpr (N == 64)
    wgmma_m64n64k16(d, a, desc_b);
  else
    wgmma_m64n32k16(d, a, desc_b);
}
