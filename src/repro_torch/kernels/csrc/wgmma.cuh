// Hopper warpgroup matrix-multiply (wgmma) helpers shared by the kernels
// that run on the tensor cores (flash_attention.cu, systolic_matmul.cu):
// shared-memory descriptors for the 128-byte swizzled layout
// (16-byte chunk c of a 128-byte row r at chunk c ^ (r % 8), 8-row groups
// 1 KB apart), and the fence, commit and wait of the asynchronous products.
#pragma once

#include <cstdint>

#include "common.cuh"

// A wgmma shared-memory descriptor, 128-byte swizzle.  lbo and sbo in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of registers that a
// product in flight uses across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int h = 0; h < M; ++h) asm volatile("" : "+r"(r[i][h])::"memory");
}
