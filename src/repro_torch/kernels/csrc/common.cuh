// Shared helpers of the port's hand-written Hopper kernels: element types,
// the vector engine's activation table, 16-byte asynchronous copies,
// thread-block cluster barriers and distributed shared-memory loads, and
// the error string every library exports.  Each kernel source includes this
// header and is built into its own shared library with a plain C interface
// (see kernels/_build.py).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Element types, as the Python wrappers encode them.
enum DType : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

// Activations of systolic_matmul._ACTS, in the wrappers' order.
enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3,
                 ACT_TANH = 4, ACT_SIGMOID = 5 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// Round to nearest even, as PyTorch's and JAX's casts do.
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The epilogue in fp32.  gelu is the tanh approximation
// (jax.nn.gelu(approximate=True), F.gelu(approximate="tanh")).
__device__ __forceinline__ float apply_act(int act, float x) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x * sigmoid_f32(x);
    case ACT_TANH: return tanhf(x);
    case ACT_SIGMOID: return sigmoid_f32(x);
    default: return x;
  }
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One 16-byte chunk read element by element: the first `n` elements (zeros
// past them), for rows and bases that 16-byte loads cannot take.
__device__ __forceinline__ uint4 ld_chunk(const float* p, int n) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? __float_as_uint(p[j]) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint4 ld_chunk(const __nv_bfloat16* p, int n) {
  const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (2 * j < n ? q[2 * j] : 0u) |
           ((2 * j + 1 < n ? static_cast<uint32_t>(q[2 * j + 1]) : 0u) << 16);
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The shared-memory address of a pointer into this block's shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !ok (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Shared address `addr` of this block, as the same address of cluster rank
// `rank`'s block.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// 16 bytes at shared address `addr` of cluster rank `rank`.
__device__ __forceinline__ float4 ld_cluster16(uint32_t addr, uint32_t rank) {
  const uint32_t remote = cluster_addr(addr, rank);
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// 8 bytes at shared address `addr` of cluster rank `rank`.
__device__ __forceinline__ float2 ld_cluster8(uint32_t addr, uint32_t rank) {
  const uint32_t remote = cluster_addr(addr, rank);
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// 4 bytes at shared address `addr` of cluster rank `rank`.
__device__ __forceinline__ float ld_cluster4(uint32_t addr, uint32_t rank) {
  const uint32_t remote = cluster_addr(addr, rank);
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// 16 bytes to shared address `addr` of cluster rank `rank`.
__device__ __forceinline__ void st_cluster16(uint32_t addr, uint32_t rank,
                                             float4 v) {
  const uint32_t remote = cluster_addr(addr, rank);
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
