// Shared helpers of the port's hand-written Hopper kernels: element types,
// the vector engine's activation table and the error string every library
// exports.  Each kernel source includes this header and is built into its own
// shared library with a plain C interface (see kernels/_build.py).
#pragma once

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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
