// The DSA vector engine's three kernels.
//
// K2: the fused affine pass, y = act(x * scale + bias) with per-column (N,)
// scale and bias, computed in fp32 and cast.
//
// Replaces: src/repro/kernels/vector_engine.py::fused_affine_act
// (_affine_kernel), the Pallas TPU kernel that gives each grid step a block
// of bm rows with all N columns in VMEM.
//
// What bounds it on the H100: bytes.  It reads each x element once and
// writes one output for 2 flops, so it runs at the memory rate.
//
// What the design does about it: the DSCS executor calls it with M=1 and
// N=H*W*3 (150,528 columns at 224x224), where the TPU's one-row-block grid
// would be a single block and a whole row would not fit in shared memory.
// So the kernel tiles the flat M*N range instead: a grid-stride loop with
// one element a thread, consecutive threads on consecutive addresses, and
// scale/bias read from the (L2-resident) column vectors.  Multiply and add
// are rounded separately, as the plain PyTorch version's two operations are.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
affine_act_kernel(const Tin* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, Tout* __restrict__ out,
                  long long total, int N, int act) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += stride) {
    const int col = (int)(i % N);
    const float v = __fadd_rn(__fmul_rn(to_f32(x[i]), scale[col]), bias[col]);
    out[i] = from_f32<Tout>(apply_act(act, v));
  }
}

template <typename Tin, typename Tout>
void launch(const void* x, const float* scale, const float* bias, void* out,
            long long M, int N, int act, cudaStream_t stream) {
  const long long total = M * N;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  affine_act_kernel<Tin, Tout><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), scale, bias, static_cast<Tout*>(out), total,
      N, act);
}

}  // namespace

// x (M,N) row-major of in_dtype; scale, bias (N,) fp32; out (M,N) row-major
// of out_dtype.  Launches on `stream` and returns cudaGetLastError().
extern "C" int fused_affine_act(const void* x, const float* scale,
                                const float* bias, void* out, long long M,
                                int N, int in_dtype, int out_dtype, int act,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DTYPE_F32 && out_dtype == DTYPE_F32)
    launch<float, float>(x, scale, bias, out, M, N, act, s);
  else if (in_dtype == DTYPE_F32 && out_dtype == DTYPE_BF16)
    launch<float, __nv_bfloat16>(x, scale, bias, out, M, N, act, s);
  else if (in_dtype == DTYPE_BF16 && out_dtype == DTYPE_F32)
    launch<__nv_bfloat16, float>(x, scale, bias, out, M, N, act, s);
  else if (in_dtype == DTYPE_BF16 && out_dtype == DTYPE_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, out, M, N, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K3 and K4: per-row symmetric int8 quantization and its inverse.
//
//   scale_r = max(absmax_r, 1e-12) / 127,  q = clip(rint(x / scale_r), +-127)
//   x' = float(q) * scale_r, cast to the output type
//
// Replaces: src/repro/kernels/vector_engine.py::quantize_int8 (_quant_kernel)
// and ::dequantize_int8 (_dequant_kernel), Pallas TPU kernels whose grid
// gives each step bm whole rows in VMEM, so the row's absmax is one
// in-register reduction.  The codes must equal the plain version (and the
// TPU kernel) byte for byte.
//
// What bounds them on the H100: bytes.  K3 reads each element (4 or 2
// bytes) and writes one byte; K4 reads one byte and writes 4 or 2; a few
// operations an element.  The training path hands K3 each gradient leaf
// flattened to ONE row, up to 215,482,368 fp32 elements (Mamba-2 370M's
// stacked in_proj), far more than a block can hold or walk alone.
//
// What the design does about it:
// - A row is cut into `segs` segments, one block each, in a flat grid of
//   M * segs blocks (M may exceed the 65,535 of gridDim.y), with 64-bit
//   offsets throughout.  Many rows get few segments, one huge row many.
// - K3 is two passes.  Pass 1: each block's absmax, reduced in the block
//   with warp shuffles and folded into the row's word with atomicMax, all
//   on the bits of |x|, which order exactly as the floats do for values
//   >= 0, so the result is the row's exact max whatever the order.  Pass 2
//   re-reads the row and writes the codes; segment 0 writes the scale.
// - NaN and Inf propagate as in the plain version and in JAX: |NaN|'s bits
//   exceed those of every other value, so a row holding a NaN gets a NaN
//   absmax and scale (fmaxf would drop a NaN), an element whose quotient is
//   NaN gets code 0 (as XLA's and PyTorch's float-to-int casts give it),
//   and K4's 0 * NaN or 0 * Inf then makes the whole row NaN.
// - Bit-exact arithmetic: the scale and x / scale are IEEE divisions
//   (__fdiv_rn, never a multiply by the reciprocal; the build has no fast
//   math), rintf rounds half to even as jnp.round and torch.round do, and
//   the clamp comes before the cast.  K4 is one rounded multiply, cast with
//   round-to-nearest-even.
namespace {

constexpr int QTHREADS = 256;

// Segments a row is cut into: enough blocks in all to fill the card, none
// with fewer than ~16 elements a thread.
__host__ int row_segments(long long M, long long N) {
  const long long per_block = 16LL * QTHREADS;
  long long segs = (N + per_block - 1) / per_block;
  long long cap = 132LL * 32 / (M > 0 ? M : 1);
  if (cap < 1) cap = 1;
  if (segs > cap) segs = cap;
  return static_cast<int>(segs < 1 ? 1 : segs);
}

__device__ __forceinline__ float quant_scale(float absmax) {
  return __fdiv_rn(isnan(absmax) ? absmax : fmaxf(absmax, 1e-12f), 127.0f);
}

template <typename E>
__global__ void __launch_bounds__(QTHREADS)
absmax_kernel(const E* __restrict__ x, unsigned int* __restrict__ amax,
              long long N, int segs) {
  const long long row = blockIdx.x / segs;
  const int seg = static_cast<int>(blockIdx.x - row * segs);
  const E* xr = x + row * N;
  unsigned int m = 0u;                  // the bits of the largest |x|
  const long long stride = static_cast<long long>(segs) * QTHREADS;
  for (long long i = static_cast<long long>(seg) * QTHREADS + threadIdx.x;
       i < N; i += stride)
    m = max(m, __float_as_uint(fabsf(to_f32(xr[i]))));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned int warp_max[QTHREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < QTHREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(amax + row, m);
  }
}

template <typename E>
__global__ void __launch_bounds__(QTHREADS)
quantize_kernel(const E* __restrict__ x, const unsigned int* __restrict__ amax,
                signed char* __restrict__ q, float* __restrict__ scales,
                long long N, int segs) {
  const long long row = blockIdx.x / segs;
  const int seg = static_cast<int>(blockIdx.x - row * segs);
  const float scale = quant_scale(__uint_as_float(amax[row]));
  if (seg == 0 && threadIdx.x == 0) scales[row] = scale;
  const E* xr = x + row * N;
  signed char* qr = q + row * N;
  const long long stride = static_cast<long long>(segs) * QTHREADS;
  for (long long i = static_cast<long long>(seg) * QTHREADS + threadIdx.x;
       i < N; i += stride) {
    const float v = rintf(__fdiv_rn(to_f32(xr[i]), scale));
    qr[i] = isnan(v) ? static_cast<signed char>(0)
                     : static_cast<signed char>(static_cast<int>(
                           fminf(fmaxf(v, -127.0f), 127.0f)));
  }
}

template <typename Tout>
__global__ void __launch_bounds__(QTHREADS)
dequantize_kernel(const signed char* __restrict__ q,
                  const float* __restrict__ scales, Tout* __restrict__ out,
                  long long N, int segs) {
  const long long row = blockIdx.x / segs;
  const int seg = static_cast<int>(blockIdx.x - row * segs);
  const float scale = scales[row];
  const signed char* qr = q + row * N;
  Tout* outr = out + row * N;
  const long long stride = static_cast<long long>(segs) * QTHREADS;
  for (long long i = static_cast<long long>(seg) * QTHREADS + threadIdx.x;
       i < N; i += stride)
    outr[i] = from_f32<Tout>(
        __fmul_rn(static_cast<float>(qr[i]), scale));
}

template <typename E>
int launch_quantize(const void* x, signed char* q, float* scales,
                    unsigned int* amax, long long M, long long N,
                    cudaStream_t stream) {
  const int segs = row_segments(M, N);
  const unsigned blocks = static_cast<unsigned>(M * segs);
  cudaError_t err = cudaMemsetAsync(amax, 0, M * sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<E><<<blocks, QTHREADS, 0, stream>>>(static_cast<const E*>(x),
                                                   amax, N, segs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<E><<<blocks, QTHREADS, 0, stream>>>(
      static_cast<const E*>(x), amax, q, scales, N, segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, N) row-major of `dtype` (common.cuh's code); q (M, N) int8, scales
// (M,) fp32; amax (M,) 32-bit scratch.  M * segments must stay below 2^31
// blocks.  Two launches on `stream`; returns cudaGetLastError().
extern "C" int quantize_int8(const void* x, signed char* q, float* scales,
                             unsigned int* amax, long long M, long long N,
                             int dtype, void* stream) {
  if (M <= 0 || N <= 0 || M * row_segments(M, N) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch_quantize<float>(x, q, scales, amax, M, N, s);
    case DTYPE_BF16:
      return launch_quantize<__nv_bfloat16>(x, q, scales, amax, M, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (M, N) int8 and scales (M,) fp32 -> out (M, N) of `out_dtype`.
extern "C" int dequantize_int8(const signed char* q, const float* scales,
                               void* out, long long M, long long N,
                               int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || M * row_segments(M, N) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int segs = row_segments(M, N);
  const unsigned blocks = static_cast<unsigned>(M * segs);
  switch (out_dtype) {
    case DTYPE_F32:
      dequantize_kernel<float><<<blocks, QTHREADS, 0, s>>>(
          q, scales, static_cast<float*>(out), N, segs);
      break;
    case DTYPE_BF16:
      dequantize_kernel<__nv_bfloat16><<<blocks, QTHREADS, 0, s>>>(
          q, scales, static_cast<__nv_bfloat16*>(out), N, segs);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
