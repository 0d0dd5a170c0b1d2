// K2: the DSA vector engine's fused affine pass, y = act(x * scale + bias)
// with per-column (N,) scale and bias, computed in fp32 and cast.
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
