// K1: the DSA systolic array's GEMM, (M,K) @ (K,N) [+ bias] with an fp32
// accumulator and the vector engine's activation fused into the epilogue,
// cast to the output type.
//
// Replaces: src/repro/kernels/systolic_matmul.py::systolic_matmul
// (_matmul_kernel), the Pallas TPU kernel that streams (bm,bk)x(bk,bn)
// tiles through VMEM into the MXU and accumulates over a sequential K grid
// dimension.
//
// What bounds it on the H100: operations.  The ResNet-50 convolutions it
// serves (im2col GEMMs, e.g. M=12544 K=147 N=64 for the stem, M=3136 K=576
// N=64 in stage 1) do 2*M*N*K flops on (M*K + K*N + M*N) words, about 20 to
// 60 flops a byte: above the fp32 ridge of 67 TFLOP/s over 3.35 TB/s.  The
// port holds fp32 results to rtol 1e-4, which TF32 tensor cores (10-bit
// mantissa) would miss, so this kernel runs on the fp32 FMA pipes.
//
// What the design does about it: each block keeps a 64x64 output tile in
// registers (4x4 per thread, 256 threads) and walks K in steps of 16, staging
// the x and w tiles in shared memory as fp32 (bf16 inputs are widened on the
// load), so each loaded element feeds 64 FMAs.  Ragged edges in M, N and K
// are masked on the load (zeros) and on the store, so no padding pass is
// needed (the TPU version asserts divisibility and relies on ops.py to pad).
// The K loop runs inside the block: blocks share nothing, unlike the TPU's
// sequential grid.  Late ResNet stages have few output tiles (M = 49 rows,
// 8 tiles for 132 SMs) and long K (up to 4608), so the wrapper may split K
// over blockIdx.z: each slice writes its fp32 partial tile to a workspace and
// a second kernel sums the slices in a fixed order (deterministic) and applies
// bias, activation and the cast.  A wgmma/3xTF32 path is a later step.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int XS_STRIDE = BM + 4;               // keeps float4 rows aligned

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
              const float* __restrict__ bias, Tout* __restrict__ out,
              float* __restrict__ partial, int M, int N, int K, int k_chunk,
              int act) {
  __shared__ __align__(16) float xs[BK][XS_STRIDE];  // x tile, k-major
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < k_hi) ? to_f32(x[(size_t)gm * K + gk]) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < k_hi && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      if (partial != nullptr) {  // one K slice of a split product
        partial[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
        continue;
      }
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      out[(size_t)gm * N + gn] = from_f32<Tout>(apply_act(act, v));
    }
  }
}

// Sums the K slices of a split product in slice order, then the epilogue.
template <typename Tout>
__global__ void __launch_bounds__(THREADS)
splitk_reduce(const float* __restrict__ partial, const float* __restrict__ bias,
              Tout* __restrict__ out, int M, int N, int slices, int act) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    float v = partial[i];
    for (int z = 1; z < slices; ++z) v += partial[z * total + i];
    if (bias != nullptr) v += bias[i % N];
    out[i] = from_f32<Tout>(apply_act(act, v));
  }
}

template <typename Tin, typename Tout>
void launch(const void* x, const void* w, const float* bias, void* out,
            float* workspace, int M, int N, int K, int splits, int act,
            cudaStream_t stream) {
  // K slices of whole BK steps; fewer than `splits` when K is short.
  const int k_chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const int slices = K > 0 ? (K + k_chunk - 1) / k_chunk : 1;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, slices);
  matmul_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), bias,
      static_cast<Tout*>(out), slices > 1 ? workspace : nullptr, M, N, K,
      k_chunk > 0 ? k_chunk : BK, act);
  if (slices > 1) {
    const size_t total = (size_t)M * N;
    const unsigned blocks =
        (unsigned)std::min<size_t>((total + THREADS - 1) / THREADS, 132 * 16);
    splitk_reduce<Tout><<<blocks, THREADS, 0, stream>>>(
        workspace, bias, static_cast<Tout*>(out), M, N, slices, act);
  }
}

}  // namespace

// x (M,K) and w (K,N) row-major of in_dtype; bias (N,) fp32 or null;
// out (M,N) row-major of out_dtype.  With splits > 1, K is cut into at most
// `splits` slices and workspace must hold splits * M * N floats.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int systolic_matmul(const void* x, const void* w, const float* bias,
                               void* out, float* workspace, int M, int N,
                               int K, int splits, int in_dtype, int out_dtype,
                               int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == DTYPE_F32 && out_dtype == DTYPE_F32)
    launch<float, float>(x, w, bias, out, workspace, M, N, K, splits, act, s);
  else if (in_dtype == DTYPE_F32 && out_dtype == DTYPE_BF16)
    launch<float, __nv_bfloat16>(x, w, bias, out, workspace, M, N, K, splits, act, s);
  else if (in_dtype == DTYPE_BF16 && out_dtype == DTYPE_F32)
    launch<__nv_bfloat16, float>(x, w, bias, out, workspace, M, N, K, splits, act, s);
  else if (in_dtype == DTYPE_BF16 && out_dtype == DTYPE_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, out, workspace, M, N, K, splits, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
