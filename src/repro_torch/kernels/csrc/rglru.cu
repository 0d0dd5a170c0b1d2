// K7: the RG-LRU (Real-Gated Linear Recurrent Unit) of RecurrentGemma.  For
// every batch row b and channel w, with c = -8,
//
//   log_a_t = c * sigmoid(ga_t) * softplus(log_a)
//   a_t     = exp(log_a_t)
//   b_t     = sqrt(max(1 - exp(2 * log_a_t), 1e-12)) * sigmoid(gx_t) * x_t
//   h_t     = a_t * h_{t-1} + b_t,           h_{-1} = h0,   y_t = h_t
//
// x, gx, ga, y (B, S, W); log_a (W,); h0 (B, W).  The state is fp32 and only
// y is cast to x's type, as in the TPU kernel.
//
// Replaces: src/repro/kernels/rglru.py:54 (rglru_scan, _rglru_kernel), the
// Pallas TPU kernel whose grid is (B/bb, W/bw, S/bs) with the time axis
// sequential, the (bb, bw) fp32 state carried across it in VMEM scratch, and
// within a time block a vectorised pass for a and b followed by an in-kernel
// fori_loop over the block's steps.
//
// What bounds it on the H100: the bytes are x, gx, ga read once and y
// written once, 8 B an element in bf16 (84 MB at RecurrentGemma-2B's layer
// shape B 4, S 1024, W 2560: 0.025 ms at 3.35 TB/s); the arithmetic is some
// 30 operations an element, far below the card's rate.  What holds it back
// is the chain: every channel's recurrence is serial in time, and the
// serving shape has only B * W = 10,240 chains, 320 warps on 132 SMs, too
// few to hide the memory's latency.
//
// What the design does about it (a simple first kernel; a chunked two-pass
// scan over time that fills the card is later work):
// - One thread per chain (b, w), one warp per block over 32 neighbouring
//   channels, so every load and store of a time step is coalesced along W
//   and the grid (ceil(W / 32), B) spreads the 320 warps of the serving
//   shape over all the SMs.  The TPU's sequential grid axis becomes a loop
//   over time inside the thread; the state stays in a register.
// - The loop walks time tiles of TS = 32 steps in two phases, as the TPU
//   kernel does a block: first the tile's 3 * 32 loads are issued together,
//   into registers, before any is used (a first version that loaded each
//   step under its own `if (i < n)` kept one load in flight a thread and
//   took 1.36 ms at the layer shape in bf16, against 0.26 ms for this
//   one), and every a_t and b_t computed (independent work); then the
//   32 dependent steps h = a * h + b (one FMA each) are taken and their y
//   stored.  softplus(log_a) is computed once per thread.
// - No tile has to divide S, W or B: a last, short time tile and the
//   channels past W are masked, so S = 31 or 255 (decode == forward) and
//   W = 200 take the same path.
#include "common.cuh"

namespace {

constexpr int WT = 32;   // channels (threads) per block
constexpr int TS = 32;   // time steps per tile

// jax.nn.softplus: log(1 + exp(v)), computed without overflow.
__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

template <typename E>
__global__ void __launch_bounds__(WT)
rglru_kernel(const E* __restrict__ x, const E* __restrict__ gx,
             const E* __restrict__ ga, const float* __restrict__ log_a,
             const float* __restrict__ h0, E* __restrict__ y, int S, int W) {
  const int w = blockIdx.x * WT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float c = -8.0f;
  const float sp = c * softplus_f32(log_a[w]);
  float h = h0[static_cast<long long>(b) * W + w];
  const long long base = static_cast<long long>(b) * S * W + w;

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int n = min(TS, S - t0);
    const E* xp = x + base + static_cast<long long>(t0) * W;
    const E* gxp = gx + base + static_cast<long long>(t0) * W;
    const E* gap = ga + base + static_cast<long long>(t0) * W;
    // phase 1: the tile's 3 * TS loads, all issued before any is used (a
    // short last tile loads zeros past S), then every a_t and b_t
    float xr[TS], gxr[TS], gar[TS];
    if (n == TS) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const long long off = static_cast<long long>(i) * W;
        xr[i] = to_f32(xp[off]);
        gxr[i] = to_f32(gxp[off]);
        gar[i] = to_f32(gap[off]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const long long off = static_cast<long long>(i) * W;
        xr[i] = i < n ? to_f32(xp[off]) : 0.0f;
        gxr[i] = i < n ? to_f32(gxp[off]) : 0.0f;
        gar[i] = i < n ? to_f32(gap[off]) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const float log_at = sp * sigmoid_f32(gar[i]);
      const float mult = sqrtf(fmaxf(1.0f - expf(2.0f * log_at), 1e-12f));
      gar[i] = expf(log_at);                          // a_t
      xr[i] = mult * sigmoid_f32(gxr[i]) * xr[i];     // b_t
    }
    // phase 2: the serial chain, one FMA a step
    E* yp = y + base + static_cast<long long>(t0) * W;
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      if (i < n) {
        h = fmaf(gar[i], h, xr[i]);
        yp[static_cast<long long>(i) * W] = from_f32<E>(h);
      }
    }
  }
}

template <typename E>
int launch(const void* x, const void* gx, const void* ga, const float* log_a,
           const float* h0, void* y, int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + WT - 1) / WT, B);
  rglru_kernel<E><<<grid, WT, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(gx),
      static_cast<const E*>(ga), log_a, h0, static_cast<E*>(y), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, gx, ga, y (B, S, W) of one element type (`dtype`, common.cuh's code),
// log_a (W,) and h0 (B, W) fp32, all row-major on the device.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int rglru_scan(const void* x, const void* gx, const void* ga,
                          const float* log_a, const float* h0, void* y, int B,
                          int S, int W, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch<float>(x, gx, ga, log_a, h0, y, B, S, W, s);
    case DTYPE_BF16:
      return launch<__nv_bfloat16>(x, gx, ga, log_a, h0, y, B, S, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
