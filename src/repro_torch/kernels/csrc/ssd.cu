// K8: the Mamba-2 SSD (state-space duality) chunk scan.  For one batch row
// b and head h, with the state S_t a (P, N) matrix, the recurrence
//
//   S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t,   y_t = S_t C_t
//
// (B_t, C_t of the head's group g = h / (H / G)), computed chunk by chunk:
// within a chunk of rows i, j, with cum the running sum of dt * A,
//
//   y_i = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//       + exp(cum_i) C_i . S_in
//   S_out = exp(cum_last) S_in + sum_j exp(cum_last - cum_j) dt_j x_j (outer) B_j
//
// Replaces: src/repro/kernels/ssd.py:87 (ssd_scan, _ssd_kernel), the Pallas
// TPU kernel whose grid is (B*H, chunks), the chunk axis sequential, with
// the (P, N) fp32 state carried across it in VMEM scratch and the two
// products of a chunk on the MXU.
//
// What bounds it on the H100: at Mamba-2 370M's layer shape (B 4, S 1024,
// H 32, P 64, G 1, N 128) the bytes are some 40 MB in bf16 (x and y, B and
// C, dt, the fp32 state written once), 0.012 ms at 3.35 TB/s, while the
// arithmetic is ~4.9 GFLOP at this kernel's 64-row chunks, most of it the
// two (P, N) state products of every row (C . S and x (outer) B).  On the
// tensor cores the bytes would bound it; this kernel does it all in fp32
// FMA (67 TFLOP/s, 0.073 ms), so it is bound by operations.
//
// What the design does about it (a simple first kernel, no tensor cores):
// - One block per (b, h, 64-wide tile of P), 256 threads, looping over the
//   sequence itself in place of the TPU's sequential grid axis.  The state
//   tile (64 x N fp32, 32 KB at N 128) lives in shared memory for the whole
//   walk, and h0 (or zeros) seeds it.
// - Shared memory.  A chunk's x, B and C at the model's Q = 256 would be
//   320 KB in fp32, over the 227 KB a block may have.  The kernel therefore
//   walks its own 64-row chunks, whatever the caller's chunk: chunking does
//   not change the function (the state carries everything across a chunk
//   boundary), only the order of fp32 roundings, and a 64-row chunk does
//   fewer operations per row than a 256-row one.  The caller's chunk is
//   still checked (S % Q == 0) by the wrapper, as the JAX code asserts.  B, C
//   and x of one chunk are staged as fp32 (130 KB of dynamic shared memory
//   at N = 128, with the state and the (64, 64) weight matrix), so a bf16
//   input is converted once, on load.
// - The upper triangle.  exp(cum_i - cum_j) for i < j is exp of a positive
//   number and could overflow to inf, and inf * 0 is NaN: the decay is
//   computed only for j <= i; other weights are written as 0.
// - Ragged ends.  A last chunk shorter than 64 rows (S = 255 when decoding
//   is checked against a 256-token forward) loads zeros past its end: zero
//   dt keeps cum flat and zero B, C and x add nothing.  P tiles past P are
//   masked the same way.
// - Bank conflicts.  Rows of B, C and the state are padded to an odd
//   stride, so the 16 threads of a half-warp that read one column of 16
//   different rows hit 16 different banks; each thread holds a 4 x 4 (or
//   4 x 8) register tile, so every value read from shared memory feeds four
//   or more FMAs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;          // rows of one chunk, as the kernel walks them
constexpr int PT = 64;         // columns of P a block holds
constexpr int MAX_N = 128;     // state width the register tiles cover
constexpr int LDW = T + 1;     // padded row stride of the weight matrix

__host__ __device__ constexpr int padded(int n) { return n | 1; }

__host__ __device__ constexpr int smem_floats(int N) {
  return 2 * T * padded(N) + T * PT + T * LDW + PT * padded(N) + 2 * T;
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const E* __restrict__ Bm,
           const E* __restrict__ Cm, const float* __restrict__ h0,
           E* __restrict__ y, float* __restrict__ hout, int S, int H, int P,
           int G, int N) {
  extern __shared__ float smem[];
  const int ldn = padded(N);
  float* Bs = smem;                 // (T, ldn)   B rows of the chunk
  float* Cs = Bs + T * ldn;         // (T, ldn)   C rows
  float* xs = Cs + T * ldn;         // (T, PT)    x rows, later x * w
  float* Ws = xs + T * PT;          // (T, LDW)   the chunk's weights on x_j
  float* st = Ws + T * LDW;         // (PT, ldn)  the carried state
  float* cum = st + PT * ldn;       // (T,)       running sum of dt * A
  float* dts = cum + T;             // (T,)       dt

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const int p0 = blockIdx.y * PT;
  const float a = A[h];

  const long long xrow = static_cast<long long>(H) * P;   // x, y row stride
  const long long brow = static_cast<long long>(G) * N;   // B, C row stride
  const long long xoff = static_cast<long long>(b) * S * xrow +
                         static_cast<long long>(h) * P + p0;
  const long long boff = static_cast<long long>(b) * S * brow +
                         static_cast<long long>(g) * N;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;
  const long long hoff = (static_cast<long long>(b) * H + h) * P * N;

  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    st[p * ldn + n] = (h0 != nullptr && p0 + p < P)
                          ? h0[hoff + static_cast<long long>(p0 + p) * N + n]
                          : 0.0f;
  }

  for (int r0 = 0; r0 < S; r0 += T) {
    const int len = min(T, S - r0);

    // ---- stage the chunk: B, C, x as fp32, zero past its end ------------
    for (int e = tid; e < T * N; e += THREADS) {
      const int i = e / N, n = e - i * N;
      float bv = 0.0f, cv = 0.0f;
      if (i < len) {
        const long long o = boff + (r0 + i) * brow + n;
        bv = to_f32(Bm[o]);
        cv = to_f32(Cm[o]);
      }
      Bs[i * ldn + n] = bv;
      Cs[i * ldn + n] = cv;
    }
    for (int e = tid; e < T * PT; e += THREADS) {
      const int i = e / PT, p = e - i * PT;
      xs[e] = (i < len && p0 + p < P) ? to_f32(x[xoff + (r0 + i) * xrow + p])
                                      : 0.0f;
    }
    // cum: an inclusive scan of dt * A, one warp per 32 rows
    if (tid < T) {
      const float d = tid < len ? dtb[static_cast<long long>(r0 + tid) * H]
                                : 0.0f;
      dts[tid] = d;
      float v = d * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if ((tid & 31) >= off) v += u;
      }
      cum[tid] = v;
    }
    __syncthreads();
    if (tid >= 32 && tid < T) cum[tid] += cum[31];
    __syncthreads();

    // ---- W[i][j] = exp(cum_i - cum_j) (C_i . B_j) dt_j for j <= i --------
    {
      const int ti = tid & 15, tj = tid >> 4;   // rows ti+16a, cols tj+16b
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = Cs[(ti + 16 * u) * ldn + n];
          bv[u] = Bs[(tj + 16 * u) * ldn + n];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v <= u; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ti + 16 * u, j = tj + 16 * v;
          Ws[i * LDW + j] =
              j <= i ? expf(cum[i] - cum[j]) * acc[u][v] * dts[j] : 0.0f;
        }
    }
    __syncthreads();

    // ---- y_i = W[i] @ x + exp(cum_i) C_i . state -------------------------
    {
      const int tp = tid & 15, ti = tid >> 4;   // rows ti+16a, cols tp+16c
      float intra[4][4] = {}, inter[4][4] = {};
      const int jend = min(len, ti + 16 * 3 + 1);   // W is 0 past the row
      for (int j = 0; j < jend; ++j) {
        float wv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          wv[u] = Ws[(ti + 16 * u) * LDW + j];
          xv[u] = xs[j * PT + tp + 16 * u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) intra[u][v] = fmaf(wv[u], xv[v], intra[u][v]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = Cs[(ti + 16 * u) * ldn + n];
          sv[u] = st[(tp + 16 * u) * ldn + n];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) inter[u][v] = fmaf(cv[u], sv[v], inter[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ti + 16 * u;
        if (i >= len) continue;
        const float decay = expf(cum[i]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tp + 16 * v;
          if (p0 + p < P)
            y[xoff + (r0 + i) * xrow + p] =
                from_f32<E>(fmaf(decay, inter[u][v], intra[u][v]));
        }
      }
    }
    __syncthreads();

    // ---- state = exp(seg) state + (x * w)^T B, w_j = dt_j exp(seg - cum_j)
    const float seg = cum[T - 1];
    for (int e = tid; e < T * PT; e += THREADS) {
      const int j = e / PT;
      xs[e] *= dts[j] * expf(seg - cum[j]);
    }
    __syncthreads();
    {
      const int tn = tid & 15, tp = tid >> 4;   // cols tn+16d, rows tp+16c
      const float decay = expf(seg);
      float acc[4][MAX_N / 16];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          acc[c][d] = n < N ? decay * st[(tp + 16 * c) * ldn + n] : 0.0f;
        }
      for (int j = 0; j < len; ++j) {
        float xv[4], bv[MAX_N / 16];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xs[j * PT + tp + 16 * c];
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          bv[d] = n < N ? Bs[j * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int d = 0; d < MAX_N / 16; ++d) acc[c][d] = fmaf(xv[c], bv[d], acc[c][d]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          if (n < N) st[(tp + 16 * c) * ldn + n] = acc[c][d];
        }
    }
    __syncthreads();
  }

  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    if (p0 + p < P)
      hout[hoff + static_cast<long long>(p0 + p) * N + n] = st[p * ldn + n];
  }
}

template <typename E>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, void* y, float* hout, int B,
           int S, int H, int P, int G, int N, cudaStream_t stream) {
  // Raise the block's dynamic shared memory limit once, to the most any N
  // needs, so that a launch captured in a CUDA graph makes no such call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(MAX_N) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bytes = smem_floats(N) * static_cast<int>(sizeof(float));
  const dim3 grid(static_cast<unsigned>(B) * H, (P + PT - 1) / PT);
  ssd_kernel<E><<<grid, THREADS, bytes, stream>>>(
      static_cast<const E*>(x), dt, A, static_cast<const E*>(Bm),
      static_cast<const E*>(Cm), h0, static_cast<E*>(y), hout, S, H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (B, S, H, P) and Bm, Cm (B, S, G, N) of one element type (`dtype`,
// common.cuh's code), dt (B, S, H), A (H,), h0 (B, H, P, N) or null for
// zeros, hout (B, H, P, N): all row-major on the device, dt, A, h0 and
// hout fp32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, const float* h0,
                        void* y, float* hout, int B, int S, int H, int P,
                        int G, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
      N > MAX_N || H % G != 0 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch<float>(x, dt, A, Bm, Cm, h0, y, hout, B, S, H, P, G, N, s);
    case DTYPE_BF16:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hout, B, S, H, P,
                                   G, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
