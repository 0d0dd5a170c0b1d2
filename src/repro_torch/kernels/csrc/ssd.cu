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
           E* __restrict__ y, float* __restrict__ hout,
           float* __restrict__ states, int S, int H, int P, int G, int N) {
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

    // the state entering this chunk, for the backward (K8b)
    if (states != nullptr) {
      float* sc = states + (hoff * ((S + T - 1) / T)) +
                  static_cast<long long>(r0 / T) * P * N;
      for (int e = tid; e < PT * N; e += THREADS) {
        const int p = e / N, n = e - p * N;
        if (p0 + p < P) sc[(p0 + p) * N + n] = st[p * ldn + n];
      }
    }

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
           const void* Cm, const float* h0, void* y, float* hout,
           float* states, int B, int S, int H, int P, int G, int N,
           cudaStream_t stream) {
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
      static_cast<const E*>(Cm), h0, static_cast<E*>(y), hout, states, S, H, P,
      G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (B, S, H, P) and Bm, Cm (B, S, G, N) of one element type (`dtype`,
// common.cuh's code), dt (B, S, H), A (H,), h0 (B, H, P, N) or null for
// zeros, hout (B, H, P, N), and states (B, H, ceil(S / 64), P, N) or null:
// the state entering each of the kernel's 64-row chunks, which K8b reads.
// All row-major on the device, dt, A, h0, hout and states fp32.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int ssd_scan(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, const float* h0,
                        void* y, float* hout, float* states, int B, int S,
                        int H, int P, int G, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
      N > MAX_N || H % G != 0 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch<float>(x, dt, A, Bm, Cm, h0, y, hout, states, B, S, H, P,
                           G, N, s);
    case DTYPE_BF16:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, hout, states, B, S,
                                   H, P, G, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8b: the gradient of K8, what torch.autograd.grad of ssd_scan_plain
// computes.  No TPU kernel has a backward: the JAX package differentiates
// the pure-jnp src/repro/models/layers.py:298 ssd_chunked.  This kernel is
// the gradient of src/repro/kernels/ssd.py:87's function on the card.
//
// Per (b, h), with a_t = exp(dt_t A_h), the state S_t = a_t S_{t-1} +
// dt_t x_t B_t^T (P x N), S_{-1} = h0, and y_t = S_t C_t.  With G_t the
// gradient of the loss in S_t (dy and everything after t), the chunk form
// of the reverse walk over one 64-row chunk, cum the running sum of dt * A
// from the chunk's start, cl its last value, L_ij = exp(cum_i - cum_j) for
// j <= i, S_in the state entering the chunk and G_out the gradient leaving
// it (dstate for the last chunk):
//
//   dx_t = dt_t (exp(cl - cum_t) G_out B_t + sum_{i>=t} L_it (C_i.B_t) dy_i)
//   dC_t = exp(cum_t) S_in^T dy_t + sum_{j<=t} L_tj dt_j (dy_t.x_j) B_j
//   dB_t = dt_t (exp(cl - cum_t) G_out^T x_t + sum_{i>=t} L_it (dy_i.x_t) C_i)
//   G_in = exp(cl) G_out + sum_i exp(cum_i) dy_i C_i^T     (dh0 = G_in of
//                                                           chunk 0)
// and the decay's gradient through cum: with R'_ij = L_ij (C_i.B_j)
// (dy_i.x_j), u_i = x_i^T G_out B_i, v_i = dy_i^T S_in C_i, w = <G_out, S_in>,
//
//   dcum_i = sum_j R'_ij dt_j - dt_i sum_k R'_ki + exp(cum_i) v_i
//            - exp(cl - cum_i) dt_i u_i
//            + [i last] (exp(cl) w + sum_j exp(cl - cum_j) dt_j u_j)
//   ddt_t  = sum_i R'_it + exp(cl - cum_t) u_t + A_h sum_{k>=t} dcum_k
//   dA_h  += sum_t dt_t sum_{k>=t} dcum_k
//
// which is the per-step walk (G_t = G + dy_t C_t^T; dC_t = S_t^T dy_t;
// dx_t = dt_t G_t B_t; dB_t = dt_t G_t^T x_t; ddt_t = x_t^T G_t B_t +
// A_h a_t <G_t, S_{t-1}>; G <- a_t G_t) regrouped by chunks.  Every
// exponent is <= 0 (A < 0, dt > 0), so nothing overflows, and S_{t-1} is
// never recovered by dividing by a_t, which underflows.
//
// What bounds it on the H100: at Mamba-2 370M's layer shape (8, 1024, 32,
// 64, G 1, N 128) in bf16 it moves some 0.5 GB (x, dy, dx, B, C, the
// chunk states K8 kept, and the fp32 per-head partials of dB and dC), but
// does ~40 GFLOP of fp32 FMA (eight (64 x 64 x 128)-sized products a chunk
// and head), ~0.6 ms at 67 TFLOP/s: operations bound it, as they bound K8.
//
// What the design does about it (a simple first kernel, no tensor cores):
// - K8's layout: one block per (b, h, 64-wide tile of P), 256 threads,
//   walking the chunks last to first with G (64 x N fp32) in shared memory.
//   A chunk's B, C, x, dy, S_in and three (64 x 64) matrices (L.CB, L.DX,
//   then R', C S_in^T, B G_out^T in turn) take 212 KB of dynamic shared
//   memory at N 128: one block an SM.
// - S_in comes from K8, which writes the state entering each of its 64-row
//   chunks when asked (134 MB a layer at (8, 1024, 32, 64, 128), kept by
//   the autograd graph until the backward): nothing is recomputed.
// - Sums over P tiles and heads.  dB, dC (per head), ddt and dA (per P
//   tile) are written as fp32 partials and summed by the wrapper with
//   .sum(), never with float atomics: a gradient is the same from run to
//   run.  dx and G need no cross-block sum.
// - Each product is a 4 x 4 or 4 x 8 register tile a thread, over rows of
//   odd stride in shared memory (no bank conflicts), as in K8.  The
//   per-row scalars (rows and columns of R', u, v) are one thread a row,
//   and the reverse sum of dcum is one thread's 64-step loop.
namespace {

constexpr int LDP = PT + 1;    // padded row stride of the x and dy tiles

__host__ __device__ constexpr int bwd_smem_floats(int N) {
  return 2 * T * padded(N) + 2 * PT * padded(N) + 2 * T * LDP + 3 * T * LDW +
         9 * T + 32;
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const E* __restrict__ Bm,
               const E* __restrict__ Cm, const float* __restrict__ states,
               const E* __restrict__ dy, const float* __restrict__ dstate,
               E* __restrict__ dx, float* __restrict__ ddt_p,
               float* __restrict__ dA_p, float* __restrict__ dB_p,
               float* __restrict__ dC_p, float* __restrict__ dh0, int Bsz,
               int S, int H, int P, int G, int N) {
  extern __shared__ float smem[];
  const int ldn = padded(N);
  float* Bs = smem;                 // (T, ldn)   B rows of the chunk
  float* Cs = Bs + T * ldn;         // (T, ldn)   C rows
  float* Gs = Cs + T * ldn;         // (PT, ldn)  the carried gradient G
  float* Ss = Gs + PT * ldn;        // (PT, ldn)  S_in, the state entering
  float* xs = Ss + PT * ldn;        // (T, LDP)   x rows
  float* dys = xs + T * LDP;        // (T, LDP)   dy rows
  float* Ms = dys + T * LDP;        // (T, LDW)   L_ij (C_i . B_j), j <= i
  float* Qs = Ms + T * LDW;         // (T, LDW)   L_ij (dy_i . x_j), j <= i
  float* Ts = Qs + T * LDW;         // (T, LDW)   R', then C S^T, then B G^T
  float* cum = Ts + T * LDW;        // (T,)
  float* dts = cum + T;             // (T,)
  float* ecum = dts + T;            // (T,)  exp(cum_i)
  float* rowR = ecum + T;           // (T,)  sum_j R'_ij dt_j
  float* colR = rowR + T;           // (T,)  sum_i R'_ij
  float* vrow = colR + T;           // (T,)  v_i
  float* dcum = vrow + T;           // (T,)  dcum_i without the last row's tail
  float* direct = dcum + T;         // (T,)  ddt_t's terms outside the decay
  float* tailp = direct + T;        // (T,)  exp(cl - cum_j) dt_j u_j
  float* red = tailp + T;           // (32,) partial sums of w

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const int pt = blockIdx.y;
  const int p0 = pt * PT;
  const float a = A[h];
  const int nc = (S + T - 1) / T;

  const long long xrow = static_cast<long long>(H) * P;
  const long long brow = static_cast<long long>(G) * N;
  const long long xoff = static_cast<long long>(b) * S * xrow +
                         static_cast<long long>(h) * P + p0;
  const long long boff = static_cast<long long>(b) * S * brow +
                         static_cast<long long>(g) * N;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;
  const long long hoff = (static_cast<long long>(b) * H + h) * P * N;
  // per-tile partials: ddt (nPT, B, S, H), dB and dC (nPT, B, S, H, N)
  const long long poff = static_cast<long long>(pt) * Bsz + b;
  float* ddtb = ddt_p + poff * S * H + h;
  const long long nrow = static_cast<long long>(H) * N;
  float* dBb = dB_p + poff * S * nrow + static_cast<long long>(h) * N;
  float* dCb = dC_p + poff * S * nrow + static_cast<long long>(h) * N;

  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    Gs[p * ldn + n] = (dstate != nullptr && p0 + p < P)
                          ? dstate[hoff + static_cast<long long>(p0 + p) * N + n]
                          : 0.0f;
  }
  float dA_acc = 0.0f;

  for (int c = nc - 1; c >= 0; --c) {
    const int r0 = c * T;
    const int len = min(T, S - r0);
    const float* s_in = states + hoff * nc + static_cast<long long>(c) * P * N;

    // ---- stage the chunk: B, C, x, dy, S_in as fp32, zero past its end ---
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
      const bool in = i < len && p0 + p < P;
      const long long o = xoff + (r0 + i) * xrow + p;
      xs[i * LDP + p] = in ? to_f32(x[o]) : 0.0f;
      dys[i * LDP + p] = in ? to_f32(dy[o]) : 0.0f;
    }
    for (int e = tid; e < PT * N; e += THREADS) {
      const int p = e / N, n = e - p * N;
      Ss[p * ldn + n] = p0 + p < P ? s_in[(p0 + p) * N + n] : 0.0f;
    }
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
    const float cl = cum[T - 1];

    // ---- L.CB, L.DX and R' = L.CB.DX, lower triangle, zero above -------
    {
      const int ti = tid & 15, tj = tid >> 4;   // rows ti+16u, cols tj+16v
      float cb[4][4] = {}, dd[4][4] = {};
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
          for (int v = 0; v <= u; ++v) cb[u][v] = fmaf(cv[u], bv[v], cb[u][v]);
      }
      for (int p = 0; p < PT; ++p) {
        float yv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          yv[u] = dys[(ti + 16 * u) * LDP + p];
          xv[u] = xs[(tj + 16 * u) * LDP + p];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v <= u; ++v) dd[u][v] = fmaf(yv[u], xv[v], dd[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ti + 16 * u, j = tj + 16 * v;
          float m = 0.0f, q = 0.0f, r = 0.0f;
          if (j <= i) {
            const float L = expf(cum[i] - cum[j]);
            m = L * cb[u][v];
            q = L * dd[u][v];
            r = m * dd[u][v];
          }
          Ms[i * LDW + j] = m;
          Qs[i * LDW + j] = q;
          Ts[i * LDW + j] = r;
        }
    }
    __syncthreads();

    // ---- rows and columns of R'; w = <G_out, S_in> ----------------------
    if (tid < T) {
      float s = 0.0f;
      for (int j = 0; j <= tid; ++j) s = fmaf(Ts[tid * LDW + j], dts[j], s);
      rowR[tid] = s;
      ecum[tid] = expf(cum[tid]);
    } else if (tid < 2 * T) {
      const int j = tid - T;
      float s = 0.0f;
      for (int i = j; i < T; ++i) s += Ts[i * LDW + j];
      colR[j] = s;
    }
    {
      float s = 0.0f;
      for (int e = tid; e < PT * N; e += THREADS) {
        const int p = e / N, n = e - p * N;
        s = fmaf(Gs[p * ldn + n], Ss[p * ldn + n], s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if ((tid & 31) == 0) red[tid >> 5] = s;
    }
    __syncthreads();

    // ---- Ts = C S_in^T (rows i, cols p), then v_i = dy_i . (S_in C_i) ----
    {
      const int ti = tid & 15, tp = tid >> 4;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = Cs[(ti + 16 * u) * ldn + n];
          sv[u] = Ss[(tp + 16 * u) * ldn + n];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(cv[u], sv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          Ts[(ti + 16 * u) * LDW + tp + 16 * v] = acc[u][v];
    }
    __syncthreads();
    if (tid < T) {
      float s = 0.0f;
      for (int p = 0; p < PT; ++p)
        s = fmaf(dys[tid * LDP + p], Ts[tid * LDW + p], s);
      vrow[tid] = s;
    }
    __syncthreads();

    // ---- Ts = B G_out^T (rows i, cols p); u_i = x_i . (G_out B_i) -------
    {
      const int ti = tid & 15, tp = tid >> 4;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float bv[4], gv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bv[u] = Bs[(ti + 16 * u) * ldn + n];
          gv[u] = Gs[(tp + 16 * u) * ldn + n];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(bv[u], gv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          Ts[(ti + 16 * u) * LDW + tp + 16 * v] = acc[u][v];
    }
    __syncthreads();
    if (tid < T) {
      float s = 0.0f;
      for (int p = 0; p < PT; ++p)
        s = fmaf(xs[tid * LDP + p], Ts[tid * LDW + p], s);
      const float e = expf(cl - cum[tid]);
      const float d = dts[tid];
      dcum[tid] = rowR[tid] - d * colR[tid] + ecum[tid] * vrow[tid] -
                  e * d * s;
      direct[tid] = colR[tid] + e * s;
      tailp[tid] = e * d * s;
    }
    __syncthreads();

    // ---- ddt and dA: the reverse sum of dcum, one thread -----------------
    if (tid == 0) {
      float w = 0.0f;
      for (int k = 0; k < THREADS / 32; ++k) w += red[k];
      float tail = expf(cl) * w;
      for (int j = 0; j < T; ++j) tail += tailp[j];
      float acc = tail;
      for (int i = T - 1; i >= 0; --i) {
        acc += dcum[i];
        direct[i] = fmaf(a, acc, direct[i]);
        dA_acc = fmaf(dts[i], acc, dA_acc);
      }
    }
    __syncthreads();
    if (tid < len) ddtb[static_cast<long long>(r0 + tid) * H] = direct[tid];

    // ---- dx_t = dt_t (exp(cl - cum_t) (B G^T)_t + sum_i L_it CB_it dy_i) --
    {
      const int tr = tid & 15, tc = tid >> 4;   // rows tr+16u, cols tc+16v
      float acc[4][4] = {};
      for (int i = tr; i < len; ++i) {
        float mv[4], yv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          mv[u] = Ms[i * LDW + tr + 16 * u];
          yv[u] = dys[i * LDP + tc + 16 * u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(mv[u], yv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = tr + 16 * u;
        if (t >= len) continue;
        const float e = expf(cl - cum[t]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tc + 16 * v;
          if (p0 + p < P)
            dx[xoff + (r0 + t) * xrow + p] = from_f32<E>(
                dts[t] * fmaf(e, Ts[t * LDW + p], acc[u][v]));
        }
      }
    }

    // ---- dC_t = exp(cum_t) S_in^T dy_t + sum_{j<=t} L.DX_tj dt_j B_j -----
    // ---- dB_t = dt_t (exp(cl-cum_t) G^T x_t + sum_{i>=t} L.DX_it C_i) ----
    {
      const int tn = tid & 15, tr = tid >> 4;   // cols tn+16d, rows tr+16u
      float acc[4][MAX_N / 16];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) acc[u][d] = 0.0f;
      for (int p = 0; p < PT; ++p) {
        float yv[4], sv[MAX_N / 16];
#pragma unroll
        for (int u = 0; u < 4; ++u) yv[u] = dys[(tr + 16 * u) * LDP + p];
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          sv[d] = n < N ? Ss[p * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int d = 0; d < MAX_N / 16; ++d)
            acc[u][d] = fmaf(yv[u], sv[d], acc[u][d]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) acc[u][d] *= ecum[tr + 16 * u];
      const int jend = min(len, tr + 16 * 3 + 1);   // L.DX is 0 past the row
      for (int j = 0; j < jend; ++j) {
        float qv[4], bv[MAX_N / 16];
        const float d_j = dts[j];
#pragma unroll
        for (int u = 0; u < 4; ++u) qv[u] = Qs[(tr + 16 * u) * LDW + j] * d_j;
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          bv[d] = n < N ? Bs[j * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int d = 0; d < MAX_N / 16; ++d)
            acc[u][d] = fmaf(qv[u], bv[d], acc[u][d]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = tr + 16 * u;
        if (t >= len) continue;
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          if (n < N) dCb[(r0 + t) * nrow + n] = acc[u][d];
        }
      }

#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) acc[u][d] = 0.0f;
      for (int p = 0; p < PT; ++p) {
        float xv[4], gv[MAX_N / 16];
#pragma unroll
        for (int u = 0; u < 4; ++u) xv[u] = xs[(tr + 16 * u) * LDP + p];
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          gv[d] = n < N ? Gs[p * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int d = 0; d < MAX_N / 16; ++d)
            acc[u][d] = fmaf(xv[u], gv[d], acc[u][d]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float e = expf(cl - cum[tr + 16 * u]);
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) acc[u][d] *= e;
      }
      for (int i = tr; i < len; ++i) {
        float qv[4], cv[MAX_N / 16];
#pragma unroll
        for (int u = 0; u < 4; ++u) qv[u] = Qs[i * LDW + tr + 16 * u];
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          cv[d] = n < N ? Cs[i * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int d = 0; d < MAX_N / 16; ++d)
            acc[u][d] = fmaf(qv[u], cv[d], acc[u][d]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = tr + 16 * u;
        if (t >= len) continue;
        const float d_t = dts[t];
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          if (n < N) dBb[(r0 + t) * nrow + n] = d_t * acc[u][d];
        }
      }
    }
    __syncthreads();

    // ---- G <- exp(cl) G + sum_i exp(cum_i) dy_i C_i^T --------------------
    {
      const int tn = tid & 15, tp = tid >> 4;   // cols tn+16d, rows tp+16u
      const float decay = expf(cl);
      float acc[4][MAX_N / 16];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          acc[u][d] = n < N ? decay * Gs[(tp + 16 * u) * ldn + n] : 0.0f;
        }
      for (int i = 0; i < len; ++i) {
        float yv[4], cv[MAX_N / 16];
        const float ei = ecum[i];
#pragma unroll
        for (int u = 0; u < 4; ++u) yv[u] = ei * dys[i * LDP + tp + 16 * u];
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          cv[d] = n < N ? Cs[i * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int d = 0; d < MAX_N / 16; ++d)
            acc[u][d] = fmaf(yv[u], cv[d], acc[u][d]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int d = 0; d < MAX_N / 16; ++d) {
          const int n = tn + 16 * d;
          if (n < N) Gs[(tp + 16 * u) * ldn + n] = acc[u][d];
        }
    }
    __syncthreads();
  }

  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    if (p0 + p < P)
      dh0[hoff + static_cast<long long>(p0 + p) * N + n] = Gs[p * ldn + n];
  }
  if (tid == 0) dA_p[poff * H + h] = dA_acc;
}

template <typename E>
int launch_bwd(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, const float* states, const void* dy,
               const float* dstate, void* dx, float* ddt_p, float* dA_p,
               float* dB_p, float* dC_p, float* dh0, int B, int S, int H,
               int P, int G, int N, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem_floats(MAX_N) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bytes = bwd_smem_floats(N) * static_cast<int>(sizeof(float));
  const dim3 grid(static_cast<unsigned>(B) * H, (P + PT - 1) / PT);
  ssd_bwd_kernel<E><<<grid, THREADS, bytes, stream>>>(
      static_cast<const E*>(x), dt, A, static_cast<const E*>(Bm),
      static_cast<const E*>(Cm), states, static_cast<const E*>(dy), dstate,
      static_cast<E*>(dx), ddt_p, dA_p, dB_p, dC_p, dh0, B, S, H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8b.  x, dy, dx (B, S, H, P) and Bm, Cm (B, S, G, N) of one element type
// (`dtype`); dt (B, S, H), A (H,); states (B, H, ceil(S / 64), P, N), as K8
// writes them; dstate (B, H, P, N) or null for zeros; dh0 (B, H, P, N).
// Partials, one slice per 64-wide tile of P (nPT = ceil(P / 64)): ddt_p
// (nPT, B, S, H), dA_p (nPT, B, H), dB_p and dC_p (nPT, B, S, H, N), per
// head.  All row-major on the device, everything but x, dy, dx, Bm and Cm
// fp32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm,
                            const float* states, const void* dy,
                            const float* dstate, void* dx, float* ddt_p,
                            float* dA_p, float* dB_p, float* dC_p, float* dh0,
                            int B, int S, int H, int P, int G, int N,
                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
      N > MAX_N || H % G != 0 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch_bwd<float>(x, dt, A, Bm, Cm, states, dy, dstate, dx,
                               ddt_p, dA_p, dB_p, dC_p, dh0, B, S, H, P, G, N,
                               s);
    case DTYPE_BF16:
      return launch_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, states, dy, dstate,
                                       dx, ddt_p, dA_p, dB_p, dC_p, dh0, B, S,
                                       H, P, G, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
