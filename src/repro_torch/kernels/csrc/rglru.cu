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
// shape B 4, S 1024, W 2560: 0.025 ms at 3.35 TB/s).  The arithmetic comes
// close: an element takes seven SFU operations (four exp2, two
// reciprocals and an rsqrt), 16 a clock on an SM: 0.018 ms at that shape
// at 1.98 GHz.  The recurrence is serial in time, and the layer shape has
// only B * W = 10,240 chains: one thread a chain (this kernel's first
// version, 0.26 ms) gives 320 warps, too few to hide the memory's latency.
//
// What the design does about it: a chunked scan over time, in one launch.
// - A block takes CH = 32 channels of one batch row (a lane each, so a
//   warp's loads and stores of a step are one contiguous row) and SUB x
//   STEPS steps (warp j takes sub-chunk j).  A thread-block cluster of
//   R <= 8 blocks along grid x spans R x SUB x STEPS steps of the time
//   axis, a window; a longer S is walked window by window, the state
//   carried from one to the next.
// - As many clusters as the card holds at once (the occupancy API's
//   count, at most one an item) each walk their items (batch row,
//   32-channel tile), one unit (item, window) after another.  A unit's x,
//   gx and ga tiles are copied into shared memory by cp.async while the
//   unit before it computes (two buffers), so the loads' latency hides
//   behind the arithmetic and the barriers.
// - Pass 1: each thread computes its steps' a_t and b_t into registers and
//   its sub-chunk's composite (prod a, h from 0).  The composites of the
//   block's sub-chunks are folded in shared memory (each thread folds
//   those before its own: its prefix), and the block's own composite is
//   published to the cluster.  After one cluster barrier, warp 0 reads
//   the R published composites through distributed shared memory and
//   folds the window's carry-in (h0 in an item's first window) through
//   those before its block: the block's carry-in; through all R: the next
//   window's.
// - Pass 2: each thread starts from prefix(carry-in) and walks its steps
//   again out of registers, storing y.  Each input byte is read once and y
//   written once.
// - Small blocks (4 warps) and few registers, so that 8 blocks share an
//   SM and one's barriers overlap another's arithmetic; the sizes were
//   chosen by tools/k7_ablate.py.
// - Ragged edges: channels past W and steps past S take a = 1, b = 0 and
//   store nothing, so no tile has to divide S or W (S = 1, 31, 77, 255 and
//   W = 200 take the same kernel).  Where W is not a multiple of a 16-byte
//   chunk, or a base is not aligned to one, the tiles are staged one
//   element at a time.
// - Numerics: the TPU kernel's formula, exp(2 log_a_t) inside the square
//   root (not a_t^2: 1 - a^2 cancels near a = 1), both exponentials as
//   accurate expf; the gates' sigmoids with __expf and __fdividef and the
//   square root as an rsqrt and a Newton step, a few ulp apart from the
//   IEEE forms, whose slow paths' calls spilled registers (the IEEE forms
//   took 0.076 ms against 0.060 on an H100, tools/k7_ablate.py).  The fold
//   re-associates fp32 products, as the plain version's doubling scan
//   does.
#include "common.cuh"

namespace {

constexpr int CH = 32;                  // channels a block, a lane each
constexpr int SUB = 4;                  // sub-chunks a block, a warp each
constexpr int STEPS = 8;                // steps a sub-chunk
constexpr int THREADS = CH * SUB;
constexpr int MIN_BLOCKS = 8;           // resident blocks an SM, at least
constexpr int SPAN = SUB * STEPS;       // steps a block takes a window
constexpr int MAX_CLUSTER = 8;          // the portable cluster size

// A block's dynamic shared memory: the (A, H) composites of each sub-chunk
// of a channel, the block's own composite of a unit (two buffers, by unit
// parity) and the carries warp 0 forms (the block's, the next window's);
// then two buffers of a unit's x, gx and ga tiles, SPAN steps x CH
// channels each.
constexpr int COMP_BYTES = (SUB + 3) * CH * 8;
template <typename E>
constexpr int smem_bytes() {
  return COMP_BYTES + 2 * 3 * SPAN * CH * static_cast<int>(sizeof(E));
}

// jax.nn.softplus: log(1 + exp(v)), computed without overflow.
__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// The gates' sigmoid on the SFU (exp2 and an approximate reciprocal): a few
// ulp from 1 / (1 + exp(-v)) and no call into the IEEE division's slow
// path, whose saved registers spilled (tools/k7_ablate.py).
__device__ __forceinline__ float sigmoid_sfu(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// sqrt(v) for v >= 1e-12: the SFU's rsqrt and one Newton step (within an
// ulp), with no slow path.
__device__ __forceinline__ float sqrt_sfu(float v) {
  const float r = rsqrtf(v);
  const float s = v * r;
  return fmaf(fmaf(-s, s, v), 0.5f * r, s);
}

// (A, H) then (a, b): the composite of two runs of steps.
__device__ __forceinline__ void fold(float& A, float& H, float a, float b) {
  H = fmaf(a, H, b);
  A *= a;
}

struct Args {
  const void* x;
  const void* gx;
  const void* ga;
  const float* log_a;
  const float* h0;
  void* y;
  float* h32;         // the fp32 states, (B, S, W), where not null
  int S, W, tiles, items, windows;
  bool vec;           // 16-byte rows: copied asynchronously
};

// One unit's tiles: steps [tb, tb + SPAN) of channels [c0, c0 + CH) of x,
// gx and ga (batch row b) into `tile`, zeros past S and W; asynchronous
// 16-byte copies where a.vec, else one element at a time.
template <typename E>
__device__ __forceinline__ void stage(E* tile, const Args& a, long long b,
                                      int tb, int c0) {
  const E* const src[3] = {static_cast<const E*>(a.x),
                           static_cast<const E*>(a.gx),
                           static_cast<const E*>(a.ga)};
  constexpr int PER = 16 / sizeof(E);   // elements a chunk
  constexpr int ROW = CH / PER;         // chunks a step
  if (a.vec) {
    for (int c = threadIdx.x; c < 3 * SPAN * ROW; c += THREADS) {
      const int arr = c / (SPAN * ROW), r = c / ROW % SPAN, k = c % ROW;
      const int t = tb + r, w = c0 + k * PER;
      const bool ok = t < a.S && w < a.W;
      const E* g = ok ? src[arr] + (b * a.S + t) * a.W + w : src[arr];
      cp_async16(smem_u32(tile + (arr * SPAN + r) * CH + k * PER), g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 3 * SPAN * CH; e += THREADS) {
      const int arr = e / (SPAN * CH), r = e / CH % SPAN, k = e % CH;
      const int t = tb + r, w = c0 + k;
      tile[e] = t < a.S && w < a.W ? src[arr][(b * a.S + t) * a.W + w]
                                   : from_f32<E>(0.0f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// KEEP: also store every state in fp32 (a.h32), for K7b; the serving
// instance (KEEP false) has no such store.
template <typename E, bool KEEP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rglru_chunked_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2(*comp)[CH] = reinterpret_cast<float2(*)[CH]>(smem);
  float2(*pub)[CH] = comp + SUB;
  float2* carry = comp[SUB + 2];
  E* tiles = reinterpret_cast<E*>(smem + COMP_BYTES);
  E* y = static_cast<E*>(a.y);
  const int c = threadIdx.x % CH;
  const int j = threadIdx.x / CH;
  const int R = gridDim.x;              // the cluster spans grid x
  const int rank = blockIdx.x;
  // this cluster's units: its items (batch row, channel tile), each the
  // time axis's windows in order
  const int mine = (a.items - blockIdx.y + gridDim.y - 1) / gridDim.y;
  const int units = mine * a.windows;
  auto unit_tb = [&](int u) { return (u % a.windows * R + rank) * SPAN; };
  auto unit_item = [&](int u) {
    return blockIdx.y + u / a.windows * gridDim.y;
  };
  if (units > 0) {
    const int it = unit_item(0);
    stage(tiles, a, it / a.tiles, unit_tb(0), it % a.tiles * CH);
  }
  float sp = 0.0f, hw = 0.0f;           // softplus term, window carry-in
  for (int u = 0; u < units; ++u) {
    const int it = unit_item(u), win = u % a.windows;
    const long long b = it / a.tiles;
    const int w = it % a.tiles * CH + c;
    const bool inw = w < a.W;
    if (win == 0) {
      sp = inw ? -8.0f * softplus_f32(a.log_a[w]) : 0.0f;
      hw = inw ? a.h0[b * a.W + w] : 0.0f;
    }
    // the next unit's tiles into the other buffer, while this one computes
    if (u + 1 < units) {
      const int nit = unit_item(u + 1);
      stage(tiles + ((u + 1) & 1) * 3 * SPAN * CH, a, nit / a.tiles,
            unit_tb(u + 1), nit % a.tiles * CH);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const E* tile = tiles + (u & 1) * 3 * SPAN * CH;
    const int t0 = unit_tb(u) + j * STEPS;
    // pass 1: a_t, b_t of this thread's steps and their composite
    float av[STEPS], bv[STEPS];
    float A = 1.0f, H = 0.0f;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int off = (j * STEPS + i) * CH + c;
      const float xi = to_f32(tile[off]);
      const float gxi = to_f32(tile[SPAN * CH + off]);
      const float gai = to_f32(tile[2 * SPAN * CH + off]);
      const float l = sp * sigmoid_sfu(gai);
      const float m = sqrt_sfu(fmaxf(1.0f - expf(2.0f * l), 1e-12f));
      // a_t and b_t; the identity past S
      const bool in = t0 + i < a.S;
      av[i] = in ? expf(l) : 1.0f;
      bv[i] = in ? m * sigmoid_sfu(gxi) * xi : 0.0f;
      fold(A, H, av[i], bv[i]);
    }
    comp[j][c] = make_float2(A, H);
    __syncthreads();
    // this thread's prefix: the block's sub-chunks before its own
    float PA = 1.0f, PH = 0.0f;
#pragma unroll
    for (int k = 0; k < SUB - 1; ++k)
      if (k < j) fold(PA, PH, comp[k][c].x, comp[k][c].y);
    if (j == SUB - 1) {
      float TA = PA, TH = PH;
      fold(TA, TH, A, H);
      pub[u & 1][c] = make_float2(TA, TH);
    }
    cluster_sync();                     // every block's composite published
    if (j == 0) {
      // the window's carry-in through the blocks before this one, and
      // through all R for the next window
      float2 e[MAX_CLUSTER];
      const uint32_t addr = smem_u32(&pub[u & 1][c]);
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < R) e[r] = ld_cluster8(addr, r);
      float h = hw, hin = hw;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        if (r < R) {
          if (r == rank) hin = h;
          h = fmaf(e[r].x, h, e[r].y);
        }
      }
      carry[c] = make_float2(hin, h);
    }
    __syncthreads();
    const float2 cr = carry[c];
    hw = cr.y;
    // pass 2: from this thread's carry-in, out of registers
    float h = fmaf(PA, cr.x, PH);
    E* yp = y + (b * a.S + t0) * a.W + w;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      h = fmaf(av[i], h, bv[i]);
      if (inw && t0 + i < a.S)
        yp[static_cast<long long>(i) * a.W] = from_f32<E>(h);
      if constexpr (KEEP) {
        if (inw && t0 + i < a.S)
          a.h32[(b * a.S + t0 + i) * a.W + w] = h;
      }
    }
  }
  if (R > 1) cluster_sync();            // no block leaves while read remotely
}

// The launch: clusters of R blocks along x, as many along y as the card
// holds at once (at most one an item), each walking its items.  Fills
// `cfg` (its cluster attribute in `cluster`).
template <typename E, bool KEEP>
int configure(const Args& a, int R, cudaStream_t stream,
              cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster) {
  auto kernel = rglru_chunked_kernel<E, KEEP>;
  // Raise the dynamic shared memory limit once, so that a launch captured
  // in a CUDA graph makes no such call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<E>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<E>();
  cfg.stream = stream;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = R;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  static int resident[MAX_CLUSTER + 1] = {};   // clusters at once, by R
  if (resident[R] == 0) {
    cfg.gridDim = dim3(R, 1, 1);
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&resident[R], kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident[R] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cfg.gridDim = dim3(R, a.items < resident[R] ? a.items : resident[R], 1);
  return 0;
}

template <typename E, bool KEEP>
int launch(const Args& a, int R, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  const int err = configure<E, KEEP>(a, R, stream, cfg, cluster);
  if (err != 0) return err;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, rglru_chunked_kernel<E, KEEP>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool bad_args(int B, int S, int W, int cluster, int dtype) {
  return B <= 0 || S <= 0 || W <= 0 || cluster < 1 ||
         cluster > MAX_CLUSTER || (dtype != DTYPE_F32 && dtype != DTYPE_BF16) ||
         static_cast<long long>(B) * ((W + CH - 1) / CH) > 0x7fffffffLL;
}

Args make_args(const void* x, const void* gx, const void* ga,
               const float* log_a, const float* h0, void* y, float* h32,
               int B, int S, int W, int cluster, int dtype) {
  const int per = dtype == DTYPE_F32 ? 4 : 8;   // elements a 16-byte chunk
  const int tiles = (W + CH - 1) / CH;
  return {x, gx, ga, log_a, h0, y, h32, S, W, tiles, B * tiles,
          (S + cluster * SPAN - 1) / (cluster * SPAN),
          W % per == 0 && aligned16(x) && aligned16(gx) && aligned16(ga)};
}

// ---------------------------------------------------------------------------
// K7b: the gradient of the scan.
//
// Replaces: no TPU kernel.  The JAX package differentiates
// src/repro/models/layers.py::rglru by autodiff.
//
// What bounds it on the H100: the bytes, x, gx, ga, dy read and dx, dgx,
// dga written in x's type and the fp32 states read once (18 B an element in
// bf16: 189 MB at B 4, S 1024, W 2560, 0.056 ms at 3.35 TB/s).  This first
// version is latency-bound instead: one thread a chain gives the layer
// shape 10,240 threads; the forward's chunked scan over a cluster fits the
// reverse recurrence and is later work.
//
// With g_t = dy_t + a_{t+1} g_{t+1} (the reverse recurrence, g past the
// end 0), r = sigmoid(ga), i = sigmoid(gx), L = -8 r softplus(log_a),
// u = 1 - exp(2 L), m = sqrt(max(u, 1e-12)):
//   dx = g m i,   dgx = g m x i (1 - i),
//   dL = g h_{t-1} a + (u > 1e-12 ? -g i x exp(2 L) / m : 0),
//   dga = dL (-8 softplus(log_a)) r (1 - r),   dh0 = a_0 g_0,
//   dlog_a = -8 sigmoid(log_a) sum_{b,t} dL r,
// the clip's derivative 0 where it holds, as JAX takes it; h_{t-1} the
// forward's fp32 state (K7's h32; h0 before the first step).  One thread a
// (batch row, channel), neighbouring threads neighbouring channels, walks
// time backward, BWD_STEPS steps' loads issued ahead of their arithmetic; it
// writes its share of dlog_a's sum, and a second launch sums the batch rows
// in order (deterministic: no atomics).  The exponentials, sigmoids and
// the square root are the IEEE forms.
constexpr int BWD_BLOCK = 64;
constexpr int BWD_STEPS = 8;

struct BwdArgs {
  const void* x;
  const void* gx;
  const void* ga;
  const void* dy;
  const float* log_a;
  const float* h0;
  const float* h32;
  void* dx;
  void* dgx;
  void* dga;
  float* dh0;
  float* dla;         // (B, W): sum over t of dL r, this row's share
  int B, S, W;
};

template <typename E>
__global__ void __launch_bounds__(BWD_BLOCK)
rglru_bwd_kernel(const BwdArgs a) {
  const long long idx = static_cast<long long>(blockIdx.x) * BWD_BLOCK +
                        threadIdx.x;
  if (idx >= static_cast<long long>(a.B) * a.W) return;
  const int w = static_cast<int>(idx % a.W);
  const long long b = idx / a.W;
  const E* const X = static_cast<const E*>(a.x);
  const E* const GX = static_cast<const E*>(a.gx);
  const E* const GA = static_cast<const E*>(a.ga);
  const E* const DY = static_cast<const E*>(a.dy);
  E* const DX = static_cast<E*>(a.dx);
  E* const DGX = static_cast<E*>(a.dgx);
  E* const DGA = static_cast<E*>(a.dga);
  const float c_sp = -8.0f * softplus_f32(a.log_a[w]);
  const long long row = b * a.S * a.W + w;     // element (b, 0, w)
  float carry = 0.0f, sum = 0.0f;              // a_{t+1} g_{t+1}; sum dL r
  for (int t1 = a.S; t1 > 0; t1 -= BWD_STEPS) {
    // steps t1 - 1 down to t1 - BWD_STEPS: every load first
    float xv[BWD_STEPS], gxv[BWD_STEPS], gav[BWD_STEPS], dyv[BWD_STEPS],
        hv[BWD_STEPS];
#pragma unroll
    for (int i = 0; i < BWD_STEPS; ++i) {
      const int t = t1 - 1 - i;
      if (t >= 0) {
        const long long o = row + static_cast<long long>(t) * a.W;
        xv[i] = to_f32(X[o]);
        gxv[i] = to_f32(GX[o]);
        gav[i] = to_f32(GA[o]);
        dyv[i] = to_f32(DY[o]);
        hv[i] = t > 0 ? a.h32[o - a.W] : a.h0[b * a.W + w];
      }
    }
#pragma unroll
    for (int i = 0; i < BWD_STEPS; ++i) {
      const int t = t1 - 1 - i;
      if (t >= 0) {
        const float r = sigmoid_f32(gav[i]), ig = sigmoid_f32(gxv[i]);
        const float L = c_sp * r;
        const float av = expf(L), e2 = expf(2.0f * L);
        const float u = 1.0f - e2;
        const float m = sqrtf(fmaxf(u, 1e-12f));
        const float g = dyv[i] + carry;
        const float gi = g * ig;
        const float dL = g * hv[i] * av +
                         (u > 1e-12f ? -gi * xv[i] * e2 / m : 0.0f);
        const long long o = row + static_cast<long long>(t) * a.W;
        DX[o] = from_f32<E>(gi * m);
        DGX[o] = from_f32<E>(gi * m * xv[i] * (1.0f - ig));
        DGA[o] = from_f32<E>(dL * c_sp * r * (1.0f - r));
        sum = fmaf(dL, r, sum);
        carry = av * g;
      }
    }
  }
  a.dh0[b * a.W + w] = carry;
  a.dla[b * a.W + w] = sum;
}

__global__ void __launch_bounds__(256)
rglru_bwd_log_a_kernel(const float* __restrict__ dla,
                       const float* __restrict__ log_a,
                       float* __restrict__ dlog_a, int B, int W) {
  const int w = blockIdx.x * 256 + threadIdx.x;
  if (w >= W) return;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b) sum += dla[static_cast<long long>(b) * W + w];
  dlog_a[w] = -8.0f * sigmoid_f32(log_a[w]) * sum;
}

}  // namespace

// The block's shape, into out[0..2]: channels, sub-chunks and steps a
// sub-chunk (kernels/rglru.py plans the cluster with the same numbers).
extern "C" int rglru_block_shape(int* out) {
  out[0] = CH;
  out[1] = SUB;
  out[2] = STEPS;
  return 0;
}

// K7's launch at (B, S, W) with `cluster` blocks along the time axis, into
// out[0..3]: grid x (the cluster) and y (the clusters, each walking its
// items), the threads a block and its dynamic shared memory in bytes.
extern "C" int rglru_launch_shape(int B, int S, int W, int cluster,
                                  int dtype, int* out) {
  if (bad_args(B, S, W, cluster, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, B, S, W, cluster, dtype);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err =
      dtype == DTYPE_F32
          ? configure<float, false>(a, cluster, nullptr, cfg, attr)
          : configure<__nv_bfloat16, false>(a, cluster, nullptr, cfg, attr);
  out[0] = cfg.gridDim.x;
  out[1] = cfg.gridDim.y;
  out[2] = cfg.blockDim.x;
  out[3] = static_cast<int>(cfg.dynamicSmemBytes);
  return err;
}

// x, gx, ga, y (B, S, W) of one element type (`dtype`, common.cuh's code),
// log_a (W,) and h0 (B, W) fp32, all row-major on the device; `cluster`
// blocks (1..8) along the time axis, as kernels/rglru.py::launch_plan gives
// them.  Where `h32` is not null it receives every state h_t in fp32
// (B, S, W), what K7b reads.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rglru_scan(const void* x, const void* gx, const void* ga,
                          const float* log_a, const float* h0, void* y,
                          float* h32, int B, int S, int W, int cluster,
                          int dtype, void* stream) {
  if (bad_args(B, S, W, cluster, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a =
      make_args(x, gx, ga, log_a, h0, y, h32, B, S, W, cluster, dtype);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h32 != nullptr)
    return dtype == DTYPE_F32 ? launch<float, true>(a, cluster, s)
                              : launch<__nv_bfloat16, true>(a, cluster, s);
  return dtype == DTYPE_F32 ? launch<float, false>(a, cluster, s)
                            : launch<__nv_bfloat16, false>(a, cluster, s);
}

// K7b.  x, gx, ga, dy, dx, dgx, dga (B, S, W) of one element type; log_a
// (W,), h0 (B, W), h32 (B, S, W) (K7's kept states for these inputs), dh0
// and dla (B, W), dlog_a (W,) fp32; all row-major on the device.  Launches
// two kernels on `stream` and returns cudaGetLastError().
extern "C" int rglru_scan_bwd(const void* x, const void* gx, const void* ga,
                              const float* log_a, const float* h0,
                              const float* h32, const void* dy, void* dx,
                              void* dgx, void* dga, float* dh0, float* dla,
                              float* dlog_a, int B, int S, int W, int dtype,
                              void* stream) {
  if (bad_args(B, S, W, 1, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{x, gx, ga, dy, log_a, h0, h32, dx, dgx, dga, dh0, dla,
                  B, S, W};
  const long long chains = static_cast<long long>(B) * W;
  const int blocks = static_cast<int>((chains + BWD_BLOCK - 1) / BWD_BLOCK);
  if (dtype == DTYPE_F32)
    rglru_bwd_kernel<float><<<blocks, BWD_BLOCK, 0, s>>>(a);
  else
    rglru_bwd_kernel<__nv_bfloat16><<<blocks, BWD_BLOCK, 0, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rglru_bwd_log_a_kernel<<<(W + 255) / 256, 256, 0, s>>>(dla, log_a, dlog_a,
                                                         B, W);
  return static_cast<int>(cudaGetLastError());
}
