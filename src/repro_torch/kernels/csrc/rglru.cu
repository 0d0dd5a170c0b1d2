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

// The launch of `kernel` (its dynamic shared memory `smem`): clusters of R
// blocks along x, as many along y as the card holds at once (at most one
// an item), each walking its items.  Fills `cfg` (its cluster attribute in
// `cluster`); `resident` caches the occupancy API's count by R.
template <typename Kernel>
int configure_kernel(Kernel kernel, int smem, int items, int R,
                     cudaStream_t stream, cudaLaunchConfig_t& cfg,
                     cudaLaunchAttribute& cluster,
                     int (&resident)[MAX_CLUSTER + 1]) {
  cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = R;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (resident[R] == 0) {
    cfg.gridDim = dim3(R, 1, 1);
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&resident[R], kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident[R] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cfg.gridDim = dim3(R, items < resident[R] ? items : resident[R], 1);
  return 0;
}

template <typename E, bool KEEP>
int configure(const Args& a, int R, cudaStream_t stream,
              cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster) {
  auto kernel = rglru_chunked_kernel<E, KEEP>;
  // Raise the dynamic shared memory limit once, so that a launch captured
  // in a CUDA graph makes no such call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<E>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static int resident[MAX_CLUSTER + 1] = {};   // clusters at once, by R
  return configure_kernel(kernel, smem_bytes<E>(), a.items, R, stream, cfg,
                          cluster, resident);
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
// bf16: 189 MB at B 4, S 1024, W 2560, 0.056 ms at 3.35 TB/s).  The
// recurrence is serial in time, and the layer shape has 10,240 chains: one
// thread a chain (this kernel's first version, 0.81 ms) is latency-bound.
//
// With g_t = dy_t + a_{t+1} g_{t+1} (the reverse recurrence, g past the
// end 0), r = sigmoid(ga), i = sigmoid(gx), L = -8 r softplus(log_a),
// u = 1 - exp(2 L), m = sqrt(max(u, 1e-12)):
//   dx = g m i,   dgx = g m x i (1 - i),
//   dL = g h_{t-1} a + (u > 1e-12 ? -g i x exp(2 L) / m : 0),
//   dga = dL (-8 softplus(log_a)) r (1 - r),   dh0 = a_0 g_0,
//   dlog_a = -8 sigmoid(log_a) sum_{b,t} dL r,
// the clip's derivative 0 where it holds, as JAX takes it; h_{t-1} the
// forward's fp32 state (K7's h32; h0 before the first step).
//
// What the design does about it: K7's chunked scan run backward in time.
// The carry c_t = a_t g_t obeys c_{t-1} = a_t (c_t + dy_t): per step the
// affine map (a_t, a_t dy_t), the forward's algebra with time reversed.
// - Blocks, clusters and items as K7's: 32 channels (a lane each) x SUB
//   sub-chunks (a warp each) of STEPS steps, clusters of R <= 8 blocks
//   spanning a window, as many clusters as the card holds walking their
//   items (batch row, 32-channel tile); each item's windows from the last
//   to the first, the carry handed from one window to the one before it.
// - Staging: x, gx, ga, dy and h_{t-1} (h32 one step earlier, h0 before
//   step 0) tiles of the next unit copied by 16-byte cp.async into the
//   other of two buffers while this unit computes.
// - Pass 1: each thread forms a_t and r_t of its steps and its sub-chunk's
//   composite from its last step to its first; the block folds the
//   sub-chunks after each one (its suffix) in shared memory, publishes its
//   own composite, and after one cluster barrier warp 0 folds the window's
//   carry-in through the blocks after its own: the block's carry-in;
//   through all R: the window before's.
// - Pass 2: each thread walks its steps again, last to first, out of
//   registers and the staged tile, writing dx, dgx, dga (and dh0 at step
//   0) and summing dL r.
// - dlog_a in a fixed order (no atomics): each thread's steps, the block's
//   sub-chunks in order, published with the next unit's composite; rank 0
//   adds the ranks in order and then the windows, writing the batch row's
//   sum into dla (B, W); a second launch adds the batch rows in order.
// - Numerics: the gates' sigmoids and the square root in K7's SFU forms
//   (sigmoid_sfu, sqrt_sfu), exp(L) and exp(2 L) as accurate expf.
// - Four blocks an SM at least: 128 registers a thread, no spill (two,
//   three and six blocks were slower, tools/k7b_ablate.py).
constexpr int BWD_MIN_BLOCKS = 4;       // resident blocks an SM, at least

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
  float* dla;         // (B, W): sum over t of dL r, each batch row's
  int S, W, tiles, items, windows;
  bool vec;           // 16-byte rows: copied asynchronously
};

// A block's dynamic shared memory: the (A, H) composites of each
// sub-chunk, the block's published (A, H, sum of dL r of the unit before,
// 0) by unit parity, the carries warp 0 forms, each thread's sum of dL r;
// then two buffers of a unit's x, gx, ga, dy tiles (x's type) and its
// h_{t-1} tile (fp32), SPAN steps x CH channels each.
constexpr int BWD_HEAD_BYTES =
    SUB * CH * 8 + 2 * CH * 16 + CH * 8 + SUB * CH * 4;
template <typename E>
__host__ __device__ constexpr int bwd_buf_bytes() {
  return SPAN * CH * (4 * static_cast<int>(sizeof(E)) + 4);
}
template <typename E>
constexpr int bwd_smem_bytes() {
  return BWD_HEAD_BYTES + 2 * bwd_buf_bytes<E>();
}

// One unit's tiles: steps [tb, tb + SPAN) of channels [c0, c0 + CH) of x,
// gx, ga, dy and the states one step earlier (h0 for step 0) of batch row
// b into `buf`, zeros past S and W.
template <typename E>
__device__ __forceinline__ void stage_bwd(unsigned char* buf,
                                          const BwdArgs& a, long long b,
                                          int tb, int c0) {
  E* const tile = reinterpret_cast<E*>(buf);
  float* const ht = reinterpret_cast<float*>(buf + 4 * SPAN * CH * sizeof(E));
  const E* const src[4] = {
      static_cast<const E*>(a.x), static_cast<const E*>(a.gx),
      static_cast<const E*>(a.ga), static_cast<const E*>(a.dy)};
  constexpr int PER = 16 / sizeof(E);   // elements a chunk
  constexpr int ROW = CH / PER;         // chunks a step
  if (a.vec) {
    for (int c = threadIdx.x; c < 4 * SPAN * ROW; c += THREADS) {
      const int arr = c / (SPAN * ROW), r = c / ROW % SPAN, k = c % ROW;
      const int t = tb + r, w = c0 + k * PER;
      const bool ok = t < a.S && w < a.W;
      const E* g = ok ? src[arr] + (b * a.S + t) * a.W + w : src[arr];
      cp_async16(smem_u32(tile + (arr * SPAN + r) * CH + k * PER), g, ok);
    }
    for (int c = threadIdx.x; c < SPAN * (CH / 4); c += THREADS) {
      const int r = c / (CH / 4), k = c % (CH / 4);
      const int t = tb + r - 1, w = c0 + k * 4;
      const bool ok = t < a.S && w < a.W;
      const float* g = !ok ? a.h0
                       : t < 0 ? a.h0 + b * a.W + w
                               : a.h32 + (b * a.S + t) * a.W + w;
      cp_async16(smem_u32(ht + r * CH + k * 4), g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 4 * SPAN * CH; e += THREADS) {
      const int arr = e / (SPAN * CH), r = e / CH % SPAN, k = e % CH;
      const int t = tb + r, w = c0 + k;
      tile[e] = t < a.S && w < a.W ? src[arr][(b * a.S + t) * a.W + w]
                                   : from_f32<E>(0.0f);
    }
    for (int e = threadIdx.x; e < SPAN * CH; e += THREADS) {
      const int r = e / CH, k = e % CH;
      const int t = tb + r - 1, w = c0 + k;
      ht[e] = !(t < a.S && w < a.W) ? 0.0f
              : t < 0 ? a.h0[b * a.W + w]
                      : a.h32[(b * a.S + t) * a.W + w];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename E>
__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
rglru_bwd_chunked_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2(*comp)[CH] = reinterpret_cast<float2(*)[CH]>(smem);
  float4(*pub)[CH] = reinterpret_cast<float4(*)[CH]>(smem + SUB * CH * 8);
  float2* carry = reinterpret_cast<float2*>(smem + SUB * CH * 8 + 2 * CH * 16);
  float(*psum)[CH] = reinterpret_cast<float(*)[CH]>(
      smem + SUB * CH * 8 + 2 * CH * 16 + CH * 8);
  unsigned char* const bufs = smem + BWD_HEAD_BYTES;
  constexpr int BUF = bwd_buf_bytes<E>();
  E* const DX = static_cast<E*>(a.dx);
  E* const DGX = static_cast<E*>(a.dgx);
  E* const DGA = static_cast<E*>(a.dga);
  const int c = threadIdx.x % CH;
  const int j = threadIdx.x / CH;
  const int R = gridDim.x;              // the cluster spans grid x
  const int rank = blockIdx.x;
  // this cluster's units: its items, each the time axis's windows from the
  // last to the first
  const int mine = (a.items - blockIdx.y + gridDim.y - 1) / gridDim.y;
  const int units = mine * a.windows;
  auto unit_tb = [&](int u) {
    return ((a.windows - 1 - u % a.windows) * R + rank) * SPAN;
  };
  auto unit_item = [&](int u) {
    return blockIdx.y + u / a.windows * gridDim.y;
  };
  // rank 0, warp 0: the item's sum of dL r so far, over ranks and windows;
  // its channel in dla written when the item's last unit is summed
  float dsum = 0.0f;
  auto add_sums = [&](int u, const float4 (&e)[MAX_CLUSTER]) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < R) s += e[r].z;
    dsum += s;
    if (u % a.windows == a.windows - 1) {     // the item's first window
      const int it = unit_item(u);
      const int w = it % a.tiles * CH + c;
      if (w < a.W) a.dla[static_cast<long long>(it / a.tiles) * a.W + w] = dsum;
      dsum = 0.0f;
    }
  };
  if (units > 0) {
    const int it = unit_item(0);
    stage_bwd<E>(bufs, a, it / a.tiles, unit_tb(0), it % a.tiles * CH);
  }
  float sp = 0.0f, cw = 0.0f;           // -8 softplus; window carry-in
  for (int u = 0; u < units; ++u) {
    const int it = unit_item(u);
    const long long b = it / a.tiles;
    const int w = it % a.tiles * CH + c;
    const bool inw = w < a.W;
    if (u % a.windows == 0) {
      sp = inw ? -8.0f * softplus_f32(a.log_a[w]) : 0.0f;
      cw = 0.0f;
    }
    if (u + 1 < units) {
      const int nit = unit_item(u + 1);
      stage_bwd<E>(bufs + ((u + 1) & 1) * BUF, a, nit / a.tiles,
                   unit_tb(u + 1), nit % a.tiles * CH);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const unsigned char* const buf = bufs + (u & 1) * BUF;
    const E* const tile = reinterpret_cast<const E*>(buf);
    const float* const ht =
        reinterpret_cast<const float*>(buf + 4 * SPAN * CH * sizeof(E));
    const int t0 = unit_tb(u) + j * STEPS;
    // pass 1: a_t, r_t of this thread's steps and their composite, from
    // the last step to the first; past S a = 1 and dy = 0, the identity
    float av[STEPS], rv[STEPS];
    float A = 1.0f, H = 0.0f;
#pragma unroll
    for (int i = STEPS - 1; i >= 0; --i) {
      const int off = (j * STEPS + i) * CH + c;
      rv[i] = sigmoid_sfu(to_f32(tile[2 * SPAN * CH + off]));
      av[i] = t0 + i < a.S ? expf(sp * rv[i]) : 1.0f;
      fold(A, H, av[i], av[i] * to_f32(tile[3 * SPAN * CH + off]));
    }
    comp[j][c] = make_float2(A, H);
    __syncthreads();
    // this thread's suffix: the block's sub-chunks after its own
    float PA = 1.0f, PH = 0.0f;
#pragma unroll
    for (int k = SUB - 1; k > 0; --k)
      if (k > j) fold(PA, PH, comp[k][c].x, comp[k][c].y);
    if (j == 0) {
      float TA = PA, TH = PH;
      fold(TA, TH, A, H);
      // with it, the block's sum of dL r of the unit before, sub-chunks in
      // order (psum is written after this unit's barriers)
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < SUB; ++k) s += psum[k][c];
      pub[u & 1][c] = make_float4(TA, TH, s, 0.0f);
    }
    cluster_sync();                     // every block's composite published
    if (j == 0) {
      float4 e[MAX_CLUSTER];
      const uint32_t addr = smem_u32(&pub[u & 1][c]);
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < R) e[r] = ld_cluster16(addr, r);
      // the window's carry through the blocks after this one, and through
      // all R for the window before
      float h = cw, hin = cw;
#pragma unroll
      for (int r = MAX_CLUSTER - 1; r >= 0; --r) {
        if (r < R) {
          if (r == rank) hin = h;
          h = fmaf(e[r].x, h, e[r].y);
        }
      }
      carry[c] = make_float2(hin, h);
      if (rank == 0 && u > 0) add_sums(u - 1, e);
    }
    __syncthreads();
    const float2 cr = carry[c];
    cw = cr.y;
    // pass 2: from this sub-chunk's carry-in, its steps last to first
    float cc = fmaf(PA, cr.x, PH);
    float part = 0.0f;
#pragma unroll
    for (int i = STEPS - 1; i >= 0; --i) {
      const int t = t0 + i;
      const int off = (j * STEPS + i) * CH + c;
      const float xi = to_f32(tile[off]);
      const float ig = sigmoid_sfu(to_f32(tile[SPAN * CH + off]));
      const float g = to_f32(tile[3 * SPAN * CH + off]) + cc;
      const float L = sp * rv[i];
      const float e2 = expf(2.0f * L);
      const float uu = 1.0f - e2;
      const float m = sqrt_sfu(fmaxf(uu, 1e-12f));
      const float gi = g * ig;
      const float dL = g * ht[(j * STEPS + i) * CH + c] * av[i] +
                       (uu > 1e-12f ? -gi * xi * __fdividef(e2, m) : 0.0f);
      cc = av[i] * g;
      if (inw && t < a.S) {
        const long long o = (b * a.S + t) * a.W + w;
        DX[o] = from_f32<E>(gi * m);
        DGX[o] = from_f32<E>(gi * m * xi * (1.0f - ig));
        DGA[o] = from_f32<E>(dL * sp * rv[i] * (1.0f - rv[i]));
        part = fmaf(dL, rv[i], part);
        if (t == 0) a.dh0[b * a.W + w] = cc;
      }
    }
    psum[j][c] = part;
  }
  if (units > 0) {
    // the last unit's sums, published alone
    __syncthreads();
    if (j == 0) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < SUB; ++k) s += psum[k][c];
      pub[units & 1][c].z = s;
    }
    cluster_sync();
    if (j == 0 && rank == 0) {
      float4 e[MAX_CLUSTER];
      const uint32_t addr = smem_u32(&pub[units & 1][c]);
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < R) e[r] = ld_cluster16(addr, r);
      add_sums(units - 1, e);
    }
  }
  cluster_sync();                       // no block leaves while read remotely
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

template <typename E>
int launch_bwd(const BwdArgs& a, int R, cudaStream_t stream) {
  auto kernel = rglru_bwd_chunked_kernel<E>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem_bytes<E>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static int resident[MAX_CLUSTER + 1] = {};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  const int err = configure_kernel(kernel, bwd_smem_bytes<E>(), a.items, R,
                                   stream, cfg, cluster, resident);
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
// and dla (B, W, scratch), dlog_a (W,) fp32; all row-major on the device;
// `cluster` blocks (1..8) along the time axis, as K7 takes it.  Launches
// two kernels on `stream` and returns cudaGetLastError().
extern "C" int rglru_scan_bwd(const void* x, const void* gx, const void* ga,
                              const float* log_a, const float* h0,
                              const float* h32, const void* dy, void* dx,
                              void* dgx, void* dga, float* dh0, float* dla,
                              float* dlog_a, int B, int S, int W, int cluster,
                              int dtype, void* stream) {
  if (bad_args(B, S, W, cluster, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args f = make_args(x, gx, ga, log_a, h0, nullptr, nullptr, B, S, W,
                           cluster, dtype);
  const BwdArgs a{x, gx, ga, dy, log_a, h0, h32, dx, dgx, dga, dh0, dla,
                  S, W, f.tiles, f.items, f.windows,
                  f.vec && aligned16(dy) && aligned16(h0) && aligned16(h32)};
  const int err = dtype == DTYPE_F32 ? launch_bwd<float>(a, cluster, s)
                                     : launch_bwd<__nv_bfloat16>(a, cluster, s);
  if (err != 0) return err;
  rglru_bwd_log_a_kernel<<<(W + 255) / 256, 256, 0, s>>>(dla, log_a, dlog_a,
                                                         B, W);
  return static_cast<int>(cudaGetLastError());
}
