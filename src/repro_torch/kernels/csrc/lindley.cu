// K6: the fleet's FCFS Lindley scan in fp64, one launch a solve over the
// flat segments.  Each segment (one server's queue: a contiguous run of
// the flat arrivals t and service demands s) is walked in order:
//
//   c = c + s;  p = c - s;  m = max(m, t - p);  out = max(t, m + p)
//
// with c = 0 and m = -inf at the start of the segment, and max numpy's
// maximum, (a >= b || isnan(a)) ? a : b: the first operand on ties (signed
// zeros included), a NaN in either operand propagated.
//
// Replaces: src/repro/kernels/lindley.py:66 (lindley_scan, _lindley_kernel),
// the Pallas TPU kernel that pads (R, W) to tile multiples, transposes to
// (W, R) so that rows ride the lanes, and carries (c, m) across the
// sequential depth axis of its grid in VMEM scratch.  The solver called it
// once for each power-of-two length bucket of a solve, padded; here one
// launch takes every segment of a solve where it lies, and an (R, W) call
// is the same kernel with fenceposts W * r.
//
// What bounds it on the H100: not the bytes (24 B an element, t and s read
// once and the start written once: 0.013 ms for a fleet run's 1.83 million
// elements at 3.35 TB/s) but the chain.  The output must be byte-equal to
// numpy's solver, so c has to be rounded step by step in order (no
// re-association), and the longest segment costs its length times the
// latency of one dependent fp64 add (lindley_add_latency measures it; the
// "chain bound").  The running max has no rounding, and numpy's max rule,
// "the leftmost of the maxima, a NaN absorbing", is associative, so it can
// be a parallel scan with the serial fold's bytes.
//
// What the design does about it:
// - Only the cumsum on the serial chain.  A block of two warps takes one
//   segment.  Lane 0 of the chain warp walks c = c + s in order, reading s
//   from shared memory eight steps ahead as 16-byte words and writing back
//   only c at the start of each run of eight steps (a store a step cost
//   ~0.6 ns a step, tools/k6_ablate.py); nothing else is on its path.
//   The scan warp does everything else for the same tile one tile behind:
//   each lane adds its run's eight steps again from that c (the same
//   operations in the same order: the same bytes), then p = c - s and
//   x = t - p, the running max as a fold of each lane's eight steps plus a
//   warp shuffle scan of the lanes' totals with a carry across tiles, and
//   out = max(t, m + p), each rounded on its own (__dadd_rn/__dsub_rn: no
//   contraction).
// - Loads off the chain.  The scan warp streams the segment through shared
//   memory in tiles of 256 steps, four stages deep, with cp.async
//   (coalesced along the segment, 8 bytes an element: the flat offsets of
//   a segment are only 8-byte aligned, and the loads are ~1% of the
//   chain's time).  The two warps hand tiles over with named barriers, one
//   pair a stage: "tile k has landed" and "the chain has walked tile k".  A
//   lane's eight steps sit ten doubles apart in shared memory, so its
//   16-byte reads and the warp's are free of bank conflicts.
// - The card filled.  One block a segment, so a solve's 128 segments run on
//   128 SMs at once.  Where a solve has more segments than the card holds
//   at once, the wrapper passes an order that starts the longest first.
// - Ragged edges.  No padding: empty segments launch nothing, a segment's
//   last tile walks only the steps it has.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int TILE = 256;                  // steps of a segment a tile
constexpr int LANE_STEPS = TILE / 32;      // a scan lane's run of steps
constexpr int LANE_STRIDE = LANE_STEPS + 2;  // doubles between two runs
constexpr int SLOT = 32 * LANE_STRIDE;     // one array of a tile
constexpr int STAGES = 4;                  // tiles in flight a segment
constexpr int THREADS = 64;                // the chain warp and the scan warp
constexpr unsigned FULL = 0xffffffffu;

// A stage of the ring: the tile's t and s as loaded, and c as the chain
// had it at the start of each lane's run of steps.
struct Stage {
  double t[SLOT], s[SLOT], c[32];
};

__device__ __forceinline__ int slot_of(int i) {
  return (i / LANE_STEPS) * LANE_STRIDE + i % LANE_STEPS;
}

// numpy's maximum.
__device__ __forceinline__ double npmax(double a, double b) {
  return (a >= b || isnan(a)) ? a : b;
}

__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barriers between the two warps (id 0 is __syncthreads'): the
// chain warp waits on LOADED(stage), the scan warp on CREADY(stage).
__device__ __forceinline__ int loaded_id(long long k) {
  return 1 + static_cast<int>(k % STAGES);
}
__device__ __forceinline__ int cready_id(long long k) {
  return 1 + STAGES + static_cast<int>(k % STAGES);
}
__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_signal(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

// Copy steps [0, len) of a tile that starts at flat element `base`.
__device__ __forceinline__ void load_tile(Stage& st, const double* t,
                                          const double* s, long long base,
                                          int len, int lane) {
  for (int i = lane; i < len; i += 32) {
    copy_async8(st.t + slot_of(i), t + base + i);
    copy_async8(st.s + slot_of(i), s + base + i);
  }
}

__device__ __forceinline__ double2 ld2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// The chain over one tile: c = c + s for steps [0, len).  It writes only c
// at the start of each run of eight (the scan lane that takes the run adds
// its eight again, the same operations in the same order, off the chain),
// and reads the next run's s as 16-byte words while it adds this one's.
__device__ __forceinline__ double chain_tile(Stage& st, int len, double c) {
  constexpr int W = LANE_STEPS / 2;                 // 16-byte words a run
  const int runs = len / LANE_STEPS;
  double2 nx[W];
  if (runs > 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) nx[w] = ld2(st.s + 2 * w);
  }
  for (int q = 0; q < runs; ++q) {
    double2 sv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) sv[w] = nx[w];
    const int next = q + 1 < runs ? q + 1 : q;
#pragma unroll
    for (int w = 0; w < W; ++w) nx[w] = ld2(st.s + next * LANE_STRIDE + 2 * w);
    st.c[q] = c;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      c = __dadd_rn(c, sv[w].x);
      c = __dadd_rn(c, sv[w].y);
    }
  }
  for (int i = runs * LANE_STEPS; i < len; ++i) {
    if (i % LANE_STEPS == 0) st.c[i / LANE_STEPS] = c;
    c = __dadd_rn(c, st.s[slot_of(i)]);
  }
  return c;
}

// Everything but the chain for one tile of `len` steps at flat element
// `base`: lane l takes steps [8l, 8l + 8).  `carry` is the running max of
// the segment's earlier tiles; returns it with this tile folded in.
__device__ __forceinline__ double scan_tile(const Stage& st, double* out,
                                            long long base, int len, int lane,
                                            double carry) {
  const int i0 = lane * LANE_STEPS;
  const int r = lane * LANE_STRIDE;
  double tv[LANE_STEPS], pv[LANE_STEPS], fv[LANE_STEPS];
  double acc = -CUDART_INF;          // the lane's running max, in-lane
  double c = st.c[lane];             // the chain at the start of the run
#pragma unroll
  for (int u = 0; u < LANE_STEPS; u += 2) {
    const double2 t2 = ld2(st.t + r + u), s2 = ld2(st.s + r + u);
    tv[u] = t2.x;
    tv[u + 1] = t2.y;
    c = __dadd_rn(c, s2.x);          // the chain's own adds, again
    pv[u] = __dsub_rn(c, s2.x);      // numpy's C - S, not c_{d-1}
    c = __dadd_rn(c, s2.y);
    pv[u + 1] = __dsub_rn(c, s2.y);
  }
#pragma unroll
  for (int u = 0; u < LANE_STEPS; ++u) {
    if (i0 + u < len) acc = npmax(acc, __dsub_rn(tv[u], pv[u]));
    fv[u] = acc;
  }
  // the lanes' totals, scanned left to right: the earlier lane's first
  double inc = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc = npmax(y, inc);
  }
  const double before = __shfl_up_sync(FULL, inc, 1);
  const double pre = lane == 0 ? carry : npmax(carry, before);
#pragma unroll
  for (int u = 0; u < LANE_STEPS; ++u) {
    if (i0 + u < len)
      out[base + i0 + u] = npmax(tv[u], __dadd_rn(npmax(pre, fv[u]), pv[u]));
  }
  return npmax(carry, __shfl_sync(FULL, inc, 31));
}

// Segment b's flat span: fenceposts seg (clamped to [0, n]) or, without
// them, rows of `width`; `order` (if given) maps block to segment.
__device__ __forceinline__ void span_of(const long long* seg,
                                        const long long* order, long long n,
                                        long long width, long long b,
                                        long long& start, long long& len) {
  const long long j = order ? order[b] : b;
  if (!seg) {
    start = j * width;
    len = width;
    return;
  }
  long long a = seg[j], e = seg[j + 1];
  a = a < 0 ? 0 : (a > n ? n : a);
  e = e < a ? a : (e > n ? n : e);
  start = a;
  len = e - a;
}

// The chain warp (threads 0-31) and the scan warp (32-63) run one tile
// apart.
__global__ void __launch_bounds__(THREADS)
lindley_kernel(const double* __restrict__ t, const double* __restrict__ s,
               double* __restrict__ out, const long long* __restrict__ seg,
               const long long* __restrict__ order, long long n,
               long long width) {
  __shared__ __align__(16) Stage ring[STAGES];
  long long start, len;
  span_of(seg, order, n, width, blockIdx.x, start, len);
  const long long tiles = (len + TILE - 1) / TILE;
  if (tiles == 0) return;
  const int lane = threadIdx.x & 31;
  auto tile_len = [&](long long k) {
    const long long left = len - k * TILE;
    return static_cast<int>(left < TILE ? left : TILE);
  };

  if (threadIdx.x < 32) {            // the chain warp
    double c = 0.0;
    for (long long k = 0; k < tiles; ++k) {
      bar_wait(loaded_id(k));
      if (lane == 0) c = chain_tile(ring[k % STAGES], tile_len(k), c);
      __syncwarp();
      bar_signal(cready_id(k));
    }
    return;
  }

  // the scan warp: the ring's first STAGES - 1 tiles
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < tiles) load_tile(ring[k], t, s, start + k * TILE, tile_len(k), lane);
    commit_async();
  }
  wait_async<STAGES - 2>();          // tile 0 landed
  __syncwarp();
  bar_signal(loaded_id(0));
  double carry = -CUDART_INF;
  for (long long k = 0; k < tiles; ++k) {
    const long long nk = k + STAGES - 1;
    __syncwarp();                    // stage nk % STAGES read by every lane
    if (nk < tiles)
      load_tile(ring[nk % STAGES], t, s, start + nk * TILE, tile_len(nk), lane);
    commit_async();
    Stage& st = ring[k % STAGES];
    wait_async<STAGES - 2>();        // tile k + 1 landed
    __syncwarp();
    if (k + 1 < tiles) bar_signal(loaded_id(k + 1));
    bar_wait(cready_id(k));
    carry = scan_tile(st, out, start + k * TILE, tile_len(k), lane, carry);
  }
}

// One thread: `steps` dependent fp64 adds, timed by the SM's clock and the
// global timer.  out: {the sum, clocks an add, ns an add}.
__global__ void add_latency_kernel(double* out, const double* s,
                                   long long steps) {
  const double v = s[0];
  double c = 0.0;
  long long c0, c1;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(g0)::"memory");
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c0)::"memory");
  for (long long i = 0; i < steps; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) c = __dadd_rn(c, v);
  }
  out[0] = c;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c1)::"memory");
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(g1)::"memory");
  out[1] = static_cast<double>(c1 - c0) / static_cast<double>(steps);
  out[2] = static_cast<double>(g1 - g0) / static_cast<double>(steps);
}

}  // namespace

// t, s, out: n float64 on the device.  With fenceposts seg (n_seg + 1
// int64, from 0 to n), segment j is [seg[j], seg[j + 1]); with seg null,
// segment j is [j * width, (j + 1) * width) and n = n_seg * width.  order:
// null, or n_seg int64 segment indices in the order the blocks take them.
// Elements outside every segment are not written.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int lindley_scan(const double* t, const double* s, double* out,
                            const long long* seg, const long long* order,
                            long long n_seg, long long n, long long width,
                            void* stream) {
  if (n_seg <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (n_seg > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lindley_kernel<<<static_cast<unsigned>(n_seg), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      t, s, out, seg, order, n, width);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of lindley_scan the device holds at once.
extern "C" int lindley_resident_blocks(long long* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lindley_kernel, THREADS, 0);
  *out = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(err);
}

// The latency of one dependent fp64 add (__dadd_rn), the step of K6's
// chain: `steps` of them on one thread, adding s[0].  out (3 float64 on
// the device): the sum, clocks an add, ns an add.
extern "C" int lindley_add_latency(double* out, const double* s,
                                   long long steps, void* stream) {
  if (steps <= 0 || steps % 16) return static_cast<int>(cudaErrorInvalidValue);
  add_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, s,
                                                                       steps);
  return static_cast<int>(cudaGetLastError());
}
