// K6: the batched FCFS Lindley scan in fp64.  For each row (one server's
// queue) of arrivals t and service demands s, walking the depth in order:
//
//   c = c + s;  prev = c - s;  m = max(m, t - prev);  out = max(t, m + prev)
//
// with c = 0 and m = -inf at the start of the row.
//
// Replaces: src/repro/kernels/lindley.py:54 (lindley_scan, _lindley_kernel),
// the Pallas TPU kernel that pads (R, W) to tile multiples, transposes to
// (W, R) so that rows ride the lanes, and carries (c, m) across the
// sequential depth axis of its grid in VMEM scratch.
//
// What bounds it on the H100: the bytes are 24 B an element (t and s read
// once, the start written once), 3.35 TB/s of HBM, which is 0.0038 ms for a
// (1, 2^19) bucket.  The real floor is the serial chain: the longest row's
// depth times one dependent fp64 add (c) and one dependent max (m), with no
// parallelism along the depth.  Parallelism exists only across rows.
//
// What the design does about it:
// - Exactness.  The output must be byte-equal to numpy's segmented solver
//   (repro_torch/core/lindley.py), so each thread walks its row strictly in
//   order with the same four fp64 operations, rounded to nearest one by one
//   (__dadd_rn/__dsub_rn: nothing may be contracted or re-associated, and no
//   prefix scan over the depth is used).  max is numpy's: the first operand
//   on ties (a >= b ? a : b), so even a signed zero comes out the same.
// - Loads off the chain.  One thread per row in a row-major (R, W) layout
//   would have a warp touch 32 scattered words at each step.  Instead the
//   whole block stages a tile of its rows through shared memory with
//   cp.async, coalesced along the depth, double-buffered so the next tile
//   is in flight while one warp walks the current one; each thread writes
//   its starts over the t tile, and the block stores the tile back
//   coalesced.  A block holds up to ROWS rows and a tile holds CAP elements
//   of each array, so a single long row (the Zipf hot server) walks tiles
//   of CAP deep while all THREADS threads load.  The row stride in shared
//   memory is odd, so the threads' reads at one depth hit distinct banks.
// - The chain itself.  A thread walks UNROLL steps at a time in phases
//   (see step()), so that its in-order issue waits only on the two
//   loop-carried chains and not on every operation of a step.
// - Ragged edges.  No padding pass: rows past R are not walked, and a tile
//   past W copies and walks only the elements that exist.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 64;          // threads a block: all load and store
constexpr int ROWS = 32;             // rows a block: one warp walks them
constexpr int CAP = 1024;            // elements of one array in one tile
constexpr int SLOT = CAP + ROWS;     // room for the odd-stride padding
constexpr int UNROLL = 16;           // steps a thread holds in registers

__device__ __forceinline__ double max_first(double a, double b) {
  return a >= b ? a : b;             // numpy's maximum: a on ties
}

// U steps of the recurrence, in order, on one row; the starts overwrite t.
// A warp issues in order, so one step written as a unit would stall on
// each of its six dependent fp64 operations in turn.  Written as phases
// over U elements held in registers, only the c chain (one dependent add a
// step) and the m chain (one dependent max a step) are serial, and the
// compiler fills their stalls with the other elements' independent work.
// The operations and their order per element are unchanged.
template <int U>
__device__ __forceinline__ void step(double* tr, const double* sr,
                                     double& c, double& m) {
  double tv[U], sv[U], pv[U], mv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    tv[u] = tr[u];
    sv[u] = sr[u];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    c = __dadd_rn(c, sv[u]);
    pv[u] = __dsub_rn(c, sv[u]);     // numpy's C - S, not c_{d-1}
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    m = max_first(m, __dsub_rn(tv[u], pv[u]));
    mv[u] = m;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) tr[u] = max_first(tv[u], __dadd_rn(mv[u], pv[u]));
}

__device__ __forceinline__ void copy_async8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy depth [d0, d0 + len) of rows [r0, r0 + rows) of a into tile (row
// stride `stride`), one element a thread a step, consecutive threads on
// consecutive depths.
__device__ __forceinline__ void load_tile(double* tile, const double* a,
                                          long long r0, int rows, long long W,
                                          long long d0, int len, int stride) {
  const int total = rows * len;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int r = e / len, d = e - r * len;
    copy_async8(tile + r * stride + d, a + (r0 + r) * W + d0 + d);
  }
}

__global__ void __launch_bounds__(THREADS)
lindley_kernel(const double* __restrict__ t, const double* __restrict__ s,
               double* __restrict__ out, long long R, long long W) {
  __shared__ double ts[2][SLOT];     // t, then the starts written over it
  __shared__ double ss[2][SLOT];

  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(R - r0 < ROWS ? R - r0 : ROWS);
  const int depth = CAP / rows;      // tile depth, >= CAP / ROWS
  const int stride = depth | 1;      // odd: conflict-free column reads
  const long long tiles = (W + depth - 1) / depth;
  const int me = threadIdx.x;

  double c = 0.0;
  double m = -CUDART_INF;

  auto tile_len = [&](long long k) {
    const long long left = W - k * depth;
    return static_cast<int>(left < depth ? left : depth);
  };

  load_tile(ts[0], t, r0, rows, W, 0, tile_len(0), stride);
  load_tile(ss[0], s, r0, rows, W, 0, tile_len(0), stride);
  commit_async();

  for (long long k = 0; k < tiles; ++k) {
    const int buf = static_cast<int>(k & 1);
    const int len = tile_len(k);
    wait_async<0>();
    __syncthreads();                 // tile k landed; tile k-1 stored
    if (k + 1 < tiles) {
      const int nlen = tile_len(k + 1);
      load_tile(ts[buf ^ 1], t, r0, rows, W, (k + 1) * depth, nlen, stride);
      load_tile(ss[buf ^ 1], s, r0, rows, W, (k + 1) * depth, nlen, stride);
    }
    commit_async();

    if (me < rows) {
      double* tr = ts[buf] + me * stride;
      const double* sr = ss[buf] + me * stride;
      int d = 0;
      for (; d + UNROLL <= len; d += UNROLL) step<UNROLL>(tr + d, sr + d, c, m);
      for (; d < len; ++d) step<1>(tr + d, sr + d, c, m);
    }
    __syncthreads();                 // every row of tile k walked

    const long long d0 = k * depth;
    const int total = rows * len;
    for (int e = me; e < total; e += THREADS) {
      const int r = e / len, d = e - r * len;
      out[(r0 + r) * W + d0 + d] = ts[buf][r * stride + d];
    }
  }
}

}  // namespace

// t, s, out (R, W) row-major float64 on the device.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int lindley_scan(const double* t, const double* s, double* out,
                            long long R, long long W, void* stream) {
  if (R <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (R + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lindley_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(t, s, out, R, W);
  return static_cast<int>(cudaGetLastError());
}
