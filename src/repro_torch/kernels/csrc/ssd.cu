// K8: the Mamba-2 SSD (state-space duality) chunk scan.  For one batch row
// b and head h, with the state S_t a (P, N) matrix, the recurrence
//
//   S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t,   y_t = S_t C_t
//
// (B_t, C_t of the head's group g = h / (H / G)), computed chunk by chunk:
// within a chunk of rows i, j, with cum the running sum of dt * A, cl its
// last value and L_ij = exp(cum_i - cum_j) for j <= i,
//
//   y_i   = sum_{j <= i} L_ij (C_i . B_j) dt_j x_j + exp(cum_i) S_in C_i
//   S_out = exp(cl) S_in + sum_j exp(cl - cum_j) dt_j x_j (outer) B_j
//
// Replaces: src/repro/kernels/ssd.py:87 (ssd_scan, _ssd_kernel), the Pallas
// TPU kernel whose grid is (B*H, chunks), the chunk axis sequential, with
// the (P, N) fp32 state carried across it in VMEM scratch and the two
// products of a chunk on the MXU.
//
// K8b, below, is its gradient.  Both kernels share one design.
//
// What bounds them on the H100: at Mamba-2 370M's layer shape (B 4, S 1024,
// H 32, P 64, G 1, N 128) K8 moves some 40 MB in bf16 (x and y, B and C, dt,
// the fp32 final state), 0.012 ms at 3.35 TB/s, for ~4.9 GFLOP of products
// (0.005 ms on the bf16 tensor cores, 0.073 ms in fp32 FMA): on the tensor
// cores the bytes bound it.  K8b at (8, 1024, 32, 64, 1, 128) reads the
// 134 MB of chunk states K8 kept as well; its ~40 GFLOP bound it in fp32
// FMA (0.6 ms), its bytes (0.036 ms) on the tensor cores.  As measured,
// both kernels run far from either bound, held back by latency with one
// or two blocks an SM (PERF.md, tools/k8_ablate.py).
//
// What the design does about it.
// - The chunks are spread over a thread-block cluster, in one launch.  The
//   grid is (B * H, R, ceil(P / 64)) for K8 and (B * head blocks, R, ...)
//   for K8b, clusters of R <= 8 blocks (the portable size) along y; block
//   k of a cluster takes a run of `run` = ceil(nc / 8) of the nc 64-row
//   chunks (R = ceil(nc / run), so no block is idle).  K8: block k first
//   walks its run from a zero state to its run-local state Loc_k and run
//   decay exponent ld_k (the sum of dt * A over the run), publishes both in
//   its shared memory, and after a cluster barrier the blocks form the
//   states entering every run together, through distributed shared memory:
//   S_in of run k+1 = exp(ld_k) S_in of run k + Loc_k, S_in of run 0 = h0.
//   Block m takes 8-row slices m, m + R, .. of the (64, N) state, reads
//   that slice of every block's Loc, runs the recurrence across the runs
//   and writes slice m of each S_in into the block that walks the run, so
//   each block reads and writes one R-th of the states and the sums run in
//   a fixed order (results the same from run to run).  (Every block
//   reading all its predecessors' whole states, first one load at a time
//   and then batched, left the reads half and then a third of K8's time:
//   a block's shared memory serves remote reads slowly, and all readers
//   queued on the first blocks; tools/k8_ablate.py, PERF.md.)  A second
//   barrier, and each block walks its run again, producing y and, under
//   keep_states, each chunk's entering state.  K8b is the same reversed:
//   block k's run-local Delta_k is the gradient entering its run from a
//   zero gradient leaving it, and the gradient leaving run k - 1 is
//   exp(ld_k) (the gradient leaving run k) + Delta_k, dstate for the last
//   run; the same slices carry it across the blocks.  No (P, N)
//   state passes through device memory but the kept ones.  At the serving
//   shape K8 has 4 * 32 * 8 = 1,024 blocks where it had 128.
// - Every product of a chunk runs on the tensor cores as warp-level
//   mma.sync (m16n8k16 bf16, m16n8k8 TF32), not wgmma: each product is 64
//   rows by 64 or N columns over a depth of 64 or N, a dozen shapes and
//   orientations a chunk (C.B^T, dy.x^T, their transposes, the states as
//   either operand), several of whose A operands are formed in registers
//   from fp32 intermediates (the decay mask applied on the fly, rows and
//   columns scaled), which wgmma would take only through a swizzled
//   shared-memory copy. Eight warps split each product into 16-row by 32- or
//   N/2-column tiles (16 warps with half the tiles ran K8b slower: at 128
//   registers a thread it spilled). K8's products: C.B^T, C.S_in^T, W.x (W =
//   L . CB . dt_j) and the state's (x . w)^T B. K8b's: C.B^T (once for the
//   block's heads), dy.x^T, C.S_in^T, B.G^T, M^T.dy (dx, M = L . CB formed
//   from C.B^T as it is loaded), dy.S_in and (Q . dt).B (dC, Q = L . dy.x^T),
//   x.G and Q^T.C (dB), (exp(cum) dy)^T C (the update of G).
// - Precision.  bf16 inputs (x, dy, B, C) go into bf16 products as they
//   are, with fp32 accumulators.  An fp32 operand takes two products
//   (three where both operands are): the states S_in and G, K8's W and
//   K8b's Q are each held as a State, two bf16 planes hi + lo (16 bits of
//   mantissa) split once when the matrix is written, so that every warp
//   loads them as it loads inputs; the decay- and dt-scaled rows of x and
//   dy and K8b's M^T are split as they are loaded.  The final state's bar,
//   rtol 1e-3 / atol 1e-4 even in bf16, needs the split; no split is
//   dropped.  fp32 inputs (the check paths) run as 3xTF32 (mma.cuh:
//   split_tf32, shared with K1), every operand split as it is loaded.
// - Operand loads: ldmatrix (.trans where k runs down the rows) or 32-bit
//   pairs; each split product passes over four column tiles at a time, so
//   that consecutive mma.sync do not wait on one another.
// - The upper triangle is masked before exp: exp(cum_i - cum_j) for i < j
//   is exp of a positive number and could overflow to inf, and inf * 0 is
//   NaN.
// - Ragged ends: a last chunk shorter than 64 rows, S < 64, P tiles past P,
//   N short of a multiple of 16 are zeros on the load and skipped on the
//   store: zero dt keeps cum flat, zero B, C, x and dy add nothing.
// - Shared memory: bf16 tiles stay bf16, rows padded by 16 bytes so that
//   the fragment loads of a warp hit 32 different banks; loads from device
//   memory are 16 bytes a thread, four in flight, where the rows allow.
//   K8 takes 98,576 bytes a block in bf16 (two blocks an SM), 137,488 in
//   fp32.  K8b stages a chunk's B and C with its first head's x, dy and
//   S_in, and in its Delta walk both heads' dy at once.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;     // 8 warps: 4 blocks of 16 rows x 2 halves
constexpr int T = 64;            // rows of a chunk
constexpr int PT = 64;           // columns of P a block holds
constexpr int MAX_N = 128;       // the widest state
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int LDW = T + 4;       // row stride of the fp32 (T, T) tiles
constexpr int NTN = MAX_N / 16;  // 8-column tiles of a warp's half of N
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

// Tensor-core products by input type: the depth of one product, the
// padding of a row of an input tile (16 bytes), and K8b's heads a block.
template <typename E>
struct Tc;
template <>
struct Tc<bf16> {
  static constexpr int KS = 16;
  static constexpr int PAD = 8;
  static constexpr int HPB = 2;
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    mma_bf16(d, a, b);
  }
};
template <>
struct Tc<float> {
  static constexpr int KS = 8;
  static constexpr int PAD = 4;
  static constexpr int HPB = 1;
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    mma_tf32(d, a, b);
  }
};

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// ---- operand sources --------------------------------------------------------
// Element (i0, i1) of an A operand is (row, k), of a B operand (k, column).
// at() is its fp32 value.  An EXACT source holds bf16 values that enter a
// bf16 product as they are and hands over its fragment registers directly
// (frag_a, frag_b); a Split source holds an fp32 matrix as two such bf16
// planes, hi and lo.

// (i0, i1) at p[i0 * ld + i1].
template <typename V>
struct Rm {
  const V* p;
  int ld;
  static constexpr bool EXACT = std::is_same<V, bf16>::value;
  __device__ __forceinline__ float at(int i0, int i1) const {
    return to_f32(p[i0 * ld + i1]);
  }
  // A: k runs along the rows, pairs of k adjacent
  __device__ __forceinline__ void frag_a(int r0, int k0,
                                         uint32_t (&a)[4]) const {
    const int lane = threadIdx.x & 31;
    const V* q = p + (r0 + lane / 4) * ld + k0 + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const uint32_t*>(q + 8 * (r & 1) * ld +
                                                8 * (r >> 1));
  }
  // B: k runs down the rows, so the fragment is loaded transposed
  __device__ __forceinline__ void frag_b(int k0, int n0,
                                         uint32_t (&b)[2]) const {
    ldsm_b_trans(b, smem_u32(p + (k0 + (threadIdx.x & 15)) * ld + n0));
  }
};

// (i0, i1) at p[i1 * ld + i0].
template <typename V>
struct Cm {
  const V* p;
  int ld;
  static constexpr bool EXACT = std::is_same<V, bf16>::value;
  __device__ __forceinline__ float at(int i0, int i1) const {
    return to_f32(p[i1 * ld + i0]);
  }
  // A: k runs down the rows, so the fragment is loaded transposed
  __device__ __forceinline__ void frag_a(int r0, int k0,
                                         uint32_t (&a)[4]) const {
    const int lane = threadIdx.x & 31;
    ldsm_a_trans(a, smem_u32(p + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld +
                             r0 + 8 * ((lane >> 3) & 1)));
  }
  // B: (k, n) and (k + 1, n) adjacent
  __device__ __forceinline__ void frag_b(int k0, int n0,
                                         uint32_t (&b)[2]) const {
    const int lane = threadIdx.x & 31;
    const V* q = p + (n0 + lane / 4) * ld + k0 + 2 * (lane % 4);
    b[0] = *reinterpret_cast<const uint32_t*>(q);
    b[1] = *reinterpret_cast<const uint32_t*>(q + 8);
  }
};

// An fp32 matrix as two exact bf16 planes, v = hi + lo.
template <class Src>
struct Split {
  Src hi, lo;
  static constexpr bool EXACT = false;
};
template <class Src>
constexpr bool kSplit = false;
template <class Src>
constexpr bool kSplit<Split<Src>> = true;

// A source scaled by v[i0] (BY_I0) or v[i1].
template <class Src, bool BY_I0>
struct Scaled {
  Src s;
  const float* v;
  static constexpr bool EXACT = false;
  __device__ __forceinline__ float at(int i0, int i1) const {
    return s.at(i0, i1) * v[BY_I0 ? i0 : i1];
  }
};

// K8b's M^T: (t, i) = exp(cum_i - cum_t) (C_i . B_t) for i >= t, else 0,
// from C.B^T in an fp32 (T, LDW) tile.
struct DecayT {
  const float* cb;
  const float* cum;
  static constexpr bool EXACT = false;
  __device__ __forceinline__ float at(int t, int i) const {
    return i >= t ? expf(cum[i] - cum[t]) * cb[i * LDW + t] : 0.0f;
  }
};

// A (64, cols) fp32 matrix that enters products (the states S_in and G,
// K8's W, K8b's Q): in bf16 two bf16 planes, hi and lo, split once when
// the matrix is written so that products load them as they load inputs;
// in fp32 one fp32 plane, split as it is loaded.  Rows padded by 16 bytes.
template <typename E>
struct State;
template <>
struct State<bf16> {
  bf16* hi;
  bf16* lo;
  int ld;
  __device__ __forceinline__ State(void* base, int cols)
      : hi(static_cast<bf16*>(base)), lo(hi + T * (cols + 8)), ld(cols + 8) {}
  __host__ __device__ static constexpr int bytes(int cols) {
    return 4 * T * (cols + 8);
  }
  __device__ __forceinline__ Split<Rm<bf16>> rm() const {
    return {{hi, ld}, {lo, ld}};
  }
  __device__ __forceinline__ Split<Cm<bf16>> cm() const {
    return {{hi, ld}, {lo, ld}};
  }
  __device__ __forceinline__ float2 get2(int r, int c) const {
    const float2 h = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(hi + r * ld + c));
    const float2 l = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(lo + r * ld + c));
    return make_float2(h.x + l.x, h.y + l.y);
  }
  __device__ __forceinline__ void put2(int r, int c, float v0,
                                       float v1) const {
    uint32_t h, l;
    split_bf16x2(v0, v1, h, l);
    *reinterpret_cast<uint32_t*>(hi + r * ld + c) = h;
    *reinterpret_cast<uint32_t*>(lo + r * ld + c) = l;
  }
};
template <>
struct State<float> {
  float* p;
  int ld;
  __device__ __forceinline__ State(void* base, int cols)
      : p(static_cast<float*>(base)), ld(cols + 4) {}
  __host__ __device__ static constexpr int bytes(int cols) {
    return 4 * T * (cols + 4);
  }
  __device__ __forceinline__ Rm<float> rm() const { return {p, ld}; }
  __device__ __forceinline__ Cm<float> cm() const { return {p, ld}; }
  __device__ __forceinline__ float2 get2(int r, int c) const {
    return *reinterpret_cast<const float2*>(p + r * ld + c);
  }
  __device__ __forceinline__ void put2(int r, int c, float v0,
                                       float v1) const {
    *reinterpret_cast<float2*>(p + r * ld + c) = make_float2(v0, v1);
  }
};

template <typename E, class Src>
__device__ __forceinline__ void load_a(const Src& s, int r0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kSplit<Src>) {
    s.hi.frag_a(r0, k0, hi);
    s.lo.frag_a(r0, k0, lo);
  } else if constexpr (!std::is_same<E, float>::value && Src::EXACT) {
    s.frag_a(r0, k0, hi);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + g + 8 * (q & 1);
      if constexpr (std::is_same<E, float>::value) {
        split_tf32(__float_as_uint(s.at(r, k0 + t + 4 * (q >> 1))), hi[q],
                   lo[q]);
      } else {
        const int k = k0 + 2 * t + 8 * (q >> 1);
        split_bf16x2(s.at(r, k), s.at(r, k + 1), hi[q], lo[q]);
      }
    }
  }
}

template <typename E, class Src>
__device__ __forceinline__ void load_b(const Src& s, int k0, int n0,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kSplit<Src>) {
    s.hi.frag_b(k0, n0, hi);
    s.lo.frag_b(k0, n0, lo);
  } else if constexpr (std::is_same<E, float>::value) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      split_tf32(__float_as_uint(s.at(k0 + t + 4 * q, n0 + g)), hi[q], lo[q]);
  } else if constexpr (Src::EXACT) {
    s.frag_b(k0, n0, hi);
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = k0 + 2 * t + 8 * q;
      split_bf16x2(s.at(k, n0 + g), s.at(k + 1, n0 + g), hi[q], lo[q]);
    }
  }
}

// acc[j] (rows r0 .. r0 + 15, columns n0 + 8 j ..) += A . B over k in
// [0, K), for j < nt (warp-uniform); K a multiple of the product's depth.
// A split operand adds the product of its lo part: lo.hi, hi.lo, hi.hi,
// each pass over four column tiles at a time, so that a product does not
// wait on the one before it.
template <typename E, int NT, class SA, class SB>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const SA& a,
                                     const SB& b, int r0, int n0, int K,
                                     int nt) {
  constexpr bool F32 = std::is_same<E, float>::value;
  constexpr bool ALO = F32 || !SA::EXACT, BLO = F32 || !SB::EXACT;
  constexpr int NG = NT < 4 ? NT : 4;
  for (int k0 = 0; k0 < K; k0 += Tc<E>::KS) {
    uint32_t ah[4], al[4];
    load_a<E>(a, r0, k0, ah, al);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += NG) {
      if (j0 < nt) {
        uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
        for (int u = 0; u < NG; ++u)
          if (j0 + u < nt) load_b<E>(b, k0, n0 + 8 * (j0 + u), bh[u], bl[u]);
        if constexpr (ALO) {
#pragma unroll
          for (int u = 0; u < NG; ++u)
            if (j0 + u < nt) Tc<E>::mma(acc[j0 + u], al, bh[u]);
        }
        if constexpr (BLO) {
#pragma unroll
          for (int u = 0; u < NG; ++u)
            if (j0 + u < nt) Tc<E>::mma(acc[j0 + u], ah, bl[u]);
        }
#pragma unroll
        for (int u = 0; u < NG; ++u)
          if (j0 + u < nt) Tc<E>::mma(acc[j0 + u], ah, bh[u]);
      }
    }
  }
}

// Accumulator element q of a 16 x 8 tile: row and column within the tile.
__device__ __forceinline__ int frag_row(int q) {
  return ((threadIdx.x & 31) >> 2) + 8 * (q >> 1);
}
__device__ __forceinline__ int frag_col(int q) {
  return 2 * (threadIdx.x & 3) + (q & 1);
}

template <int NT>
__device__ __forceinline__ void zero(float (&f)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) f[j][q] = 0.0f;
}

template <int NT>
__device__ __forceinline__ void scale(float (&f)[NT][4], float s) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) f[j][q] *= s;
}

// A warp's tiles (rows r0 .., columns n0 + 8 j ..) to and from an fp32
// shared tile of row stride ld, two columns at a time.
template <int NT>
__device__ __forceinline__ void frag_store(const float (&f)[NT][4], float* t,
                                           int ld, int r0, int n0, int nt) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2)
        *reinterpret_cast<float2*>(t + (r0 + frag_row(q)) * ld + n0 + 8 * j +
                                   frag_col(q)) =
            make_float2(f[j][q], f[j][q + 1]);
}
template <int NT>
__device__ __forceinline__ void frag_load(float (&f)[NT][4], const float* t,
                                          int ld, int r0, int n0, int nt) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const float2 v = *reinterpret_cast<const float2*>(
            t + (r0 + frag_row(q)) * ld + n0 + 8 * j + frag_col(q));
        f[j][q] = v.x;
        f[j][q + 1] = v.y;
      }
}

// A warp's tiles to and from a State, two columns at a time.
template <typename E, int NT>
__device__ __forceinline__ void frag_put(const float (&f)[NT][4],
                                         const State<E>& s, int r0, int n0,
                                         int nt) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2)
        s.put2(r0 + frag_row(q), n0 + 8 * j + frag_col(q), f[j][q],
               f[j][q + 1]);
}
template <typename E, int NT>
__device__ __forceinline__ void frag_get(float (&f)[NT][4], const State<E>& s,
                                         int r0, int n0, int nt) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const float2 v = s.get2(r0 + frag_row(q), n0 + 8 * j + frag_col(q));
        f[j][q] = v.x;
        f[j][q + 1] = v.y;
      }
}

// A thread's 16-byte chunks of a (PT, NP) fp32 matrix, chunk e = tid +
// THREADS u at row e / (NP / 4), columns 4 (e % (NP / 4)) ..: the layout in
// which a cluster's published states are summed.
constexpr int CHQ = PT * MAX_N / 4 / THREADS;

// From a (P, N) fp32 matrix in device memory, rows from src's, `rows` of
// them real (zeros elsewhere, and everywhere for a null src).
__device__ __forceinline__ void chunk_gload(float4 (&acc)[CHQ],
                                            const float* src, int N, int rows,
                                            int NP) {
  const int cpr = NP / 4;
#pragma unroll
  for (int u = 0; u < CHQ; ++u) {
    const int e = threadIdx.x + THREADS * u, r = e / cpr,
              n = (e - r * cpr) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (src != nullptr && e < PT * cpr && r < rows)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N) v[c] = src[static_cast<long long>(r) * N + n + c];
    acc[u] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The same chunks from an fp32 shared tile of row stride ld.
__device__ __forceinline__ void chunk_sload(float4 (&acc)[CHQ], const float* t,
                                            int ld, int NP) {
  const int cpr = NP / 4;
#pragma unroll
  for (int u = 0; u < CHQ; ++u) {
    const int c = threadIdx.x + THREADS * u, r = c / cpr;
    if (c < PT * cpr)
      acc[u] = *reinterpret_cast<const float4*>(t + r * ld + (c - r * cpr) * 4);
  }
}

// The states entering (K8, FWD) or the gradients leaving (K8b) the runs of
// a cluster's R blocks, from the run-local ones each block published: an
// fp32 tile `pubt` (row stride ld) and its decay exponent *pubv, at the
// same shared addresses in every block.  This block takes the slices of 8
// rows s = rank, rank + R, ..: it reads slice s of every block's tile, runs
// the recurrence across the blocks in order (K8: X_0 = init, X_{k+1} =
// exp(ld_k) X_k + Loc_k; K8b: X_{R-1} = init, X_{k-1} = exp(ld_k) X_k +
// Delta_k) and writes slice s of X_k into block k's tile `land`.  Each
// block so reads and writes one R-th of the states: no block's shared
// memory serves more than its share, where every block reading all its
// predecessors' whole states left the readers queued on the first ones.
// init: the (P, N) fp32 matrix from row p0 (h0 or dstate), `rows` of its
// rows real, or null for zeros.  Cluster barriers bracket it.
template <bool FWD>
__device__ __forceinline__ void cluster_scan(const float* pubt,
                                             const float* pubv, float* land,
                                             int ld, int NP, int rank, int R,
                                             const float* init, int N,
                                             int rows) {
  const int cpr = NP / 4, e = threadIdx.x, i = e / cpr,
            n = (e - i * cpr) * 4;
  if (e >= 8 * cpr) return;
  for (int s = rank; s < PT / 8; s += R) {
    const int r = 8 * s + i;
    const uint32_t src = smem_u32(pubt + r * ld + n);
    float4 v[MAX_CLUSTER];
    float lds[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < R) {
        v[k] = ld_cluster16(src, k);
        lds[k] = ld_cluster4(smem_u32(pubv), k);
      }
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (init != nullptr && r < rows)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N) x[c] = init[static_cast<long long>(r) * N + n + c];
    float4 acc = make_float4(x[0], x[1], x[2], x[3]);
    const uint32_t dst = smem_u32(land + r * ld + n);
#pragma unroll
    for (int kk = 0; kk < MAX_CLUSTER; ++kk) {
      const int k = FWD ? kk : MAX_CLUSTER - 1 - kk;
      if (k < R) {
        st_cluster16(dst, k, acc);
        const float d = expf(lds[k]);
        acc.x = fmaf(d, acc.x, v[k].x);
        acc.y = fmaf(d, acc.y, v[k].y);
        acc.z = fmaf(d, acc.z, v[k].z);
        acc.w = fmaf(d, acc.w, v[k].w);
      }
    }
  }
}

template <typename E>
__device__ __forceinline__ void chunk_put(const float4 (&acc)[CHQ],
                                          const State<E>& s, int NP) {
  const int cpr = NP / 4;
#pragma unroll
  for (int u = 0; u < CHQ; ++u) {
    const int c = threadIdx.x + THREADS * u, r = c / cpr,
              n = (c - r * cpr) * 4;
    if (c < PT * cpr) {
      s.put2(r, n, acc[u].x, acc[u].y);
      s.put2(r, n + 2, acc[u].z, acc[u].w);
    }
  }
}

// A warp's tiles of a (P, N) fp32 matrix in device memory, rows from the
// tile's first (`src` points at it), `rows` and `cols` of them real:
// loaded (zeros elsewhere, and everywhere for a null src) or stored.
template <int NT>
__device__ __forceinline__ void frag_gload(float (&f)[NT][4], const float* src,
                                           int N, int rows, int r0, int n0,
                                           int nt) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + frag_row(q), n = n0 + 8 * j + frag_col(q);
        f[j][q] = (src != nullptr && r < rows && n < N)
                      ? src[static_cast<long long>(r) * N + n]
                      : 0.0f;
      }
}
template <int NT>
__device__ __forceinline__ void frag_gstore(const float (&f)[NT][4],
                                            float* dst, long long rstride,
                                            int N, int rows, int r0, int n0,
                                            int nt) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int r = r0 + frag_row(q), n = n0 + 8 * j + frag_col(q);
        if (r >= rows || n >= N) continue;
        float* d = dst + r * rstride + n;
        if (n + 1 < N && (N % 2) == 0) {
          *reinterpret_cast<float2*>(d) = make_float2(f[j][q], f[j][q + 1]);
        } else {
          d[0] = f[j][q];
          if (n + 1 < N) d[1] = f[j][q + 1];
        }
      }
}

// Two adjacent elements of an output row, of which the first `n` exist;
// one store where `vec` (the row's elements aligned in pairs).
template <typename E>
__device__ __forceinline__ void store2(E* d, float v0, float v1, int n,
                                       bool vec) {
  if (vec && n >= 2) {
    if constexpr (std::is_same<E, float>::value)
      *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (n > 0) d[0] = from_f32<E>(v0);
    if (n > 1) d[1] = from_f32<E>(v1);
  }
}

// Rows [0, T) x columns [0, width) of a shared tile (row stride ld): row i
// from src + i * rstride, its first `cols` elements for i < rows, zeros
// elsewhere.  16 bytes a thread, four loads in flight before their stores;
// whole 16-byte loads where `vec` (cols and rstride whole 16-byte chunks,
// src 16-byte aligned).
template <typename V>
__device__ __forceinline__ void stage(V* tile, int ld, const V* src,
                                      long long rstride, int rows, int cols,
                                      int width, bool vec) {
  constexpr int VEC = 16 / sizeof(V);
  const int cpr = width / VEC, n = T * cpr;
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * THREADS) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS, i = e / cpr, c = (e - i * cpr) * VEC;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n && i < rows && c < cols) {
        const V* s = src + i * rstride + c;
        v[u] = vec ? ldg16(s) : ld_chunk(s, cols - c);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS, i = e / cpr, c = (e - i * cpr) * VEC;
      if (e < n) *reinterpret_cast<uint4*>(tile + i * ld + c) = v[u];
    }
  }
}

// The same in two halves, for Q chunks a thread of a tile (T * width
// elements of V, 16 bytes a chunk, chunk e = tid + THREADS (u0 + u)): the
// loads into registers, so that other work runs while they are in flight,
// then the stores.
template <typename V, int Q>
__device__ __forceinline__ void tile_load(uint4 (&v)[Q], const V* src,
                                          long long rstride, int rows,
                                          int cols, int width, bool vec,
                                          int u0 = 0) {
  constexpr int VEC = 16 / sizeof(V);
  const int cpr = width / VEC;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int e = threadIdx.x + (u0 + u) * THREADS, i = e / cpr,
              c = (e - i * cpr) * VEC;
    v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (e < T * cpr && i < rows && c < cols) {
      const V* s = src + i * rstride + c;
      v[u] = vec ? ldg16(s) : ld_chunk(s, cols - c);
    }
  }
}
template <typename V, int Q>
__device__ __forceinline__ void tile_store(const uint4 (&v)[Q], V* tile,
                                           int ld, int width) {
  constexpr int VEC = 16 / sizeof(V);
  const int cpr = width / VEC;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int e = threadIdx.x + u * THREADS, i = e / cpr,
              c = (e - i * cpr) * VEC;
    if (e < T * cpr) *reinterpret_cast<uint4*>(tile + i * ld + c) = v[u];
  }
}
// An fp32 (T, NP) tile loaded by tile_load<float> into a State: split once,
// in bf16.
template <typename E, int Q>
__device__ __forceinline__ void state_store(const uint4 (&v)[Q],
                                            const State<E>& st, int NP,
                                            int u0 = 0) {
  const int cpr = NP / 4;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int e = threadIdx.x + (u0 + u) * THREADS, i = e / cpr,
              c = (e - i * cpr) * 4;
    if (e < T * cpr) {
      st.put2(i, c, __uint_as_float(v[u].x), __uint_as_float(v[u].y));
      st.put2(i, c + 2, __uint_as_float(v[u].z), __uint_as_float(v[u].w));
    }
  }
}

// Warp `w`: dt of a chunk's rows (dtc[i * H], zeros from row `len`), cum
// its running sum times a, ecum = exp(cum), el = exp(cl - cum) with cl
// cum's last value, and wv = dt el.
// dt_load is its loads (rows lane and lane + 32), dt_scan the rest.
__device__ __forceinline__ float2 dt_load(const float* dtc, int H, int len) {
  const int l = threadIdx.x & 31;
  return make_float2(
      l < len ? dtc[static_cast<long long>(l) * H] : 0.0f,
      l + 32 < len ? dtc[static_cast<long long>(l + 32) * H] : 0.0f);
}
__device__ __forceinline__ void dt_scan(float2 d, float a, float* dts,
                                        float* cum, float* ecum, float* el,
                                        float* wv) {
  const int l = threadIdx.x & 31;
  const float d0 = d.x, d1 = d.y;
  float v0 = d0 * a, v1 = d1 * a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(FULL, v0, off);
    const float u1 = __shfl_up_sync(FULL, v1, off);
    if (l >= off) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(FULL, v0, 31);
  const float cl = __shfl_sync(FULL, v1, 31);
  dts[l] = d0;
  dts[l + 32] = d1;
  cum[l] = v0;
  cum[l + 32] = v1;
  ecum[l] = expf(v0);
  ecum[l + 32] = expf(v1);
  const float e0 = expf(cl - v0), e1 = expf(cl - v1);
  el[l] = e0;
  el[l + 32] = e1;
  wv[l] = d0 * e0;
  wv[l + 32] = d1 * e1;
}
__device__ __forceinline__ void stage_dt(const float* dtc, int H, int len,
                                         float a, float* dts, float* cum,
                                         float* ecum, float* el, float* wv,
                                         int w = 0) {
  if (static_cast<int>(threadIdx.x >> 5) != w) return;
  dt_scan(dt_load(dtc, H, len), a, dts, cum, ecum, el, wv);
}

// The cluster: R blocks, each a run of `run` chunks.
__host__ __device__ inline void plan(int S, int& R, int& run) {
  const int nc = (S + T - 1) / T;
  run = (nc + MAX_CLUSTER - 1) / MAX_CLUSTER;
  R = (nc + run - 1) / run;
}

// ============================ K8: the forward ================================

struct FwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;
  void* y;
  float* hout;
  float* states;
  int S, H, P, G, N, run;
  int vec_bc;   // N a whole number of 16-byte chunks, B and C aligned
  int vec_x;    // P likewise, x and y aligned
};

template <typename E>
__host__ __device__ constexpr int fwd_smem_bytes(int N) {
  return State<E>::bytes(pad16(N)) + State<E>::bytes(T) + 4 * (5 * T + 4) +
         static_cast<int>(sizeof(E)) * T *
             (2 * (pad16(N) + Tc<E>::PAD) + PT + Tc<E>::PAD);
}

template <typename E>
__global__ void __launch_bounds__(THREADS, sizeof(E) == 2 ? 2 : 1)
ssd_kernel(const FwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, H = p.H, P = p.P, G = p.G, N = p.N, NP = pad16(N);
  const int ldf = NP + 4, lde = NP + Tc<E>::PAD, ldx = PT + Tc<E>::PAD;
  unsigned char* at = smem;
  const State<E> Ss(at, NP);                    // the state entering a chunk
  float* pubt = reinterpret_cast<float*>(at);   // first: Loc, (PT, ldf)
  at += State<E>::bytes(NP);
  const State<E> Ws(at, T);                     // L . CB . dt_j
  at += State<E>::bytes(T);
  float* cum = reinterpret_cast<float*>(at);    // (T,) each
  float* dts = cum + T;
  float* ecum = dts + T;
  float* el = ecum + T;
  float* wv = el + T;
  float* pub = wv + T;                          // [0] the run's ld
  E* Bs = reinterpret_cast<E*>(pub + 4);        // (T, lde)
  E* Cs = Bs + T * lde;                         // (T, lde)
  E* xs = Cs + T * lde;                         // (T, ldx)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int r16 = 16 * (warp & 3);          // the warp's 16 rows
  const int c32 = 32 * (warp >> 2);         // its columns of a (., 64)
  const int sn0 = (warp >> 2) * (NP / 2);   // and of a (., N) product
  const int nts = NP / 16;
  const int rank = blockIdx.y, R = gridDim.y;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int grp = h / (H / G);
  const int p0 = blockIdx.z * PT, pv = min(PT, P - p0);
  const int nc = (S + T - 1) / T;
  const int c_lo = rank * p.run, c_hi = min(nc, c_lo + p.run);
  const float a = p.A[h];

  const long long xrow = static_cast<long long>(H) * P;
  const long long brow = static_cast<long long>(G) * N;
  const long long xoff = static_cast<long long>(b) * S * xrow +
                         static_cast<long long>(h) * P + p0;
  const long long boff = static_cast<long long>(b) * S * brow +
                         static_cast<long long>(grp) * N;
  const E* xb = static_cast<const E*>(p.x) + xoff;
  E* yb = static_cast<E*>(p.y) + xoff;
  const E* Bb = static_cast<const E*>(p.Bm) + boff;
  const E* Cb = static_cast<const E*>(p.Cm) + boff;
  const float* dtb = p.dt + static_cast<long long>(b) * S * H + h;
  const long long hoff = (static_cast<long long>(b) * H + h) * P * N +
                         static_cast<long long>(p0) * N;
  const float* h0 = p.h0 == nullptr ? nullptr : p.h0 + hoff;

  // the state: rows r16 .. of the P tile, columns sn0 + 8 j .. of N
  float st[NTN][4];

  auto stage_chunk = [&](int c, bool with_c) {
    const int r0 = c * T, len = min(T, S - r0);
    stage<E>(Bs, lde, Bb + r0 * brow, brow, len, N, NP, p.vec_bc);
    if (with_c) stage<E>(Cs, lde, Cb + r0 * brow, brow, len, N, NP, p.vec_bc);
    stage<E>(xs, ldx, xb + r0 * xrow, xrow, len, pv, PT, p.vec_x);
    stage_dt(dtb + static_cast<long long>(r0) * H, H, len, a, dts, cum, ecum,
             el, wv);
    __syncthreads();
    return len;
  };
  // st = exp(cl) st + (x w)^T B over the staged chunk
  auto update_state = [&]() {
    scale(st, ecum[T - 1]);
    gemm<E>(st, Scaled<Cm<E>, false>{{xs, ldx}, wv}, Rm<E>{Bs, lde}, r16, sn0,
            T, nts);
  };

  // ---- the state entering the run --------------------------------------
  if (R > 1) {
    zero(st);
    float ld = 0.0f;
    if (rank < R - 1) {   // the last run's local state is nobody's
      for (int c = c_lo; c < c_hi; ++c) {
        stage_chunk(c, false);
        update_state();
        ld += cum[T - 1];
        __syncthreads();
      }
    }
    frag_store(st, pubt, ldf, r16, sn0, nts);
    if (tid == 0) pub[0] = ld;
    cluster_sync();
    float* land = reinterpret_cast<float*>(Bs);   // B's and C's, idle here
    cluster_scan<true>(pubt, pub, land, ldf, NP, rank, R, h0, N, pv);
    cluster_sync();   // every slice written, every published tile read
    frag_load(st, land, ldf, r16, sn0, nts);
    __syncthreads();   // before B, C and the state's planes are written
  } else {
    frag_gload(st, h0, N, pv, r16, sn0, nts);
  }

  // ---- the run: y, the kept states, the state leaving it ---------------
  for (int c = c_lo; c < c_hi; ++c) {
    const int r0 = c * T;
    frag_put(st, Ss, r16, sn0, nts);
    if (p.states != nullptr)
      frag_gstore(st,
                  p.states + ((static_cast<long long>(b) * H + h) * nc + c) *
                                 P * N + static_cast<long long>(p0) * N,
                  N, N, pv, r16, sn0, nts);
    const int len = stage_chunk(c, true);
    {   // W = L . CB . dt_j
      float cb[4][4];
      zero(cb);
      gemm<E>(cb, Rm<E>{Cs, lde}, Cm<E>{Bs, lde}, r16, c32, NP, 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = r16 + frag_row(q), k = c32 + 8 * j + frag_col(q);
          cb[j][q] = k <= i ? expf(cum[i] - cum[k]) * cb[j][q] * dts[k] : 0.0f;
        }
      frag_put(cb, Ws, r16, c32, 4);
    }
    float ya[4][4];
    zero(ya);
    gemm<E>(ya, Rm<E>{Cs, lde}, Ss.cm(), r16, c32, NP, 4);
    __syncthreads();   // W complete
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) ya[j][q] *= ecum[r16 + frag_row(q)];
    gemm<E>(ya, Ws.rm(), Rm<E>{xs, ldx}, r16, c32, T, 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int i = r16 + frag_row(q), k = c32 + 8 * j + frag_col(q);
        if (i < len)
          store2(yb + (r0 + i) * xrow + k, ya[j][q], ya[j][q + 1], pv - k,
                 p.vec_x);
      }
    if (c + 1 < c_hi || rank == R - 1) update_state();
    __syncthreads();
  }
  if (rank == R - 1) frag_gstore(st, p.hout + hoff, N, N, pv, r16, sn0, nts);
}

// ============================ K8b: the gradient ==============================
//
// The gradient of K8, what torch.autograd.grad of ssd_scan_plain computes.
// No TPU kernel has a backward: the JAX package differentiates the pure-jnp
// src/repro/models/layers.py:298 ssd_chunked.
//
// Per (b, h), with a_t = exp(dt_t A_h), S_t = a_t S_{t-1} + dt_t x_t B_t^T,
// S_{-1} = h0, y_t = S_t C_t, and G the gradient of the loss in the state
// leaving a chunk (dstate for the last), the chunk form of the reverse walk
// (cum, cl, L as in K8, S_in the state entering the chunk from K8's kept
// states, G_out the gradient leaving it):
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
// Beyond K8's design: a block takes HPB heads of one group (2 in bf16, 1 in
// fp32, for shared memory: each head's G is a (64, N) fp32 tile), loads a
// chunk's B and C and computes C.B^T once for them, and sums dB and dC over
// its heads in registers; they leave as (nPT, B, S, H / HPB, N) fp32
// partials that the wrapper sums in a fixed order.  ddt leaves per P tile,
// dA per P tile and chunk; dx and dh0 need no sum.  The rows and columns of
// R' are sums within each warp's tiles by shuffles, then over the warps
// through shared memory; the reverse sum of dcum is one warp's suffix scan.
// 197,440 bytes of shared memory a block in bf16, 208,704 in fp32: one
// block an SM, no room for double buffers; and at 255 registers a thread,
// loads held in registers ahead of their use spilled and ran slower
// (PERF.md), so a head's loads are staged as it starts.

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* states;
  const void* dy;
  const float* dstate;
  void* dx;
  float* ddt_p;
  float* dA_p;
  float* dB_p;
  float* dC_p;
  float* dh0;
  int Bsz, S, H, P, G, N, run;
  int vec_bc;   // N a whole number of 16-byte chunks, B and C aligned
  int vec_x;    // P likewise, x, dy and dx aligned
  int vec_s;    // N % 4 == 0, states aligned
};

template <typename E>
__host__ __device__ constexpr int bwd_smem_bytes(int N) {
  return (Tc<E>::HPB + 1) * State<E>::bytes(pad16(N)) + 4 * T * LDW +
         State<E>::bytes(T) + 4 * (15 * T + 16) +
         static_cast<int>(sizeof(E)) * T *
             (2 * (pad16(N) + Tc<E>::PAD) + 2 * (PT + Tc<E>::PAD));
}

template <typename E>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_kernel(const BwdArgs p) {
  constexpr int HPB = Tc<E>::HPB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, H = p.H, P = p.P, G = p.G, N = p.N, NP = pad16(N);
  const int ldf = NP + 4, lde = NP + Tc<E>::PAD, ldx = PT + Tc<E>::PAD;
  const int sbytes = State<E>::bytes(NP);
  // G of head q at smem + q * sbytes (first: its Delta, an fp32 (PT, ldf)
  // tile), then S_in, C.B^T (fp32), Q . dt_j (Q = L . dy.x^T)
  auto Gst = [&](int q) { return State<E>(smem + q * sbytes, NP); };
  auto Gpub = [&](int q) {
    return reinterpret_cast<float*>(smem + q * sbytes);
  };
  unsigned char* at = smem + HPB * sbytes;
  const State<E> Ss(at, NP);
  at += sbytes;
  float* CBs = reinterpret_cast<float*>(at);    // (T, LDW)
  at += 4 * T * LDW;
  const State<E> Qs(at, T);
  at += State<E>::bytes(T);
  float* cum = reinterpret_cast<float*>(at);    // (T,) each
  float* dts = cum + T;
  float* ecum = dts + T;
  float* el = ecum + T;
  float* wv = el + T;
  float* rowp = wv + T;                         // (2, T) rows of R' dt
  float* colp = rowp + 2 * T;                   // (4, T) columns of R'
  float* vp = colp + 4 * T;                     // (2, T) v
  float* up = vp + 2 * T;                       // (2, T) u
  float* red = up + 2 * T;                      // (8,) <G, S_in> a warp
  float* pub = red + 8;                         // (HPB,) each head's ld
  E* Bs = reinterpret_cast<E*>(pub + 8);        // (T, lde)
  E* Cs = Bs + T * lde;                         // (T, lde)
  E* xs = Cs + T * lde;                         // (T, ldx)
  E* dys = xs + T * ldx;                        // (T, ldx)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = warp & 3, ch = warp >> 2;
  const int r16 = 16 * rb, c32 = 32 * ch, sn0 = ch * (NP / 2);
  const int nts = NP / 16;
  const int rank = blockIdx.y, R = gridDim.y;
  const int HG = H / G, HBG = (HG + HPB - 1) / HPB, HB = G * HBG;
  const int hb = blockIdx.x % HB, b = blockIdx.x / HB;
  const int grp = hb / HBG, hfirst = grp * HG + (hb % HBG) * HPB;
  const int nh = min(HPB, HG - (hb % HBG) * HPB);
  const int pt = blockIdx.z, p0 = pt * PT, pv = min(PT, P - p0);
  const int nc = (S + T - 1) / T;
  const int c_lo = rank * p.run, c_hi = min(nc, c_lo + p.run);

  const long long xrow = static_cast<long long>(H) * P;
  const long long brow = static_cast<long long>(G) * N;
  const long long boff = static_cast<long long>(b) * S * brow +
                         static_cast<long long>(grp) * N;
  const E* Bb = static_cast<const E*>(p.Bm) + boff;
  const E* Cb = static_cast<const E*>(p.Cm) + boff;
  // (b, h, p0) of x, dy, dx; of h0-shaped tensors
  auto xo = [&](int h) {
    return static_cast<long long>(b) * S * xrow +
           static_cast<long long>(h) * P + p0;
  };
  auto ho = [&](int h) {
    return (static_cast<long long>(b) * H + h) * P * N +
           static_cast<long long>(p0) * N;
  };

  // A head's x, dy and dt in chunk c, loaded into registers (the dt by
  // warp 0), then stored (dt: its scan); and its S_in.
  constexpr int XQ = T * PT * static_cast<int>(sizeof(E)) / 16 / THREADS;
  constexpr int SQ = T * MAX_N * 4 / 16 / THREADS;
  uint4 rx[XQ], rd[XQ];
  float2 rdt = make_float2(0.0f, 0.0f);
  auto head_load = [&](int q, int c) {
    const int h = hfirst + q, r0 = c * T, len = min(T, S - r0);
    const long long o = xo(h) + r0 * xrow;
    tile_load(rd, static_cast<const E*>(p.dy) + o, xrow, len, pv, PT,
              p.vec_x);
    tile_load(rx, static_cast<const E*>(p.x) + o, xrow, len, pv, PT,
              p.vec_x);
    if (warp == 0)
      rdt = dt_load(p.dt + static_cast<long long>(b) * S * H +
                        static_cast<long long>(r0) * H + h,
                    H, len);
  };
  auto head_store = [&](int q) {
    tile_store(rd, dys, ldx, PT);
    tile_store(rx, xs, ldx, PT);
    if (warp == 0) dt_scan(rdt, p.A[hfirst + q], dts, cum, ecum, el, wv);
  };
  auto state_stage = [&](int q, int c) {
    const float* src =
        p.states + ((static_cast<long long>(b) * H + hfirst + q) * nc + c) *
                       P * N + static_cast<long long>(p0) * N;
    for (int i = 0; i < SQ; i += 4) {   // four 16-byte loads in flight
      uint4 v[4];
      tile_load(v, src, N, pv, N, NP, p.vec_s, i);
      state_store(v, Ss, NP, i);
    }
  };

  // ---- G leaving the run, for each head ---------------------------------
  {
    auto dst0 = [&](int q) {   // dstate of head q, or null
      return q < nh && p.dstate != nullptr ? p.dstate + ho(hfirst + q)
                                           : nullptr;
    };
    if (R > 1) {
      float ld[HPB];
      float gacc[HPB][NTN][4];
#pragma unroll
      for (int q = 0; q < HPB; ++q) {
        ld[q] = 0.0f;
        zero(gacc[q]);
      }
      if (rank > 0) {   // the first run's Delta is nobody's
        // the heads' dy and dt of a chunk staged at once: head q's dy in
        // dys or xs, its dt vectors in the cluster sums' scratch
        // the heads' dy and dt of a chunk staged at once: head q's dy in
        // dys or xs, its dt vectors in the cluster sums' scratch
        static_assert(HPB <= 2, "a chunk's dy tiles for at most two heads");
        E* dyq[2] = {dys, xs};
        float* vq[2] = {dts, colp};   // dt, cum, ecum, el, wv: T apart
        for (int c = c_hi - 1; c >= c_lo; --c) {
          const int r0 = c * T, len = min(T, S - r0);
          stage<E>(Cs, lde, Cb + r0 * brow, brow, len, N, NP, p.vec_bc);
#pragma unroll
          for (int q = 0; q < HPB; ++q) {
            if (q < nh) {
              const int h = hfirst + q;
              stage<E>(dyq[q], ldx,
                       static_cast<const E*>(p.dy) + xo(h) + r0 * xrow, xrow,
                       len, pv, PT, p.vec_x);
              stage_dt(p.dt + static_cast<long long>(b) * S * H +
                           static_cast<long long>(r0) * H + h,
                       H, len, p.A[h], vq[q], vq[q] + T, vq[q] + 2 * T,
                       vq[q] + 3 * T, vq[q] + 4 * T, q);
            }
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < HPB; ++q) {
            if (q < nh) {
              const float* ec = vq[q] + 2 * T;
              scale(gacc[q], ec[T - 1]);
              gemm<E>(gacc[q], Scaled<Cm<E>, false>{{dyq[q], ldx}, ec},
                      Rm<E>{Cs, lde}, r16, sn0, T, nts);
              ld[q] += vq[q][2 * T - 1];   // cum's last value
            }
          }
          __syncthreads();
        }
      }
#pragma unroll
      for (int q = 0; q < HPB; ++q)
        frag_store(gacc[q], Gpub(q), ldf, r16, sn0, nts);
      if (tid == 0)
#pragma unroll
        for (int q = 0; q < HPB; ++q) pub[q] = ld[q];
      cluster_sync();
      // head q's G_out lands in S_in's tile (q = 0) or in C.B^T's and
      // Q's (q = 1), idle here
      float* land[2] = {reinterpret_cast<float*>(smem + HPB * sbytes), CBs};
      static_assert(HPB <= 2, "landing tiles for at most two heads");
#pragma unroll
      for (int q = 0; q < HPB; ++q)
        if (q < nh)
          cluster_scan<false>(Gpub(q), pub + q, land[q], ldf, NP, rank, R,
                              dst0(q), N, pv);
      cluster_sync();   // every slice written, every Delta read
#pragma unroll
      for (int q = 0; q < HPB; ++q) {
        float4 acc[CHQ];
        chunk_sload(acc, land[q], ldf, NP);
        chunk_put(acc, Gst(q), NP);
      }
    } else {
#pragma unroll
      for (int q = 0; q < HPB; ++q) {
        float4 acc[CHQ];
        chunk_gload(acc, dst0(q), N, pv, NP);
        chunk_put(acc, Gst(q), NP);
      }
    }
  }

  // ---- the run, last chunk first ------------------------------------------
  for (int c = c_hi - 1; c >= c_lo; --c) {
    const int r0 = c * T, len = min(T, S - r0);
    head_load(0, c);
    stage<E>(Bs, lde, Bb + r0 * brow, brow, len, N, NP, p.vec_bc);
    stage<E>(Cs, lde, Cb + r0 * brow, brow, len, N, NP, p.vec_bc);
    head_store(0);
    state_stage(0, c);
    __syncthreads();
    {   // C.B^T, once for the block's heads
      float cb[4][4];
      zero(cb);
      gemm<E>(cb, Rm<E>{Cs, lde}, Cm<E>{Bs, lde}, r16, c32, NP, 4);
      frag_store(cb, CBs, LDW, r16, c32, 4);
    }
    float dBa[NTN][4], dCa[NTN][4];   // summed over the heads
    zero(dBa);
    zero(dCa);
#pragma unroll 1
    for (int q = 0; q < nh; ++q) {
      const int h = hfirst + q;
      const float a = p.A[h];
      const State<E> Gq = Gst(q);
      if (q > 0) {
        head_load(q, c);
        head_store(q);
        state_stage(q, c);
        __syncthreads();
      }

      // ---- Q . dt_j (Q = L . dy.x^T); the rows (times dt) and columns of
      // R' = L . C.B^T . dy.x^T
      {
        float dd[4][4];
        zero(dd);
        gemm<E>(dd, Rm<E>{dys, ldx}, Cm<E>{xs, ldx}, r16, c32, PT, 4);
        float rs[2] = {0.0f, 0.0f}, cs[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cs[j][0] = cs[j][1] = 0.0f;
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int i = r16 + frag_row(q4), k = c32 + 8 * j + frag_col(q4);
            float qv = 0.0f, r = 0.0f;
            if (k <= i) {
              const float L = expf(cum[i] - cum[k]);
              qv = L * dd[j][q4];
              r = L * CBs[i * LDW + k] * dd[j][q4];
            }
            dd[j][q4] = qv * dts[k];
            rs[q4 >> 1] = fmaf(r, dts[k], rs[q4 >> 1]);
            cs[j][q4 & 1] += r;
          }
        }
        frag_put(dd, Qs, r16, c32, 4);
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          rs[0] += __shfl_xor_sync(FULL, rs[0], off);
          rs[1] += __shfl_xor_sync(FULL, rs[1], off);
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cs[j][0] += __shfl_xor_sync(FULL, cs[j][0], off);
            cs[j][1] += __shfl_xor_sync(FULL, cs[j][1], off);
          }
        if ((lane & 3) == 0) {
          rowp[ch * T + r16 + frag_row(0)] = rs[0];
          rowp[ch * T + r16 + frag_row(2)] = rs[1];
        }
        if (lane < 4)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            colp[rb * T + c32 + 8 * j + frag_col(0)] = cs[j][0];
            colp[rb * T + c32 + 8 * j + frag_col(1)] = cs[j][1];
          }
      }

      // ---- v = rows of dy . (C S_in^T), u = rows of x . (B G^T), w -------
      float bg[4][4];
      zero(bg);
      {
        float cs[4][4];
        zero(cs);
        gemm<E>(cs, Rm<E>{Cs, lde}, Ss.cm(), r16, c32, NP, 4);
        gemm<E>(bg, Rm<E>{Bs, lde}, Gq.cm(), r16, c32, NP, 4);
        float vs[2] = {0.0f, 0.0f}, us[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int i = r16 + frag_row(q4), k = c32 + 8 * j + frag_col(q4);
            vs[q4 >> 1] = fmaf(to_f32(dys[i * ldx + k]), cs[j][q4],
                               vs[q4 >> 1]);
            us[q4 >> 1] = fmaf(to_f32(xs[i * ldx + k]), bg[j][q4],
                               us[q4 >> 1]);
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            vs[e] += __shfl_xor_sync(FULL, vs[e], off);
            us[e] += __shfl_xor_sync(FULL, us[e], off);
          }
        if ((lane & 3) == 0)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            vp[ch * T + r16 + frag_row(2 * e)] = vs[e];
            up[ch * T + r16 + frag_row(2 * e)] = us[e];
          }
        float w = 0.0f;
        for (int e = tid; e < PT * NP / 2; e += THREADS) {
          const int r = e / (NP / 2), n = 2 * (e - r * (NP / 2));
          const float2 gv = Gq.get2(r, n), sv = Ss.get2(r, n);
          w = fmaf(gv.x, sv.x, fmaf(gv.y, sv.y, w));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          w += __shfl_xor_sync(FULL, w, off);
        if (lane == 0) red[warp] = w;
      }
      __syncthreads();

      // ---- warp 0: dcum, its reverse sum, ddt and dA ------------------
      if (warp == 0) {
        float w = 0.0f;
#pragma unroll
        for (int k = 0; k < THREADS / 32; ++k) w += red[k];
        float dcum[2], direct[2], tp[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = lane + 32 * e;
          const float rowR = rowp[i] + rowp[T + i];
          const float colR =
              colp[i] + colp[T + i] + colp[2 * T + i] + colp[3 * T + i];
          const float v = vp[i] + vp[T + i], u = up[i] + up[T + i];
          const float d = dts[i], eu = el[i] * u;
          dcum[e] = rowR - d * colR + ecum[i] * v - d * eu;
          direct[e] = colR + eu;
          tp[e] = d * eu;
        }
        float tail = tp[0] + tp[1];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          tail += __shfl_xor_sync(FULL, tail, off);
        tail = fmaf(ecum[T - 1], w, tail);
        // suffix sums from the last row, which takes the tail
        float s0 = dcum[0], s1 = dcum[1] + (lane == 31 ? tail : 0.0f);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u0 = __shfl_down_sync(FULL, s0, off);
          const float u1 = __shfl_down_sync(FULL, s1, off);
          if (lane + off < 32) {
            s0 += u0;
            s1 += u1;
          }
        }
        s0 += __shfl_sync(FULL, s1, 0);
        const float suf[2] = {s0, s1};
        float da = 0.0f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = lane + 32 * e;
          if (i < len)
            p.ddt_p[((static_cast<long long>(pt) * p.Bsz + b) * S + r0 + i) *
                        H + h] = fmaf(a, suf[e], direct[e]);
          da = fmaf(dts[i], suf[e], da);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          da += __shfl_xor_sync(FULL, da, off);
        if (lane == 0)
          p.dA_p[((static_cast<long long>(pt) * p.Bsz + b) * nc + c) * H + h] =
              da;
      }

      // ---- dx, dC and dB (summed over heads), the update of G -------------
      {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) bg[j][q4] *= el[r16 + frag_row(q4)];
        gemm<E>(bg, DecayT{CBs, cum}, Rm<E>{dys, ldx}, r16, c32, T, 4);
        E* dxb = static_cast<E*>(p.dx) + xo(h);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q4 = 0; q4 < 4; q4 += 2) {
            const int i = r16 + frag_row(q4), k = c32 + 8 * j + frag_col(q4);
            if (i < len)
              store2(dxb + (r0 + i) * xrow + k, dts[i] * bg[j][q4],
                     dts[i] * bg[j][q4 + 1], pv - k, p.vec_x);
          }
        gemm<E>(dCa, Scaled<Rm<E>, true>{{dys, ldx}, ecum}, Ss.rm(), r16, sn0,
                PT, nts);
        gemm<E>(dCa, Qs.rm(), Rm<E>{Bs, lde}, r16, sn0, T, nts);
        gemm<E>(dBa, Scaled<Rm<E>, true>{{xs, ldx}, wv}, Gq.rm(), r16, sn0,
                PT, nts);
        gemm<E>(dBa, Qs.cm(), Rm<E>{Cs, lde}, r16, sn0, T, nts);
        float gn[NTN][4];
        frag_get(gn, Gq, r16, sn0, nts);
        scale(gn, ecum[T - 1]);
        gemm<E>(gn, Scaled<Cm<E>, false>{{dys, ldx}, ecum}, Rm<E>{Cs, lde},
                r16, sn0, T, nts);
        __syncthreads();   // every read of this head's G, x, dy, S_in done
        frag_put(gn, Gq, r16, sn0, nts);
      }
    }
    const long long dbo = ((static_cast<long long>(pt) * p.Bsz + b) * S + r0) *
                              HB * N +
                          static_cast<long long>(hb) * N;
    frag_gstore(dBa, p.dB_p + dbo, static_cast<long long>(HB) * N, N, len, r16,
                sn0, nts);
    frag_gstore(dCa, p.dC_p + dbo, static_cast<long long>(HB) * N, N, len, r16,
                sn0, nts);
  }
  if (rank == 0) {
    __syncthreads();
    for (int q = 0; q < nh; ++q) {
      float* d = p.dh0 + ho(hfirst + q);
      const State<E> g = Gst(q);
      for (int e = tid; e < pv * N; e += THREADS) {
        const int r = e / N, n = e - r * N;
        d[static_cast<long long>(r) * N + n] =
            (n & 1) ? g.get2(r, n - 1).y : g.get2(r, n).x;
      }
    }
  }
}

// ============================ launches =======================================

// The launch at these sizes: grid x, y (the cluster, along y) and z, the
// dynamic shared memory of a block, and K8b's heads a block.
template <typename E>
void shape_of(int B, int S, int H, int P, int G, int N, bool bwd, int* out) {
  int R, run;
  plan(S, R, run);
  const int HG = H / G;
  const int HBG = (HG + Tc<E>::HPB - 1) / Tc<E>::HPB;
  out[0] = B * (bwd ? G * HBG : H);
  out[1] = R;
  out[2] = (P + PT - 1) / PT;
  out[3] = bwd ? bwd_smem_bytes<E>(N) : fwd_smem_bytes<E>(N);
  out[4] = Tc<E>::HPB;
}

// E only keeps each kernel's instance, and its static, apart.
template <typename E, typename Args, typename Kernel>
int launch(Kernel kernel, const Args& args, const int* shape, int max_smem,
           cudaStream_t stream) {
  // Raise the block's dynamic shared memory limit once, to the most any N
  // needs, so that a launch captured in a CUDA graph makes no such call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shape[0], shape[1], shape[2]);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = shape[3];
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = shape[1];
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int B, int S, int H, int P, int G, int N) {
  return B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 ||
         N > MAX_N || H % G != 0 ||
         static_cast<long long>(B) * H > 0x7fffffffLL;
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename E>
int run_fwd(FwdArgs a, int B, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(E);
  int shape[5];
  shape_of<E>(B, a.S, a.H, a.P, a.G, a.N, false, shape);
  int R;
  plan(a.S, R, a.run);
  a.vec_bc = a.N % VEC == 0 && aligned16(a.Bm) && aligned16(a.Cm);
  a.vec_x = a.P % VEC == 0 && aligned16(a.x) && aligned16(a.y);
  return launch<E>(ssd_kernel<E>, a, shape, fwd_smem_bytes<E>(MAX_N), s);
}

template <typename E>
int run_bwd(BwdArgs a, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(E);
  int shape[5];
  shape_of<E>(a.Bsz, a.S, a.H, a.P, a.G, a.N, true, shape);
  int R;
  plan(a.S, R, a.run);
  a.vec_bc = a.N % VEC == 0 && aligned16(a.Bm) && aligned16(a.Cm);
  a.vec_x = a.P % VEC == 0 && aligned16(a.x) && aligned16(a.dy) &&
            aligned16(a.dx);
  a.vec_s = a.N % 4 == 0 && aligned16(a.states);
  return launch<E>(ssd_bwd_kernel<E>, a, shape, bwd_smem_bytes<E>(MAX_N), s);
}

}  // namespace

// K8's (bwd 0) or K8b's (bwd 1) launch at these sizes, into out[0..4]: grid
// x, y and z (clusters of y blocks), a block's dynamic shared memory in
// bytes, and the heads a K8b block takes.  Returns cudaErrorInvalidValue for
// sizes the kernels do not take.
extern "C" int ssd_launch_shape(int B, int S, int H, int P, int G, int N,
                                int dtype, int bwd, int* out) {
  if (bad_sizes(B, S, H, P, G, N) ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_F32)
    shape_of<float>(B, S, H, P, G, N, bwd != 0, out);
  else
    shape_of<bf16>(B, S, H, P, G, N, bwd != 0, out);
  return 0;
}

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
  if (bad_sizes(B, S, H, P, G, N))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a = {x, dt, A, Bm, Cm, h0, y, hout, states, S, H, P, G, N, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32: return run_fwd<float>(a, B, s);
    case DTYPE_BF16: return run_fwd<bf16>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8b.  x, dy, dx (B, S, H, P) and Bm, Cm (B, S, G, N) of one element type
// (`dtype`); dt (B, S, H), A (H,); states (B, H, ceil(S / 64), P, N), as K8
// writes them; dstate (B, H, P, N) or null for zeros; dh0 (B, H, P, N).
// Partials, nPT = ceil(P / 64), nc = ceil(S / 64), HB = G * ceil(H / G /
// heads a block): ddt_p (nPT, B, S, H), dA_p (nPT, B, nc, H), dB_p and
// dC_p (nPT, B, S, HB, N), summed over the heads of a block.  All row-major
// on the device, everything but x, dy, dx, Bm and Cm fp32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm,
                            const float* states, const void* dy,
                            const float* dstate, void* dx, float* ddt_p,
                            float* dA_p, float* dB_p, float* dC_p, float* dh0,
                            int B, int S, int H, int P, int G, int N,
                            int dtype, void* stream) {
  if (bad_sizes(B, S, H, P, G, N))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = {x,    dt,   A,    Bm,    Cm,    states, dy, dstate, dx, ddt_p,
               dA_p, dB_p, dC_p, dh0,   B,     S,      H,  P,      G,  N,
               0,    0,    0,    0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32: return run_bwd<float>(a, s);
    case DTYPE_BF16: return run_bwd<bf16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
