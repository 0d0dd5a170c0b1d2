// K5: blocked (flash) attention with an online softmax, GQA, causal masking
// and a sliding window.  q (B,H,Sq,D); k, v (B,KV,Skv,D) -> o (B,H,Sq,D).
// K5b, its backward, is the second half of the file.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), the Pallas TPU kernel whose grid (B*H, Sq/bq, Skv/bk)
// carries m, l and acc in VMEM scratch across the sequential KV dimension.
//
// What bounds it on the H100: the 4*Sq*Skv*D operations of the two products
// over the key range the masks leave (bf16 on the tensor cores at long
// sequences, RecurrentGemma-2B's D = 256); at the ViT's shapes (fp32, D = 32,
// 5 to 197 tokens) the launch and the per-block loads.
//
// What the design does about it.  Both kernels keep m, l and the accumulator
// in fp32 registers, launch one block per (b*h, query tile), under causal
// masking the last query tiles (the most keys) first, and walk only the KV
// tiles a query tile can see: from the tile that holds max(0, q0 - window +
// 1) (with a window) to the one that ends at min(Skv, q0 + BQ) (causal).
// In bf16 only tiles that cross a mask boundary or the end of the keys are
// masked element by element.  The mask value is the finite NEG_INF = -1e30
// of the TPU kernel and l is clamped at 1e-30, so a tile fully masked for
// one row adds weight that the first unmasked tile's rescale (alpha = 0)
// wipes out, where -inf would give NaN; keys past Skv get weight exactly 0,
// so Sq and Skv need not be multiples of a tile.  A query
// tile that holds a row with no key in its window (non-causal or causal,
// window set, row >= Skv + window - 1) walks every tile, masked: such a row
// gets the mean of V over all Skv keys, as the TPU kernel and the plain
// version give it.  Head h reads KV head h / (H / KV).
//
// bf16 (flash_bf16_kernel): wgmma on the tensor cores, bf16 operands, fp32
// accumulation.  Two warpgroups take 64 query rows each (BQ = 128), so each
// K and V tile serves 128 rows.  Q (the warpgroup's 64 rows), K and V live
// in dynamic shared memory as 64-row blocks of 64 columns (128 bytes a row,
// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8)), the
// canonical layout of a K-major wgmma operand; V's key rows are the same
// bytes read as an MN-major (transposed) B.  S = Q.K^T is m64n64k16 with
// both operands in shared memory (Q stays there, not in registers, to leave
// them for O); P is rounded to bf16 in registers, where S's accumulator
// fragment is already the A fragment of O += P.V, one m64nNk16 a k16 step
// over all N = D columns (V from shared memory).  Each warpgroup issues
// S_j, moves O to tile j - 1's maximum while S_j runs, issues O += P_{j-1}.
// V_{j-1}, and runs tile j's softmax while that product runs.  The online
// softmax runs in fp32 with ex2 and log2(e) folded into the scale (one FFMA
// an element on unmasked tiles); m and l are reduced across the four
// threads that share a row of the fragment.  K and V arrive through
// two-stage rings filled by cp.async (16 bytes a thread, zero-filled past
// Skv and past D), V one tile behind K: the copies of K_{j+1} and V_j go
// out while the products on tile j run, and one block barrier a tile both
// publishes K_j and V_{j-1} and frees the stages they overwrite.  Every
// thread both copies and computes, so the barrier costs what an mbarrier
// round would; a TMA producer warp with setmaxnreg and ping-pong between
// the warpgroups is later work.  O leaves through the warpgroup's Q tile,
// in the same swizzled layout, so that its rows are written in whole 16-byte
// chunks.  D < 64 is padded to 64 columns of zeros in shared memory.  At
// D = 256 the block holds 193 KB (Q 64 KB, two stages of K and V 128 KB, 1 KB
// to align): one block an SM.
//
// fp32 (flash_f32_kernel): the CUDA cores, so that fp32 stays fp32 (the
// serving checks' 1e-3 bar; TF32 would eat into it).  One block per 32-query
// tile; LANES threads own one query row, each with 1/LANES of its head
// dimension in registers, and combine their partial q.k with log2(LANES)
// warp shuffles.  D <= 128 takes 4 lanes and 32-key tiles; D = 256 takes 8
// lanes and 16-key tiles (two [16][256] fp32 tiles are 32 KB of static
// shared memory).  Without causal masking or a window (the ViT) it walks
// every key, as it did before tile skipping (see flash_f32_kernel).
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Query tile `qi` of `nq` (counted from the last tile under causal masking,
// so that the tiles with the most keys go out first) of head bh, [q0, q0 +
// BQ), and the key range [k_lo, k_hi) it walks; `full` when it holds a row
// that sees no key, which walks every key, masked.
struct TileRange {
  int bh, q0, k_lo, k_hi;
  bool full;
};

__device__ __forceinline__ TileRange tile_range(int qi, int nq, int bh,
                                                int BQ, int Sq, int Skv,
                                                int causal, int window) {
  TileRange t;
  t.bh = bh;
  t.q0 = (causal ? nq - 1 - qi : qi) * BQ;
  const int q_last = min(t.q0 + BQ, Sq) - 1;
  t.full = window && q_last >= Skv + window - 1;
  t.k_lo = (window && !t.full) ? max(0, t.q0 - window + 1) : 0;
  t.k_hi = (causal && !t.full) ? min(Skv, q_last + 1) : Skv;
  return t;
}

// True when keys [k0, k0 + BK) need per-element masking for query rows
// [q_first, q_last]: they cross the causal diagonal, the window's edge or
// the end of the keys.
__device__ __forceinline__ bool tile_masked(int k0, int BK, int q_first,
                                            int q_last, int Skv, int causal,
                                            int window, bool full) {
  return full || k0 + BK > Skv || (causal && k0 + BK - 1 > q_first) ||
         (window && q_last - k0 >= window);
}

// The log-sum-exp of a row's scaled scores, m + log l (m in the scaled
// units), which K5b reads to recompute P.  A row that saw no key (m the
// mask value) gets exactly NEG_INF, what m + log l rounds to in fp32: K5b
// gives such a row the weight 1 / Skv on every key, as the forward does.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == NEG_INF ? NEG_INF : m + logf(l);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores.
constexpr int F32_BQ = 32;

// SKIP: causal masking or a window is on; the grid is (B*H, query tiles),
// so every head's heaviest tile goes out first, and a block walks only its
// key range.  Without them (the ViT) the grid is (query tiles, B*H) and a
// block walks every key: the range's few dependent operations ahead of the
// first copy, or other code in place of the plain loop, cost 3-23% at the
// ViT's 122 tokens (tools/k5_ab.py).
template <int D, int LANES, int BKV, bool SKIP>
__global__ void __launch_bounds__(F32_BQ * LANES)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int Sq, int Skv,
                 float scale, int causal, int window) {
  constexpr int DP = D / LANES;
  constexpr int THREADS = F32_BQ * LANES;
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];
  int bh = blockIdx.y, q0 = blockIdx.x * F32_BQ, k_lo = 0, k_hi = Skv;
  if constexpr (SKIP) {
    const TileRange t = tile_range(blockIdx.y, gridDim.y, blockIdx.x, F32_BQ,
                                   Sq, Skv, causal, window);
    bh = t.bh;
    q0 = t.q0;
    k_lo = t.k_lo / BKV * BKV;
    k_hi = t.k_hi;
  }
  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KV);
  const int qpos = q0 + row;
  const size_t q_off = ((size_t)bh * Sq + qpos) * D;
  const size_t kv_base = ((size_t)b * KV + kvh) * Skv * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = qpos < Sq ? q[q_off + lane + LANES * i] : 0.0f;
    acc[i] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BKV) {
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < Skv;
      const size_t g = kv_base + (size_t)(k0 + r) * D + c;
      ks[r][c] = ok ? k[g] : 0.0f;
      vs[r][c] = ok ? v[g] : 0.0f;
    }
    __syncthreads();

    float s[BKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part = fmaf(qr[i], ks[j][lane + LANES * i], part);
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int kpos = k0 + j;
      float sj = part * scale;
      if ((causal && kpos > qpos) || (window && qpos - kpos >= window))
        sj = NEG_INF;
      if (kpos >= Skv) sj = -INFINITY;  // past the end: weight exactly 0
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j)
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(s[j], vs[j][lane + LANES * i], acc[i]);
    __syncthreads();
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i) o[q_off + lane + LANES * i] = acc[i] / denom;
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * Sq + qpos] = row_lse(m, l);
  }
}

template <int D, int LANES = 4, int BKV = 32>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KV, int Sq, int Skv, float scale,
               int causal, int window, cudaStream_t stream) {
  const int nq = (Sq + F32_BQ - 1) / F32_BQ;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (causal || window)
    flash_f32_kernel<D, LANES, BKV, true><<<dim3(B * H, nq), F32_BQ * LANES,
                                            0, stream>>>(
        qf, kf, vf, of, lse, H, KV, Sq, Skv, scale, causal, window);
  else
    flash_f32_kernel<D, LANES, BKV, false><<<dim3(nq, B * H), F32_BQ * LANES,
                                             0, stream>>>(
        qf, kf, vf, of, lse, H, KV, Sq, Skv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma).
constexpr int BQ = 128;          // query rows a block: two warpgroups of 64
constexpr int BK = 64;           // keys a KV tile
constexpr int THREADS = 256;
constexpr int BLOCK_BYTES = 64 * 128;  // 64 rows x 64 bf16 columns, swizzled

// This thread's copies have landed; make them visible to the tensor cores'
// (async proxy) reads, then wait for every thread of the block.
__device__ __forceinline__ void publish_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64x64, fp32) (+)= A (64x16, shared, K-major) . B (16x64, shared,
// K-major); d is overwritten when !accumulate.  The descriptors are a base
// plus OFF (in 16-byte units), added inside the asm so that the compiler
// keeps two base registers, not one descriptor per k16 step.
template <int OFF_A, int OFF_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %34, 0;\n"
      "add.s64 da, %32, %35;\nadd.s64 db, %33, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}"
      ", da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(OFF_A), "n"(OFF_B));
}

// d (64xN, fp32) += A (64x16, bf16 in registers) . B (16xN, shared,
// MN-major), B's descriptor a base plus OFF_B (16-byte units): the P.V
// product over all N = 64 * NDB columns of D at once.
template <int N>
struct PV;

template <>
struct PV<64> {
  template <int OFF_B>
  __device__ __forceinline__ static void mma(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %37, 0;\n"
        "add.s64 db, %36, %38;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(OFF_B));
  }
};

template <>
struct PV<128> {
  template <int OFF_B>
  __device__ __forceinline__ static void mma(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %69, 0;\n"
        "add.s64 db, %68, %70;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(OFF_B));
  }
};

template <>
struct PV<256> {
  template <int OFF_B>
  __device__ __forceinline__ static void mma(float* d, const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %133, 0;\n"
        "add.s64 db, %132, %134;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}"
        ", {%128, %129, %130, %131}, db, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(OFF_B));
  }
};

// S = Q . K^T over KSTEPS k16 steps; a step is 32 bytes along the swizzled
// 128-byte row, four steps a 64-column block.
template <int KSTEPS, int I = 0>
__device__ __forceinline__ void qk_products(float (&s)[32], uint64_t qd,
                                            uint64_t kd) {
  if constexpr (I < KSTEPS) {
    constexpr int off = ((I / 4) * BLOCK_BYTES + (I % 4) * 32) / 16;
    wgmma_ss<off, off>(s, qd, kd, I > 0);
    qk_products<KSTEPS, I + 1>(s, qd, kd);
  }
}

// O += P . V, committed as one group: V's key rows are an MN-major B over
// the NDB 64-column blocks of D (LBO one block); a k16 step is 16 rows, 2 KB.
template <int NDB>
__device__ __forceinline__ void pv_product(float (&acc)[NDB * 32],
                                           const uint32_t (&p)[4][4],
                                           uint32_t vt) {
  const uint64_t vd = wgmma_desc(vt, BLOCK_BYTES, 1024);
  PV<64 * NDB>::template mma<0>(acc, p[0], vd);
  PV<64 * NDB>::template mma<128>(acc, p[1], vd);
  PV<64 * NDB>::template mma<256>(acc, p[2], vd);
  PV<64 * NDB>::template mma<384>(acc, p[3], vd);
  wgmma_commit();
}

// Copy rows [row0, row0 + ROWS) of a (rows_valid, D) bf16 matrix into
// 64-row groups of NDB swizzled 64-column blocks at `dst`.  A thread copies
// one 16-byte chunk of a row in every RP-th row, so its column, its swizzle
// and its offsets are fixed and the passes differ by constants.
template <int ROWS, int NDB>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g, int row0,
                                          int rows_valid, int D) {
  constexpr int CH = NDB * 8;           // 16-byte chunks a row
  constexpr int RP = THREADS / CH;      // rows a pass
  static_assert(RP % 8 == 0 && 64 % RP == 0, "whole swizzle rows a pass");
  const int rr = threadIdx.x / CH, db = (threadIdx.x % CH) / 8;
  const int c = threadIdx.x % 8;
  const int col = db * 64 + c * 8;
  const uint32_t at = dst + db * BLOCK_BYTES + rr * 128 + ((c ^ (rr % 8)) * 16);
  const __nv_bfloat16* src = g + (size_t)(row0 + rr) * D + col;
  const bool col_ok = col < D;
#pragma unroll
  for (int it = 0; it < ROWS / RP; ++it) {
    const int r = it * RP;              // + rr
    const bool ok = col_ok && row0 + rr + r < rows_valid;
    cp_async16(at + (r / 64) * NDB * BLOCK_BYTES + (r % 64) * 128,
               ok ? src + (size_t)r * D : g, ok);
  }
}

template <int D>
constexpr int bf16_smem_bytes() {
  // Q (two warpgroups), two stages of K and V, and 1 KB to align to 1 KB.
  return (D < 64 ? 1 : D / 64) * BLOCK_BYTES * (2 + 2 * 2) + 1024;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int B, int H, int KV, int Sq, int Skv, float scale_log2,
                  int causal, int window) {
  constexpr int NDB = D < 64 ? 1 : D / 64;  // 64-column blocks of D
  constexpr int TILE = NDB * BLOCK_BYTES;   // one 64-row K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;                   // 2 x TILE
  const uint32_t k_smem = base + 2 * TILE;        // 2 stages x TILE
  const uint32_t v_smem = base + 4 * TILE;        // 2 stages x TILE

  // Grid (B*H, query tiles): every head's tile qi goes out before any
  // head's tile qi + 1, the heaviest first under causal masking.
  const TileRange t = tile_range(blockIdx.y, gridDim.y, blockIdx.x, BQ, Sq,
                                 Skv, causal, window);
  const int b = t.bh / H;
  const int kvh = (t.bh % H) / (H / KV);
  const __nv_bfloat16* qg = q + (size_t)t.bh * Sq * D;
  const __nv_bfloat16* kg = k + ((size_t)b * KV + kvh) * Skv * D;
  const __nv_bfloat16* vg = v + ((size_t)b * KV + kvh) * Skv * D;

  const int wg = threadIdx.x / 128;              // warpgroup: 64 query rows
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wq0 = t.q0 + wg * 64;                // the warpgroup's first row
  // This thread's two rows of the accumulator fragment, and its columns
  // 8 * (i / 4) + 2 * (lane % 4) + (i % 2) for fragment register i.
  const int qpos[2] = {wq0 + warp * 16 + lane / 4, wq0 + warp * 16 + lane / 4 + 8};
  const int col0 = 2 * (lane % 4);
  const uint64_t qd = wgmma_desc(q_smem + wg * TILE, 16, 1024);

  const int j_lo = t.k_lo / BK;
  const int j_hi = (t.k_hi + BK - 1) / BK;

  float acc[NDB * 32];          // O, 64 x D a warpgroup
#pragma unroll
  for (int i = 0; i < NDB * 32; ++i) acc[i] = 0.0f;
  float s[32];                  // S of a tile, then P, in fp32
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  uint32_t p[4][4] = {};        // P in bf16, the A fragments of P.V
  // m in the scores' own units; alpha rescales O when P.V next runs.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float alpha[2] = {1.0f, 1.0f};

  if (j_lo < j_hi) {
    load_tile<BQ, NDB>(q_smem, qg, t.q0, Sq, D);
    load_tile<BK, NDB>(k_smem, kg, j_lo * BK, Skv, D);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Tile j's K sits in K stage (j - j_lo) % 2 and its V, copied one tile
  // later, in V stage (j - j_lo) % 2.  Iteration j issues S_j = Q.K_j^T,
  // moves O to tile j - 1's maximum while S_j runs, issues O += P_{j-1}.
  // V_{j-1}, and runs tile j's softmax while that product runs.
  for (int j = j_lo; j < j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    // K_j and V_{j-1} have landed; K stage stage ^ 1 (K_{j-1}) and V stage
    // `stage` (V_{j-2}) are free: every product that read them is done.
    publish_copies();
    fence_regs(s);
    wgmma_fence();
    qk_products<NDB * 4>(s, qd, wgmma_desc(k_smem + stage * TILE, 16, 1024));
    wgmma_commit();
    // The next copies go out while S_j runs.
    if (j + 1 < j_hi)
      load_tile<BK, NDB>(k_smem + (stage ^ 1) * TILE, kg, (j + 1) * BK, Skv, D);
    load_tile<BK, NDB>(v_smem + stage * TILE, vg, j * BK, Skv, D);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (j > j_lo) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int i = 0; i < NDB * 32; ++i) acc[i] *= alpha[(i / 2) % 2];
      }
      fence_regs(acc);
      wgmma_fence();
      pv_product<NDB>(acc, p, v_smem + (stage ^ 1) * TILE);
      wgmma_wait<1>();          // S_j done; P_{j-1}.V_{j-1} may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    // Online softmax in fp32: m in the scores' units, 2^(s * c - m * c)
    // with c = log2(e) / sqrt(D), one FFMA and one ex2 an element where no
    // score is masked.
    const int k0 = j * BK;
    const bool masked = tile_masked(k0, BK, wq0, wq0 + 63, Skv, causal,
                                    window, t.full);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      if (masked) {
        const int kpos = k0 + 8 * (i / 4) + col0 + (i % 2);
        if ((causal && kpos > qpos[r]) || (window && qpos[r] - kpos >= window))
          s[i] = NEG_INF;
        if (kpos >= Skv) s[i] = -INFINITY;  // past the end: weight exactly 0
      }
      tmax[r] = fmaxf(tmax[r], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = ex2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
    }
    float psum[2] = {0.0f, 0.0f};
    if (masked) {
      // s - m first: where both are NEG_INF (a row that has seen no key)
      // it is exactly 0, where s * c - m * c would leave m * c's rounding.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        s[i] = ex2((s[i] - m[r]) * scale_log2);
        psum[r] += s[i];
      }
    } else {
      const float mc[2] = {m[0] * scale_log2, m[1] * scale_log2};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        s[i] = ex2(fmaf(s[i], scale_log2, -mc[r]));
        psum[r] += s[i];
      }
    }
    // l stays a per-thread partial sum (alpha is the same on the four
    // threads of a row); the four are added once, at the end.
    l[0] = l[0] * alpha[0] + psum[0];
    l[1] = l[1] * alpha[1] + psum[1];

    // P_j in bf16 once P_{j-1}.V_{j-1} is done with p: S's fragment for
    // keys 16 kk .. 16 kk + 15 is the A fragment of a k16 step.
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        p[kk][h] = pack_bf16(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
  }

  // The last tile's O += P.V, once its V has landed.
  publish_copies();
  if (j_lo < j_hi) {
#pragma unroll
    for (int i = 0; i < NDB * 32; ++i) acc[i] *= alpha[(i / 2) % 2];
    fence_regs(acc);
    wgmma_fence();
    pv_product<NDB>(acc, p, v_smem + ((j_hi - 1 - j_lo) & 1) * TILE);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && lane % 4 == 0) {
    // m is in the scores' own units: scale it (scale_log2 * ln 2 = scale)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] < Sq)
        lse[(size_t)t.bh * Sq + qpos[r]] =
            row_lse(m[r] == NEG_INF ? NEG_INF : m[r] * (scale_log2 * LN2),
                    l[r]);
  }
  // O in bf16 goes through the warpgroup's Q tile (its last S has run), in
  // Q's swizzled layout, so that the rows leave in whole 16-byte chunks.
  uint8_t* const o_tile = smem_raw + (base - smem_u32(smem_raw)) + wg * TILE;
#pragma unroll
  for (int i = 0; i < NDB * 32; i += 2) {
    const int r = (i / 2) % 2;
    const int row = warp * 16 + lane / 4 + 8 * r;
    const int chunk = (i / 4) % 8;
    *reinterpret_cast<__nv_bfloat162*>(
        o_tile + (i / 32) * BLOCK_BYTES + row * 128 +
        ((chunk ^ (row % 8)) * 16) + col0 * 2) =
        __floats2bfloat162_rn(acc[i] * inv[r], acc[i + 1] * inv[r]);
  }
  if (wg == 0)                  // the warpgroup's own named barrier
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  constexpr int CH = NDB * 8;                    // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < 64 * CH / 128; ++it) {
    const int e = it * 128 + threadIdx.x % 128;
    const int row = e / CH, db = (e % CH) / 8, c = e % 8;
    const int col = db * 64 + c * 8;
    if (wq0 + row < Sq && col < D)
      *reinterpret_cast<uint4*>(o + ((size_t)t.bh * Sq + wq0 + row) * D + col) =
          *reinterpret_cast<const uint4*>(o_tile + db * BLOCK_BYTES + row * 128 +
                                          ((c ^ (row % 8)) * 16));
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int Sq, int Skv, float scale,
                int causal, int window, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<D>();
  static bool configured = false;  // once per head dim and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      B, H, KV, Sq, Skv, scale * LOG2E, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5b: the backward, FlashAttention-2's decomposition.
//
// Replaces: no TPU kernel.  The JAX package differentiates
// src/repro/models/layers.py::blocked_attention by autodiff; the port
// routes attention through K5, so its gradient needs a kernel of its own.
//
// What bounds it on the H100: five products over the pairs the masks leave
// (S, dP, dV, dK, dQ: 2.5 times the forward's operations), bf16 on the
// tensor cores; at the training shapes far above the bytes.
//
// With S = scale Q K^T (masked), P = softmax(S) = exp(S - lse) recomputed
// from the forward's lse, Delta = rowsum(dO o O):
//   dV = P^T dO,   dP = dO V^T,   dS = P o (dP - Delta) (0 where masked),
//   dK = scale dS^T Q,   dQ = scale dS K,
// dK and dV summed over the G = H / KV query heads of a KV head.  A row that
// saw no key (lse == NEG_INF) weighs every key 1 / Skv, as the forward gave
// it the mean of V, and passes nothing to dQ or dK (its scores are the
// constant mask value).  Three launches on one stream: Delta; one block per
// (b, KV head, key tile) walking the G heads and the query tiles the masks
// leave, accumulating dK and dV in fp32 registers and writing them once (no
// atomics: deterministic); one block per (b, head, query tile) walking the
// key tiles, accumulating dQ.  Both recompute S and dP, so the backward runs
// seven products where the least is five (dQ's atomics are the price of
// five).

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, KV, Sq, Skv;
  float scale;
  int causal, window;
};

// Delta = rowsum(dO o O) in fp32, a warp a row.
template <typename E>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                       float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;      // the whole warp
  const E* op = o + (size_t)row * D;
  const E* gp = dout + (size_t)row * D;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32) sum = fmaf(to_f32(op[d]), to_f32(gp[d]), sum);
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// The query rows [q_lo, q_hi) that see any of keys [k0, k0 + BK): causal
// rows from k0 on, with a window those before k0 + BK - 1 + window; every
// row to Sq where rows that see no key exist (Sq >= Skv + window), since
// they weigh every key.
__device__ __forceinline__ void query_range(int k0, int BK, int Sq, int Skv,
                                            int causal, int window, int& q_lo,
                                            int& q_hi) {
  q_lo = causal ? k0 : 0;
  q_hi = (window && Sq < Skv + window) ? min(Sq, k0 + BK - 1 + window) : Sq;
}

// P and dS * scale of one (query, key) pair from the recomputed score s (in
// the scores' own units, unscaled) and dP; l2 is the row's lse * log2(e),
// -inf for a row that saw no key.
__device__ __forceinline__ void pair_grads(float s, float dp, int qi, int kj,
                                           float l2, float delta,
                                           const BwdArgs& a, float scale_log2,
                                           float inv_skv, float& p, float& ds) {
  const bool valid = qi < a.Sq && kj < a.Skv;
  p = 0.0f;
  ds = 0.0f;
  if (l2 == -INFINITY) {
    p = valid ? inv_skv : 0.0f;
  } else if (valid && !(a.causal && kj > qi) &&
             !(a.window && qi - kj >= a.window)) {
    p = exp2f(fmaf(s, scale_log2, -l2));
    ds = p * (dp - delta) * a.scale;
  }
}

__device__ __forceinline__ float lse_log2(float lse) {
  return lse == NEG_INF ? -INFINITY : lse * LOG2E;
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulation) -----
// A block's "own" rows (BO keys of a KV head for dK/dV, BO query rows of a
// head for dQ) stay in shared memory with their second operand (V, dO); the
// "other" side streams through in tiles of BT rows (Q and dO, or K and V).
// Per tile, phase 1: S and dP (own x other, over D) on the tensor cores,
// warps 2 or 4 along the own rows; P and dS rounded to bf16 into shared
// memory.  Phase 2: acc1 += dS . other1 (dK or dQ) and, for dK/dV, acc2 +=
// P . other2 (dV), over the tile's BT rows, warps splitting D.  Rows are
// padded by 16 bytes so that the eight rows an ldmatrix reads fall in
// distinct banks.  At D = 256, BO = 32: 64 accumulator registers a thread
// and 111 KB of shared memory, two blocks an SM; else BO = 64.
constexpr int BT = 64;
constexpr int BWD_THREADS = 256;
constexpr int PAD = 8;

template <int D>
constexpr int bwd_own_rows() {
  return D >= 256 ? 32 : 64;
}

template <int D, int BO>
constexpr int bwd_smem_bytes() {
  return (2 * BO + 2 * BT) * (D + PAD) * 2 + 2 * BO * (BT + PAD) * 2 +
         2 * BT * 4;
}

// Rows [row0, row0 + ROWS) of a (rows_valid, D) bf16 matrix into a tile of
// padded rows, zeros past rows_valid.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* g, int row0,
                                          int rows_valid) {
  constexpr int CH = D / 8;          // 16-byte chunks a row
  constexpr int RS = (D + PAD) * 2;
  for (int e = threadIdx.x; e < ROWS * CH; e += BWD_THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = row0 + r < rows_valid;
    cp_async16(dst + r * RS + c * 16,
               ok ? g + (size_t)(row0 + r) * D + c * 8 : g, ok);
  }
}

template <int D, int BO, bool KVM>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_bf16_kernel(const BwdArgs a) {
  constexpr int RS = (D + PAD) * 2;        // bytes a Q/K/V/dO tile row
  constexpr int PS = (BT + PAD) * 2;       // bytes a P/dS row
  constexpr int RW = BO / 16;              // warps along the own rows
  constexpr int CW = 8 / RW;               // warps along the columns
  constexpr int NB1 = BT / CW / 8;         // n8 blocks a warp: S, dP
  constexpr int NB2 = D / CW / 8;          // n8 blocks a warp: gradients
  static_assert(NB1 % 2 == 0 && NB2 >= 1 && (NB2 == 1 || NB2 % 2 == 0),
                "the warps' tiles");
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t own1 = smem_u32(smem), own2 = own1 + BO * RS;
  const uint32_t oth1 = own2 + BO * RS, oth2 = oth1 + BT * RS;
  const uint32_t ps = oth2 + BT * RS, dss = ps + BO * PS;
  uint8_t* const ps_p = smem + (2 * BO + 2 * BT) * RS;
  uint8_t* const dss_p = ps_p + BO * PS;
  float* const lse_s = reinterpret_cast<float*>(dss_p + BO * PS);
  float* const delta_s = lse_s + BT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % RW, wc = warp / RW;
  const int G = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E;
  const float inv_skv = 1.0f / a.Skv;
  const bf16* const Q = static_cast<const bf16*>(a.q);
  const bf16* const K = static_cast<const bf16*>(a.k);
  const bf16* const V = static_cast<const bf16*>(a.v);
  const bf16* const dO = static_cast<const bf16*>(a.dout);

  int b, kvh, own0, bh_own = 0;
  TileRange t{};
  if constexpr (KVM) {
    b = blockIdx.x / a.KV;
    kvh = blockIdx.x % a.KV;
    own0 = blockIdx.y * BO;
    const size_t kv_off = (size_t)blockIdx.x * a.Skv * D;
    load_rows<D, BO>(own1, K + kv_off, own0, a.Skv);
    load_rows<D, BO>(own2, V + kv_off, own0, a.Skv);
  } else {
    t = tile_range(blockIdx.y, gridDim.y, blockIdx.x, BO, a.Sq, a.Skv,
                   a.causal, a.window);
    bh_own = t.bh;
    b = t.bh / a.H;
    kvh = (t.bh % a.H) / G;
    own0 = t.q0;
    load_rows<D, BO>(own1, Q + (size_t)t.bh * a.Sq * D, own0, a.Sq);
    load_rows<D, BO>(own2, dO + (size_t)t.bh * a.Sq * D, own0, a.Sq);
    for (int i = threadIdx.x; i < BO; i += BWD_THREADS) {
      const int r = own0 + i;
      const size_t at = (size_t)t.bh * a.Sq + r;
      lse_s[i] = r < a.Sq ? lse_log2(a.lse[at]) : 0.0f;
      delta_s[i] = r < a.Sq ? a.delta[at] : 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc1[NB2][4], acc2[KVM ? NB2 : 1][4];
#pragma unroll
  for (int n = 0; n < NB2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[n][i] = 0.0f;
#pragma unroll
  for (int n = 0; n < (KVM ? NB2 : 1); ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc2[n][i] = 0.0f;

  // One tile of the other side: rows [o0, o0 + BT) of head bh.
  auto step = [&](int bh, int o0) {
    const bf16* o1g;
    const bf16* o2g;
    int valid;
    if constexpr (KVM) {
      o1g = Q + (size_t)bh * a.Sq * D;
      o2g = dO + (size_t)bh * a.Sq * D;
      valid = a.Sq;
    } else {
      const size_t kv_off = ((size_t)b * a.KV + kvh) * a.Skv * D;
      o1g = K + kv_off;
      o2g = V + kv_off;
      valid = a.Skv;
    }
    __syncthreads();               // the last tile's phase 2 is done
    load_rows<D, BT>(oth1, o1g, o0, valid);
    load_rows<D, BT>(oth2, o2g, o0, valid);
    if constexpr (KVM) {
      for (int i = threadIdx.x; i < BT; i += BWD_THREADS) {
        const int r = o0 + i;
        const size_t at = (size_t)bh * a.Sq + r;
        lse_s[i] = r < a.Sq ? lse_log2(a.lse[at]) : 0.0f;
        delta_s[i] = r < a.Sq ? a.delta[at] : 0.0f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // phase 1: S and dP, own rows x other rows, over D
    float sc[NB1][4], dp[NB1][4];
#pragma unroll
    for (int n = 0; n < NB1; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.0f;
    const int arow = wr * 16 + lane % 16, acol = 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a1[4], a2[4];
      ldsm_x4(a1, own1 + arow * RS + (kk + acol) * 2);
      ldsm_x4(a2, own2 + arow * RS + (kk + acol) * 2);
#pragma unroll
      for (int nb = 0; nb < NB1; nb += 2) {
        const int n = wc * NB1 * 8 + nb * 8 + lane % 8 + 8 * (lane / 16);
        const int kc = kk + 8 * ((lane / 8) % 2);
        uint32_t b1[4], b2[4];
        ldsm_x4(b1, oth1 + n * RS + kc * 2);
        ldsm_x4(b2, oth2 + n * RS + kc * 2);
        const uint32_t b10[2] = {b1[0], b1[1]}, b11[2] = {b1[2], b1[3]};
        const uint32_t b20[2] = {b2[0], b2[1]}, b21[2] = {b2[2], b2[3]};
        mma_bf16(sc[nb], a1, b10);
        mma_bf16(sc[nb + 1], a1, b11);
        mma_bf16(dp[nb], a2, b20);
        mma_bf16(dp[nb + 1], a2, b21);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB1; ++nb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ro = wr * 16 + lane / 4 + 8 * hh;
        const int co = wc * NB1 * 8 + nb * 8 + 2 * (lane % 4);
        float pv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qloc = KVM ? co + e : ro;
          const int qi = KVM ? o0 + co + e : own0 + ro;
          const int kj = KVM ? own0 + ro : o0 + co + e;
          pair_grads(sc[nb][2 * hh + e], dp[nb][2 * hh + e], qi, kj,
                     lse_s[qloc], delta_s[qloc], a, scale_log2, inv_skv,
                     pv[e], dv[e]);
        }
        if constexpr (KVM)
          *reinterpret_cast<__nv_bfloat162*>(ps_p + ro * PS + co * 2) =
              __floats2bfloat162_rn(pv[0], pv[1]);
        *reinterpret_cast<__nv_bfloat162*>(dss_p + ro * PS + co * 2) =
            __floats2bfloat162_rn(dv[0], dv[1]);
      }
    __syncthreads();

    // phase 2: acc1 += dS . other1, acc2 += P . other2, over the tile's rows
    const int prow = wr * 16 + lane % 16, pcol = 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < BT; kk += 16) {
      uint32_t ad[4], ap[4];
      ldsm_x4(ad, dss + prow * PS + (kk + pcol) * 2);
      if constexpr (KVM) ldsm_x4(ap, ps + prow * PS + (kk + pcol) * 2);
      if constexpr (NB2 == 1) {
        uint32_t bb[2];
        ldsm_b_trans(bb, oth1 + (kk + lane % 16) * RS + wc * 16);
        mma_bf16(acc1[0], ad, bb);
        if constexpr (KVM) {
          ldsm_b_trans(bb, oth2 + (kk + lane % 16) * RS + wc * 16);
          mma_bf16(acc2[0], ap, bb);
        }
      } else {
        const int krow = kk + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
        for (int nb = 0; nb < NB2; nb += 2) {
          const int n = wc * NB2 * 8 + nb * 8 + 8 * (lane / 16);
          uint32_t bb[4];
          ldsm_a_trans(bb, oth1 + krow * RS + n * 2);
          const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
          mma_bf16(acc1[nb], ad, b0);
          mma_bf16(acc1[nb + 1], ad, b1);
          if constexpr (KVM) {
            ldsm_a_trans(bb, oth2 + krow * RS + n * 2);
            const uint32_t c0[2] = {bb[0], bb[1]}, c1[2] = {bb[2], bb[3]};
            mma_bf16(acc2[nb], ap, c0);
            mma_bf16(acc2[nb + 1], ap, c1);
          }
        }
      }
    }
  };

  if constexpr (KVM) {
    int q_lo, q_hi;
    query_range(own0, BO, a.Sq, a.Skv, a.causal, a.window, q_lo, q_hi);
    for (int g = 0; g < G; ++g)
      for (int o0 = q_lo / BT * BT; o0 < q_hi; o0 += BT)
        step((b * a.H + kvh * G + g), o0);
  } else {
    for (int o0 = t.k_lo / BT * BT; o0 < t.k_hi; o0 += BT) step(bh_own, o0);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // acc1 is dK (or dQ), acc2 dV: rows of the own tile, in bf16
  bf16* out1;
  bf16* out2 = nullptr;
  int valid;
  if constexpr (KVM) {
    const size_t kv_off = (size_t)blockIdx.x * a.Skv * D;
    out1 = static_cast<bf16*>(a.dk) + kv_off;
    out2 = static_cast<bf16*>(a.dv) + kv_off;
    valid = a.Skv;
  } else {
    out1 = static_cast<bf16*>(a.dq) + (size_t)bh_own * a.Sq * D;
    valid = a.Sq;
  }
#pragma unroll
  for (int nb = 0; nb < NB2; ++nb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = own0 + wr * 16 + lane / 4 + 8 * hh;
      const int col = wc * NB2 * 8 + nb * 8 + 2 * (lane % 4);
      if (row < valid) {
        *reinterpret_cast<__nv_bfloat162*>(out1 + (size_t)row * D + col) =
            __floats2bfloat162_rn(acc1[nb][2 * hh], acc1[nb][2 * hh + 1]);
        if constexpr (KVM)
          *reinterpret_cast<__nv_bfloat162*>(out2 + (size_t)row * D + col) =
              __floats2bfloat162_rn(acc2[nb][2 * hh], acc2[nb][2 * hh + 1]);
      }
    }
}

// ---- fp32 on the CUDA cores -----------------------------------------------
// The same two modes with 32-row own and other tiles of fp32 in shared
// memory (the other tile's rows padded to D + 1 words, conflict-free when a
// warp reads one column of 32 rows).  Phase 1: a thread four (own, other)
// pairs, one other row a lane; phase 2: a thread D / 8 elements of each
// gradient, consecutive columns a warp.
constexpr int F_BO = 32, F_BT = 32;

template <int D>
constexpr int bwd_f32_smem_bytes() {
  return (2 * F_BO * D + 2 * F_BT * (D + 1) + 2 * F_BO * (F_BT + 1) + 2 * F_BT) *
         4;
}

template <int D, bool KVM>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_f32_kernel(const BwdArgs a) {
  constexpr int OS = D + 1;                 // words an other-tile row
  constexpr int PS = F_BT + 1;              // words a P/dS row
  constexpr int NE = F_BO * D / BWD_THREADS;
  extern __shared__ float fsm[];
  float* const own1 = fsm;
  float* const own2 = own1 + F_BO * D;
  float* const oth1 = own2 + F_BO * D;
  float* const oth2 = oth1 + F_BT * OS;
  float* const ps = oth2 + F_BT * OS;
  float* const dss = ps + F_BO * PS;
  float* const lse_s = dss + F_BO * PS;
  float* const delta_s = lse_s + F_BT;
  const float* const Q = static_cast<const float*>(a.q);
  const float* const K = static_cast<const float*>(a.k);
  const float* const V = static_cast<const float*>(a.v);
  const float* const dO = static_cast<const float*>(a.dout);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E;
  const float inv_skv = 1.0f / a.Skv;
  int b, kvh, own0, bh_own = 0;
  TileRange t{};
  const float* own1g;
  const float* own2g;
  int own_valid;
  if constexpr (KVM) {
    b = blockIdx.x / a.KV;
    kvh = blockIdx.x % a.KV;
    own0 = blockIdx.y * F_BO;
    own1g = K + (size_t)blockIdx.x * a.Skv * D;
    own2g = V + (size_t)blockIdx.x * a.Skv * D;
    own_valid = a.Skv;
  } else {
    t = tile_range(blockIdx.y, gridDim.y, blockIdx.x, F_BO, a.Sq, a.Skv,
                   a.causal, a.window);
    bh_own = t.bh;
    b = t.bh / a.H;
    kvh = (t.bh % a.H) / G;
    own0 = t.q0;
    own1g = Q + (size_t)t.bh * a.Sq * D;
    own2g = dO + (size_t)t.bh * a.Sq * D;
    own_valid = a.Sq;
    for (int i = tid; i < F_BO; i += BWD_THREADS) {
      const int r = own0 + i;
      const size_t at = (size_t)t.bh * a.Sq + r;
      lse_s[i] = r < a.Sq ? lse_log2(a.lse[at]) : 0.0f;
      delta_s[i] = r < a.Sq ? a.delta[at] : 0.0f;
    }
  }
  for (int e = tid; e < F_BO * D; e += BWD_THREADS) {
    const int r = e / D;
    const bool ok = own0 + r < own_valid;
    const size_t g = (size_t)own0 * D + e;
    own1[e] = ok ? own1g[g] : 0.0f;
    own2[e] = ok ? own2g[g] : 0.0f;
  }
  float acc1[NE], acc2[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) acc1[j] = acc2[j] = 0.0f;

  auto step = [&](int bh, int o0) {
    const float* o1g;
    const float* o2g;
    int valid;
    if constexpr (KVM) {
      o1g = Q + (size_t)bh * a.Sq * D;
      o2g = dO + (size_t)bh * a.Sq * D;
      valid = a.Sq;
    } else {
      const size_t kv_off = ((size_t)b * a.KV + kvh) * a.Skv * D;
      o1g = K + kv_off;
      o2g = V + kv_off;
      valid = a.Skv;
    }
    __syncthreads();
    for (int e = tid; e < F_BT * D; e += BWD_THREADS) {
      const int r = e / D, c = e % D;
      const bool ok = o0 + r < valid;
      const size_t g = (size_t)o0 * D + e;
      oth1[r * OS + c] = ok ? o1g[g] : 0.0f;
      oth2[r * OS + c] = ok ? o2g[g] : 0.0f;
    }
    if constexpr (KVM) {
      for (int i = tid; i < F_BT; i += BWD_THREADS) {
        const int r = o0 + i;
        const size_t at = (size_t)bh * a.Sq + r;
        lse_s[i] = r < a.Sq ? lse_log2(a.lse[at]) : 0.0f;
        delta_s[i] = r < a.Sq ? a.delta[at] : 0.0f;
      }
    }
    __syncthreads();
    float sv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dpv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float x1 = oth1[lane * OS + d], x2 = oth2[lane * OS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sv[i] = fmaf(own1[(warp + 8 * i) * D + d], x1, sv[i]);
        dpv[i] = fmaf(own2[(warp + 8 * i) * D + d], x2, dpv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
      const int qloc = KVM ? lane : r;
      const int qi = KVM ? o0 + lane : own0 + r;
      const int kj = KVM ? own0 + r : o0 + lane;
      float p, ds;
      pair_grads(sv[i], dpv[i], qi, kj, lse_s[qloc], delta_s[qloc], a,
                 scale_log2, inv_skv, p, ds);
      ps[r * PS + lane] = p;
      dss[r * PS + lane] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int e = tid + BWD_THREADS * j;
      const int r = e / D, d = e % D;
#pragma unroll 8
      for (int c = 0; c < F_BT; ++c) {
        acc1[j] = fmaf(dss[r * PS + c], oth1[c * OS + d], acc1[j]);
        if constexpr (KVM)
          acc2[j] = fmaf(ps[r * PS + c], oth2[c * OS + d], acc2[j]);
      }
    }
  };

  if constexpr (KVM) {
    int q_lo, q_hi;
    query_range(own0, F_BO, a.Sq, a.Skv, a.causal, a.window, q_lo, q_hi);
    for (int g = 0; g < G; ++g)
      for (int o0 = q_lo / F_BT * F_BT; o0 < q_hi; o0 += F_BT)
        step(b * a.H + kvh * G + g, o0);
  } else {
    for (int o0 = t.k_lo / F_BT * F_BT; o0 < t.k_hi; o0 += F_BT)
      step(bh_own, o0);
  }

  float* out1;
  float* out2 = nullptr;
  if constexpr (KVM) {
    out1 = static_cast<float*>(a.dk) + (size_t)blockIdx.x * a.Skv * D;
    out2 = static_cast<float*>(a.dv) + (size_t)blockIdx.x * a.Skv * D;
  } else {
    out1 = static_cast<float*>(a.dq) + (size_t)bh_own * a.Sq * D;
  }
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int e = tid + BWD_THREADS * j;
    if (own0 + e / D < own_valid) {
      out1[(size_t)own0 * D + e] = acc1[j];
      if constexpr (KVM) out2[(size_t)own0 * D + e] = acc2[j];
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The three launches of K5b at head dim D; `bf16` picks the tensor-core
// kernels.  The shared-memory limits are raised once a kernel and process.
template <int D, bool BF16>
int launch_bwd(const BwdArgs& a, const void* o, float* delta, int B,
               cudaStream_t stream) {
  const int rows = B * a.H * a.Sq;
  if (BF16)
    flash_bwd_delta_kernel<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(a.dout), delta, rows, D);
  else
    flash_bwd_delta_kernel<float><<<(rows + 7) / 8, 256, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(a.dout), delta,
        rows, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if constexpr (BF16) {
    constexpr int BO = bwd_own_rows<D>();
    constexpr int smem = bwd_smem_bytes<D, BO>();
    static const int attr_kv = set_smem(flash_bwd_bf16_kernel<D, BO, true>, smem);
    static const int attr_q = set_smem(flash_bwd_bf16_kernel<D, BO, false>, smem);
    if (attr_kv) return attr_kv;
    if (attr_q) return attr_q;
    flash_bwd_bf16_kernel<D, BO, true>
        <<<dim3(B * a.KV, (a.Skv + BO - 1) / BO), BWD_THREADS, smem, stream>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    flash_bwd_bf16_kernel<D, BO, false>
        <<<dim3(B * a.H, (a.Sq + BO - 1) / BO), BWD_THREADS, smem, stream>>>(a);
  } else {
    constexpr int smem = bwd_f32_smem_bytes<D>();
    static const int attr_kv = set_smem(flash_bwd_f32_kernel<D, true>, smem);
    static const int attr_q = set_smem(flash_bwd_f32_kernel<D, false>, smem);
    if (attr_kv) return attr_kv;
    if (attr_q) return attr_q;
    flash_bwd_f32_kernel<D, true>
        <<<dim3(B * a.KV, (a.Skv + F_BO - 1) / F_BO), BWD_THREADS, smem,
           stream>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    flash_bwd_f32_kernel<D, false>
        <<<dim3(B * a.H, (a.Sq + F_BO - 1) / F_BO), BWD_THREADS, smem,
           stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,Sq,D), k and v (B,KV,Skv,D), o (B,H,Sq,D), all contiguous of
// dtype (fp32 or bf16) and 16-byte aligned; D in {16, 32, 64, 128, 256}; H
// a multiple of KV.  `lse`, fp32 (B,H,Sq), receives each row's m + log l
// (row_lse) where it is not null.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int KV,
                               int Sq, int Skv, int D, float scale, int causal,
                               int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, window, s
  if (dtype == DTYPE_F32) {
    switch (D) {
      case 16: return launch_f32<16>(ARGS);
      case 32: return launch_f32<32>(ARGS);
      case 64: return launch_f32<64>(ARGS);
      case 128: return launch_f32<128>(ARGS);
      case 256: return launch_f32<256, 8, 16>(ARGS);
    }
  } else if (dtype == DTYPE_BF16) {
    switch (D) {
      case 16: return launch_bf16<16>(ARGS);
      case 32: return launch_bf16<32>(ARGS);
      case 64: return launch_bf16<64>(ARGS);
      case 128: return launch_bf16<128>(ARGS);
      case 256: return launch_bf16<256>(ARGS);
    }
  }
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5b.  q, o, dout, dq (B,H,Sq,D); k, v, dk, dv (B,KV,Skv,D), all contiguous
// of dtype (fp32 or bf16) and 16-byte aligned; lse fp32 (B,H,Sq) as
// flash_attention wrote it for these inputs; delta fp32 (B,H,Sq) scratch.
// dq, dk and dv are written whole (zeros where no pair reaches them).
// Launches three kernels on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const float* lse,
                                   const void* dout, float* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int KV,
                                   int Sq, int Skv, int D, float scale,
                                   int causal, int window, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, H, KV, Sq, Skv,
                  scale, causal, window};
  if (dtype == DTYPE_F32) {
    switch (D) {
      case 16: return launch_bwd<16, false>(a, o, delta, B, s);
      case 32: return launch_bwd<32, false>(a, o, delta, B, s);
      case 64: return launch_bwd<64, false>(a, o, delta, B, s);
      case 128: return launch_bwd<128, false>(a, o, delta, B, s);
      case 256: return launch_bwd<256, false>(a, o, delta, B, s);
    }
  } else if (dtype == DTYPE_BF16) {
    switch (D) {
      case 16: return launch_bwd<16, true>(a, o, delta, B, s);
      case 32: return launch_bwd<32, true>(a, o, delta, B, s);
      case 64: return launch_bwd<64, true>(a, o, delta, B, s);
      case 128: return launch_bwd<128, true>(a, o, delta, B, s);
      case 256: return launch_bwd<256, true>(a, o, delta, B, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
