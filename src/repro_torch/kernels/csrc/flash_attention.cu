// K5: blocked (flash) attention with an online softmax, GQA, causal masking
// and a sliding window.  q (B,H,Sq,D); k, v (B,KV,Skv,D) -> o (B,H,Sq,D).
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
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int KV, int Sq, int Skv, float scale, int causal, int window) {
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
  }
}

template <int D, int LANES = 4, int BKV = 32>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int Sq, int Skv, float scale, int causal,
               int window, cudaStream_t stream) {
  const int nq = (Sq + F32_BQ - 1) / F32_BQ;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (causal || window)
    flash_f32_kernel<D, LANES, BKV, true><<<dim3(B * H, nq), F32_BQ * LANES,
                                            0, stream>>>(
        qf, kf, vf, of, H, KV, Sq, Skv, scale, causal, window);
  else
    flash_f32_kernel<D, LANES, BKV, false><<<dim3(nq, B * H), F32_BQ * LANES,
                                             0, stream>>>(
        qf, kf, vf, of, H, KV, Sq, Skv, scale, causal, window);
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
                  __nv_bfloat16* __restrict__ o, int B, int H, int KV, int Sq,
                  int Skv, float scale_log2, int causal, int window) {
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
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int Sq, int Skv, float scale, int causal,
                int window, cudaStream_t stream) {
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
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B,
      H, KV, Sq, Skv, scale * LOG2E, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,Sq,D), k and v (B,KV,Skv,D), o (B,H,Sq,D), all contiguous of
// dtype (fp32 or bf16) and 16-byte aligned; D in {16, 32, 64, 128, 256}; H
// a multiple of KV.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KV, int Sq, int Skv,
                               int D, float scale, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, B, H, KV, Sq, Skv, scale, causal, window, s
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
