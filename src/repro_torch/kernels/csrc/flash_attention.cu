// K5: blocked (flash) attention with an online softmax, GQA, causal masking
// and a sliding window.  q (B,H,Sq,Dqk), k (B,KV,Skv,Dqk), v (B,KV,Skv,Dv)
// -> o (B,H,Sq,Dv), scores scaled by 1/sqrt(Dqk).  K5b, its backward, is the
// second half of the file.
//
// Positions (the JAX package's _attn_block): query row i sits at i +
// q_offset, key j at j, and only the keys below kv_len (the valid prefix of
// a preallocated cache, one length for the batch) count.  A pair attends
// where key <= query (causal), query - key < window (a window) and key <
// kv_len.  kv_len comes as an int or as a pointer to an int64 on the card,
// which every block reads itself (no copy to the host); it is clamped to
// [0, Skv].  Every tile range and mask below is of these positions; with
// q_offset 0 and kv_len Skv they are the unshifted ones.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), the Pallas TPU kernel whose grid (B*H, Sq/bq, Skv/bk)
// carries m, l and acc in VMEM scratch across the sequential KV dimension.
//
// What bounds it on the H100: the 2*Sq*Skv*(Dqk + Dv) operations of the two
// products over the key range the masks leave, on the tensor cores: bf16 at
// 989 TFLOP/s, fp32 as three TF32 products each at 495 (the FMA pipes' 67
// would be 2.5 times slower); at the ViT's shapes (fp32, D = 32, 5 to 197
// tokens) the launch and the per-block loads.
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
// over all of V's columns (V from shared memory).  Each warpgroup issues
// S_j, moves O to tile j - 1's maximum while S_j runs, issues O += P_{j-1}.
// V_{j-1}, and runs tile j's softmax while that product runs.  The online
// softmax runs in fp32 with ex2 and log2(e) folded into the scale (one FFMA
// an element on unmasked tiles); m and l are reduced across the four
// threads that share a row of the fragment.  K and V arrive through
// two-stage rings filled by cp.async (16 bytes a thread, zero-filled past
// Skv and past the head dim), V one tile behind K: the copies of K_{j+1} and V_j go
// out while the products on tile j run, and one block barrier a tile both
// publishes K_j and V_{j-1} and frees the stages they overwrite.  Every
// thread both copies and computes, so the barrier costs what an mbarrier
// round would; a TMA producer warp with setmaxnreg and ping-pong between
// the warpgroups is later work.  O leaves through the warpgroup's Q tile,
// in the same swizzled layout, so that its rows are written in whole 16-byte
// chunks.  At D = 256 the block holds 193 KB (Q 64 KB, two stages of K and
// V 128 KB, 1 KB to align): one block an SM.
//
// Head dims.  The kernels are templates on (DQK, DV), the head dims of q/k
// and of v, instantiated for the pairs the port's models run (flash_attention
// below): the square 16..256, MLA's (96, 64) (minicpm3-4b: nope 64 + rope
// 32 against v 64), ViT-632M's (80, 80) and (32, 16), the CPU tests' reduced
// MLA.  In bf16, Q and K take ceil(DQK / 64) swizzled 64-column blocks and
// S = Q.K^T runs DQK / 16 k16 steps, so no product reads the zero columns
// past DQK (6 at 96, 5 at 80); V, O and the accumulator take ceil(DV / 64)
// blocks, and P.V runs m64nNk16 over N = 64 ceil(DV / 64) columns: at DV = 80
// a PV<128> over 48 zero-filled columns, 37% more P.V products than an
// m64n80k16 would run, taken because it is the product D = 128 already runs
// (no second fragment layout in the epilogue) and P.V is half the work of
// one tile at most.  A 16-byte chunk of a row never straddles a block edge:
// DQK and DV are multiples of 16 and the chunks start at multiples of 8
// columns, so a chunk lies wholly before or wholly past the dim, which the
// copies zero-fill.  O goes out through the warpgroup's Q tile, so DV needs
// no more blocks than DQK.
//
// fp32 (flash_tf32_kernel, and K5b's fp32 passes below): 3xTF32 on the
// tensor cores, so that fp32 keeps fp32's accuracy (the card's fp32 bar is
// a relative Frobenius error of 1e-4; one TF32 product reads ~1e-3).  An
// operand a splits as mma.cuh's split_tf32 splits it: ah is a truncated to
// TF32, al the remainder truncated again (inf and NaN keep ah, al = 0), and
// a.b = al.bh + ah.bl + ah.bh.  The tensor cores' own accumulation
// truncates, which over a long sum drifts past fp32's rounding (dP - Delta
// cancels at one key; dK and dV sum over G heads and every query row), so
// the large terms ah.bh are summed on the tensor cores from zero over two
// k8 steps (S, dP) or one tile (P V and the other accumulators) and added
// to the running sum in fp32; the small terms run in sums of their own.
// - The route is mma.sync m16n8k8, not wgmma: wgmma takes TF32 operands only
//   K-major from shared memory, so V in P.V (and dO and Q in dV = P^T dO,
//   dK = dS^T Q) would each need a transposed copy, and P and dS could not
//   stay in registers.  mma.sync reads both operands from registers, and P
//   stays in registers: its C fragment (row g, columns 2t and 2t + 1)
//   becomes the A fragment (row g, k t and t + 4) by relabelling the keys
//   inside each 8-key step, k index t + 4i = key 2t + i, for P and for the
//   rows of V it meets alike (tf_c_to_a, tf_split_b).
// - Tiles sit in shared memory as rows of D + 4 words (4 or 20 modulo the
//   32 banks at every head dim served), hi in one array and lo in a second
//   of the same layout, so that the A fragment, B read along a row and B
//   read down the rows each hit the 32 banks once.  They arrive by cp.async
//   (16 bytes a thread, zeros past the rows) into the hi array of one of
//   two stages, the next tile's copies in flight during this tile's
//   products, and each thread splits in place the chunks it copied as soon
//   as they land (tf_load's and tf_split's loops walk the same elements):
//   no barrier between landing and splitting, and warps that finish their
//   products first split while the others still compute; one barrier a
//   tile then publishes it.  Each element is split once a block, not once a
//   product or a warp; P (and dS) are split in registers.
// - A warp owns 16 query rows and runs both products of its rows with the
//   online softmax in fp32 (ex2 with log2(e) / sqrt(DQK) folded in, as in
//   bf16), the masks applied to S after the products, at the finite
//   NEG_INF; a warp whose rows keep no pair of a tile skips it.  Blocks of
//   4 warps (64 rows): 32-key tiles up to head dim 64 (two blocks an SM),
//   16 at 80 and 96 (two blocks); at 128 of 8 warps and 16 keys (198 KB,
//   one block an SM) where those fill the SMs, else of 4 and 32 keys, and
//   of 2 (32 keys) where 64-row blocks would leave SMs idle (the ranks'
//   256-token shapes, the ViT's requests; launch_f32); at 256 of 4 and 8
//   keys, or 2 and 16.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The valid keys: *kv_len_p (on the card) where given, else kv_len, in
// [0, Skv].
__device__ __forceinline__ int valid_keys(const long long* kv_len_p,
                                          int kv_len, int Skv) {
  if (kv_len_p == nullptr) return kv_len;
  const long long n = __ldg(kv_len_p);
  return n < 0 ? 0 : (n > Skv ? Skv : static_cast<int>(n));
}

// A query at position qa sees no key: none lies below kvl, or (a window)
// every one that does lies a window or more before it.
__device__ __forceinline__ bool row_dead(int qa, int kvl, int window) {
  return kvl <= 0 || (window && qa >= kvl + window - 1);
}

// The pair (query at position qa, key kpos) is masked.
__device__ __forceinline__ bool pair_masked(int qa, int kpos, int kvl,
                                            int causal, int window) {
  return (causal && kpos > qa) || (window && qa - kpos >= window) ||
         kpos >= kvl;
}

// Query tile `qi` of `nq` (counted from the last tile under causal masking,
// so that the tiles with the most keys go out first) of head bh, [q0, q0 +
// BQ), and the key range [k_lo, k_hi) it walks (up to kvl, the valid
// keys); `full` when it holds a row that sees no key, which walks every
// key, masked.  A row that sees none is a suffix of the rows: the last
// row's test decides.
struct TileRange {
  int bh, q0, k_lo, k_hi;
  bool full;
};

__device__ __forceinline__ TileRange tile_range(int qi, int nq, int bh,
                                                int BQ, int Sq, int Skv,
                                                int causal, int window,
                                                int q_off, int kvl) {
  TileRange t;
  t.bh = bh;
  t.q0 = (causal ? nq - 1 - qi : qi) * BQ;
  const int q_last = min(t.q0 + BQ, Sq) - 1 + q_off;
  t.full = row_dead(q_last, kvl, window);
  t.k_lo = (window && !t.full) ? max(0, t.q0 + q_off - window + 1) : 0;
  t.k_hi = t.full ? Skv : (causal ? min(kvl, q_last + 1) : kvl);
  return t;
}

// True when keys [k0, k0 + BK) need per-element masking for queries at
// positions [q_first, q_last]: they cross the causal diagonal, the
// window's edge or the end of the valid keys.
__device__ __forceinline__ bool tile_masked(int k0, int BK, int q_first,
                                            int q_last, int kvl, int causal,
                                            int window, bool full) {
  return full || k0 + BK > kvl || (causal && k0 + BK - 1 > q_first) ||
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
// product over all N = 64 * NDB columns of V's blocks at once.
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
// its NDB 64-column blocks (LBO one block); a k16 step is 16 rows, 2 KB.
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

// 64-column swizzled blocks a row of a head dim D.
__host__ __device__ constexpr int col_blocks(int D) {
  return (D + 63) / 64;
}

template <int DQK, int DV>
constexpr int bf16_smem_bytes() {
  // Q (two warpgroups) and two stages of K, two stages of V, and 1 KB to
  // align to 1 KB.
  return (4 * col_blocks(DQK) + 2 * col_blocks(DV)) * BLOCK_BYTES + 1024;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int B, int H, int KV, int Sq, int Skv, float scale_log2,
                  int causal, int window, int q_off, int kv_len,
                  const long long* __restrict__ kv_len_p) {
  constexpr int NDQ = col_blocks(DQK);     // 64-column blocks of q and k
  constexpr int NDV = col_blocks(DV);      // of v and o
  static_assert(DQK % 16 == 0 && DV % 16 == 0 && NDV <= NDQ,
                "k16 steps over q.k; O leaves through Q's tile");
  constexpr int TILE = NDQ * BLOCK_BYTES;    // one 64-row Q or K tile
  constexpr int TILE_V = NDV * BLOCK_BYTES;  // one 64-row V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;                   // 2 x TILE
  const uint32_t k_smem = base + 2 * TILE;        // 2 stages x TILE
  const uint32_t v_smem = base + 4 * TILE;        // 2 stages x TILE_V

  // Grid (B*H, query tiles): every head's tile qi goes out before any
  // head's tile qi + 1, the heaviest first under causal masking.
  const int kvl = valid_keys(kv_len_p, kv_len, Skv);
  const TileRange t = tile_range(blockIdx.y, gridDim.y, blockIdx.x, BQ, Sq,
                                 Skv, causal, window, q_off, kvl);
  const int b = t.bh / H;
  const int kvh = (t.bh % H) / (H / KV);
  const __nv_bfloat16* qg = q + (size_t)t.bh * Sq * DQK;
  const __nv_bfloat16* kg = k + ((size_t)b * KV + kvh) * Skv * DQK;
  const __nv_bfloat16* vg = v + ((size_t)b * KV + kvh) * Skv * DV;

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

  float acc[NDV * 32];          // O, 64 x 64 NDV a warpgroup
#pragma unroll
  for (int i = 0; i < NDV * 32; ++i) acc[i] = 0.0f;
  float s[32];                  // S of a tile, then P, in fp32
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  uint32_t p[4][4] = {};        // P in bf16, the A fragments of P.V
  // m in the scores' own units; alpha rescales O when P.V next runs.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float alpha[2] = {1.0f, 1.0f};

  if (j_lo < j_hi) {
    load_tile<BQ, NDQ>(q_smem, qg, t.q0, Sq, DQK);
    load_tile<BK, NDQ>(k_smem, kg, j_lo * BK, Skv, DQK);
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
    qk_products<DQK / 16>(s, qd, wgmma_desc(k_smem + stage * TILE, 16, 1024));
    wgmma_commit();
    // The next copies go out while S_j runs.
    if (j + 1 < j_hi)
      load_tile<BK, NDQ>(k_smem + (stage ^ 1) * TILE, kg, (j + 1) * BK, Skv,
                         DQK);
    load_tile<BK, NDV>(v_smem + stage * TILE_V, vg, j * BK, Skv, DV);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (j > j_lo) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int i = 0; i < NDV * 32; ++i) acc[i] *= alpha[(i / 2) % 2];
      }
      fence_regs(acc);
      wgmma_fence();
      pv_product<NDV>(acc, p, v_smem + (stage ^ 1) * TILE_V);
      wgmma_wait<1>();          // S_j done; P_{j-1}.V_{j-1} may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    // Online softmax in fp32: m in the scores' units, 2^(s * c - m * c)
    // with c = log2(e) / sqrt(DQK), one FFMA and one ex2 an element where no
    // score is masked.
    const int k0 = j * BK;
    const bool masked = tile_masked(k0, BK, wq0 + q_off, wq0 + 63 + q_off,
                                    kvl, causal, window, t.full);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      if (masked) {
        const int kpos = k0 + 8 * (i / 4) + col0 + (i % 2);
        if (pair_masked(qpos[r] + q_off, kpos, kvl, causal, window))
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
    for (int i = 0; i < NDV * 32; ++i) acc[i] *= alpha[(i / 2) % 2];
    fence_regs(acc);
    wgmma_fence();
    pv_product<NDV>(acc, p, v_smem + ((j_hi - 1 - j_lo) & 1) * TILE_V);
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
  for (int i = 0; i < NDV * 32; i += 2) {
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
  constexpr int CH = NDV * 8;                    // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < 64 * CH / 128; ++it) {
    const int e = it * 128 + threadIdx.x % 128;
    const int row = e / CH, db = (e % CH) / 8, c = e % 8;
    const int col = db * 64 + c * 8;
    if (wq0 + row < Sq && col < DV)
      *reinterpret_cast<uint4*>(o + ((size_t)t.bh * Sq + wq0 + row) * DV + col) =
          *reinterpret_cast<const uint4*>(o_tile + db * BLOCK_BYTES + row * 128 +
                                          ((c ^ (row % 8)) * 16));
  }
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int Sq, int Skv, float scale,
                int causal, int window, int q_off, int kv_len,
                const long long* kv_len_p, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<DQK, DV>();
  static bool configured = false;  // once per head-dim pair and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<DQK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_bf16_kernel<DQK, DV><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      B, H, KV, Sq, Skv, scale * LOG2E, causal, window, q_off, kv_len,
      kv_len_p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on the tensor cores (mma.sync m16n8k8).  The route, the
// split, the tiles and the relabelled keys are set out in the note at the
// top of the file; the helpers below serve K5's fp32 forward and both
// passes of K5b's fp32 backward.

// Words a row of a D-column fp32 tile in shared memory: D + 4, which is 4
// or 20 modulo the 32 banks at every head dim served, so that each of the
// three fragment reads below hits the 32 banks once.
__host__ __device__ constexpr int tf_stride(int D) { return D + 4; }

// Rows [row0, row0 + ROWS) of a (rows_valid, D) fp32 matrix into the hi
// array `h` of a tile, 16 bytes a thread by cp.async, zeros past
// rows_valid (D is a multiple of 8, so a chunk never straddles a row).
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void tf_load(float* h, const float* g, int row0,
                                        int rows_valid) {
  constexpr int C4 = D / 4, SD = tf_stride(D);
  for (int e = threadIdx.x; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = e % C4;
    const bool ok = row0 + r < rows_valid;
    cp_async16(smem_u32(h + r * SD + 4 * c),
               ok ? g + (size_t)(row0 + r) * D + 4 * c : g, ok);
  }
}

// A landed tile split in place, once a block: `h` keeps each value
// truncated to TF32, `l` (the same layout) the remainder truncated again
// (mma.cuh's split_tf32: inf and NaN keep hi and take lo = 0).  The walk
// is tf_load's, so each thread splits the chunks it copied, once its own
// copies have landed, with no barrier between.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void tf_split(float* h, float* l) {
  constexpr int C4 = D / 4, SD = tf_stride(D);
  for (int e = threadIdx.x; e < ROWS * C4; e += THREADS) {
    const int at = e / C4 * SD + 4 * (e % C4);
    const uint4 x = *reinterpret_cast<const uint4*>(h + at);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(h + at) = hi;
    *reinterpret_cast<uint4*>(l + at) = lo;
  }
}

// d (16 x 8, fp32) += a . b, TF32 operands: mma.cuh's mma_tf32 without
// `volatile`, so that the compiler may interleave independent products.
__device__ __forceinline__ void tf_mma(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b, TF32 operands, from a zero accumulator.
__device__ __forceinline__ void tf_mma0(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// The A fragment of rows r0 + g and r0 + g + 8, k columns c0 + t and c0 +
// t + 4 (g = lane / 4, t = lane % 4) of a row-major tile: hi from h, lo
// from l.
template <int SD>
__device__ __forceinline__ void tf_frag_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                          const float* h, const float* l,
                                          int r0, int c0, int lane) {
  const int at = (r0 + lane / 4) * SD + c0 + lane % 4;
  const int off[4] = {0, 8 * SD, 4, 8 * SD + 4};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ah[r] = __float_as_uint(h[at + off[r]]);
    al[r] = __float_as_uint(l[at + off[r]]);
  }
}

// The B fragment with k along a row: n is row n0 + g, k columns c0 + t and
// c0 + t + 4 (K in S = Q K^T, V in dP = dO V^T, Q and dO in the dK/dV
// pass's transposed scores).
template <int SD>
__device__ __forceinline__ void tf_frag_b_row(uint32_t (&bh)[2],
                                              uint32_t (&bl)[2],
                                              const float* h, const float* l,
                                              int n0, int c0, int lane) {
  const int at = (n0 + lane / 4) * SD + c0 + lane % 4;
  bh[0] = __float_as_uint(h[at]);
  bh[1] = __float_as_uint(h[at + 4]);
  bl[0] = __float_as_uint(l[at]);
  bl[1] = __float_as_uint(l[at + 4]);
}

// The B fragment with k down the rows, keys relabelled: k index t + 4 r is
// row k0 + 2 t + r, n is column n0 + g (V in P V, K in dS K, dO in P^T dO, Q
// in dS^T Q).
template <int SD>
__device__ __forceinline__ void tf_frag_b_col(uint32_t (&bh)[2],
                                              uint32_t (&bl)[2],
                                              const float* h, const float* l,
                                              int k0, int n0, int lane) {
  const int at = (k0 + 2 * (lane % 4)) * SD + n0 + lane / 4;
  bh[0] = __float_as_uint(h[at]);
  bh[1] = __float_as_uint(h[at + SD]);
  bl[0] = __float_as_uint(l[at]);
  bl[1] = __float_as_uint(l[at + SD]);
}

// An accumulator fragment c (rows g and g + 8, columns 2t and 2t + 1) as
// the A fragment of the next product, split: k index t is column 2t and t
// + 4 column 2t + 1, the relabelling tf_frag_b_col reads its rows in.
__device__ __forceinline__ void tf_c_to_a(const float (&c)[4],
                                          uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  split_tf32(__float_as_uint(c[0]), ah[0], al[0]);
  split_tf32(__float_as_uint(c[2]), ah[1], al[1]);
  split_tf32(__float_as_uint(c[1]), ah[2], al[2]);
  split_tf32(__float_as_uint(c[3]), ah[3], al[3]);
}

// c (16 x 8 NT) = A . B^T over D: A the 16 rows from r0 of tile (ah_, al_)
// (stride SA), B the 8 NT rows of tile (bh_, bl_) (stride SB), both with k
// along their rows.  The small terms al.bh and ah.bl run on in two
// accumulators of their own across the k8 steps; the large term ah.bh is
// summed on the tensor cores from zero over two steps at a time and added
// to c in fp32: the tensor cores' own accumulation truncates, and over a
// long sum of the large terms that drifts past fp32's rounding (dP - Delta
// cancels at one key).  The three sums are independent, so no product
// waits on the one before it.
template <int D, int NT, int SA, int SB>
__device__ __forceinline__ void tf_scores(float (&c)[NT][4], const float* ah_,
                                          const float* al_, int r0,
                                          const float* bh_, const float* bl_,
                                          int lane) {
  static_assert(D % 16 == 0, "k8 steps in pairs");
  float c1[NT][4], c2[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = c1[n][i] = c2[n][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ks += 2) {
    float t[NT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      tf_frag_a<SA>(ah, al, ah_, al_, r0, 8 * (ks + h), lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        tf_frag_b_row<SB>(bh[n], bl[n], bh_, bl_, 8 * n, 8 * (ks + h), lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        tf_mma(c1[n], al, bh[n]);
        tf_mma(c2[n], ah, bl[n]);
        if (h == 0)
          tf_mma0(t[n], ah, bh[n]);
        else
          tf_mma(t[n], ah, bh[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] += t[n][i];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] += c1[n][i] + c2[n][i];
}

// acc (16 x 8 N) += A . B over NT k8 steps: A the NT A fragments (ah, al)
// (accumulator fragments made A fragments, tf_c_to_a), B rows 0 .. 8 NT -
// 1 of tile (bh_, bl_) (stride SB), columns n_base + 8 n.  The 8-column
// blocks go in groups of GRP; a group's large terms and its small terms
// over the NT steps are summed on the tensor cores from zero, in two sums
// that do not wait on each other, and added to acc in fp32, as in
// tf_scores, so that no running sum is left to the tensor cores'
// truncating accumulation over more than one tile.
template <int N, int NT, int SB>
__device__ __forceinline__ void tf_accumulate(float (&acc)[N][4],
                                              const uint32_t (&ah)[NT][4],
                                              const uint32_t (&al)[NT][4],
                                              const float* bh_,
                                              const float* bl_, int n_base,
                                              int lane) {
  constexpr int GRP = N % 4 == 0 && N <= 16 ? 4 : 2;
  static_assert(N % GRP == 0, "whole groups");
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += GRP) {
    float tb[GRP][4], ts[GRP][4];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      uint32_t bh[GRP][2], bl[GRP][2];
#pragma unroll
      for (int u = 0; u < GRP; ++u)
        tf_frag_b_col<SB>(bh[u], bl[u], bh_, bl_, 8 * k,
                          n_base + 8 * (n0 + u), lane);
#pragma unroll
      for (int u = 0; u < GRP; ++u) {
        if (k == 0) {
          tf_mma0(ts[u], al[k], bh[u]);
          tf_mma0(tb[u], ah[k], bh[u]);
        } else {
          tf_mma(ts[u], al[k], bh[u]);
          tf_mma(tb[u], ah[k], bh[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < GRP; ++u) tf_mma(ts[u], ah[k], bl[u]);
    }
#pragma unroll
    for (int u = 0; u < GRP; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + u][i] += tb[u][i] + ts[u][i];
  }
}

// No pair of keys [k0, k0 + nk) and queries at positions [qa, qa + nq) is
// kept: the keys lie past the valid ones, above the causal diagonal, or a
// window or more before the queries.
__device__ __forceinline__ bool tf_none_kept(int k0, int nk, int qa, int nq,
                                             int kvl, int causal,
                                             int window) {
  return k0 >= kvl || (causal && k0 > qa + nq - 1) ||
         (window && qa - (k0 + nk - 1) >= window);
}

// ---- K5's forward ----------------------------------------------------------
// NW warps of 16 query rows each (BQ = 16 NW rows a block), BK keys a tile.
// Q (split once) and two stages of K and V (hi and lo each) in dynamic
// shared memory, sized so that an SM holds eight warps where it can: up
// to head dim 96, two blocks of four (BK 32, or 16 at 80 and 96; 86-104
// KB each); at 128 one block of eight (BK 16, 198 KB), or of four or two
// (BK 32) where the grid is small; at 256 one block of four (BK 8) or two
// (BK 16).
template <int DQK, int DV, int NW>
struct TfFwd {
  static constexpr int BQ = 16 * NW, THREADS = 32 * NW;
  static constexpr int BK = DQK <= 64 ? 32
                            : DQK < 128 ? 16
                            : DQK == 128 ? (NW == 8 ? 16 : 32)
                            : (NW == 4 ? 8 : 16);
  static constexpr int SQ = tf_stride(DQK), SV = tf_stride(DV);
  static constexpr int QW = BQ * SQ;                 // Q's hi (or lo) words
  static constexpr int KW = BK * SQ, VW = BK * SV;   // a K (V) tile's
  static constexpr int STAGE = 2 * (KW + VW);        // K hi, lo, V hi, lo
  static constexpr int SMEM = 4 * (2 * QW + 2 * STAGE);
};

template <int DQK, int DV, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int H, int KV, int Sq, int Skv,
                  float scale, int causal, int window, int q_off, int kv_len,
                  const long long* __restrict__ kv_len_p) {
  using C = TfFwd<DQK, DV, NW>;
  constexpr int BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  constexpr int SQ = C::SQ, SV = C::SV, NT = BK / 8, NV = DV / 8;
  static_assert(DQK % 8 == 0 && DV % 8 == 0, "k8 steps and n8 tiles");
  extern __shared__ float4 tf_smem[];
  float* const qh = reinterpret_cast<float*>(tf_smem);
  float* const ql = qh + C::QW;
  float* const st0 = ql + C::QW;   // stage s at st0 + s STAGE

  const int kvl = valid_keys(kv_len_p, kv_len, Skv);
  const TileRange tr = tile_range(blockIdx.y, gridDim.y, blockIdx.x, BQ, Sq,
                                  Skv, causal, window, q_off, kvl);
  const int b = tr.bh / H, kvh = (tr.bh % H) / (H / KV);
  const float* const qg = q + (size_t)tr.bh * Sq * DQK;
  const float* const kg = k + ((size_t)b * KV + kvh) * Skv * DQK;
  const float* const vg = v + ((size_t)b * KV + kvh) * Skv * DV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16;                   // the warp's rows in the block
  const int row0 = tr.q0 + wr + lane / 4;     // this thread's: row0, row0 + 8
  const int qa = tr.q0 + wr + q_off;          // the warp's first position
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;
  const int j_lo = tr.k_lo / BK, j_hi = (tr.k_hi + BK - 1) / BK;

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  // m in the scores' own units, l a per-thread partial sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  // A stage: K hi, K lo, V hi, V lo.  Each thread splits the chunks it
  // copied (tf_load's and tf_split's loops walk the same elements), so a
  // tile is split as soon as this thread's copies land, with no barrier
  // between; the barrier after publishes the split tile.
  auto stage = [&](int st) { return st0 + st * C::STAGE; };
  auto load_kv = [&](int j, int st) {
    tf_load<BK, DQK, THREADS>(stage(st), kg, j * BK, Skv);
    tf_load<BK, DV, THREADS>(stage(st) + 2 * C::KW, vg, j * BK, Skv);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto split_kv = [&](int st) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    tf_split<BK, DQK, THREADS>(stage(st), stage(st) + C::KW);
    tf_split<BK, DV, THREADS>(stage(st) + 2 * C::KW,
                              stage(st) + 2 * C::KW + C::VW);
  };
  if (j_lo < j_hi) {
    tf_load<BQ, DQK, THREADS>(qh, qg, tr.q0, Sq);
    load_kv(j_lo, 0);
    split_kv(0);
    tf_split<BQ, DQK, THREADS>(qh, ql);
  }
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    const float* const kh = stage(st);
    const float* const kl = kh + C::KW;
    const float* const vh = kl + C::KW;
    const float* const vl = vh + C::VW;
    // tile j + 1's copies go to the other stage (tile j - 1's, which every
    // warp is done with) and land while tile j's products run
    if (j + 1 < j_hi) load_kv(j + 1, st ^ 1);
    const int k0 = j * BK;
    // a warp whose rows keep no pair of the tile skips it (unless the block
    // holds a row that sees no key: such a row weighs every key)
    if (tr.full || !tf_none_kept(k0, BK, qa, 16, kvl, causal, window)) {
      float s[NT][4];
      tf_scores<DQK, NT, SQ, SQ>(s, qh, ql, wr, kh, kl, lane);

      // The online softmax in fp32, as the bf16 kernel's: m in the scores'
      // units, 2^(s c - m c) with c = log2(e) / sqrt(DQK), masks applied to S
      // after the products.
      const bool masked = tile_masked(k0, BK, qa, qa + 15, kvl, causal, window,
                                      tr.full);
      float tmax[2] = {-INFINITY, -INFINITY};
  #pragma unroll
      for (int n = 0; n < NT; ++n)
  #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i / 2;
          if (masked) {
            const int kpos = k0 + 8 * n + col0 + (i % 2);
            if (pair_masked(row0 + 8 * r + q_off, kpos, kvl, causal, window))
              s[n][i] = NEG_INF;
            if (kpos >= Skv) s[n][i] = -INFINITY;  // past the end: weight 0
          }
          tmax[r] = fmaxf(tmax[r], s[n][i]);
        }
      float alpha[2];
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
        // s - m first: exactly 0 where both are NEG_INF (a row that has seen
        // no key)
  #pragma unroll
        for (int n = 0; n < NT; ++n)
  #pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[n][i] = ex2((s[n][i] - m[i / 2]) * scale_log2);
            psum[i / 2] += s[n][i];
          }
      } else {
        const float mc[2] = {m[0] * scale_log2, m[1] * scale_log2};
  #pragma unroll
        for (int n = 0; n < NT; ++n)
  #pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[n][i] = ex2(fmaf(s[n][i], scale_log2, -mc[i / 2]));
            psum[i / 2] += s[n][i];
          }
      }
      l[0] = l[0] * alpha[0] + psum[0];
      l[1] = l[1] * alpha[1] + psum[1];
  #pragma unroll
      for (int n = 0; n < NV; ++n)
  #pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i / 2];
      // O += P V, P split in registers as the A fragments of the tile's
      // NT 8-key steps
      uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) tf_c_to_a(s[n], ph[n], pl[n]);
      tf_accumulate<NV, NT, SV>(acc, ph, pl, vh, vl, 0, lane);
    }
    // tile j + 1 split as it lands, then published, and stage st freed for
    // tile j + 2
    if (j + 1 < j_hi) split_kv(st ^ 1);
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Sq)
        lse[(size_t)tr.bh * Sq + row0 + 8 * r] =
            row_lse(m[r] == NEG_INF ? NEG_INF : m[r] * scale, l[r]);
  }
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Sq)
        *reinterpret_cast<float2*>(o + ((size_t)tr.bh * Sq + row0 + 8 * r) *
                                           DV + 8 * n + col0) =
            make_float2(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
}

template <int DQK, int DV, int NW>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int Sq, int Skv,
                float scale, int causal, int window, int q_off, int kv_len,
                const long long* kv_len_p, cudaStream_t stream) {
  using C = TfFwd<DQK, DV, NW>;
  static const int attr =
      static_cast<int>(cudaFuncSetAttribute(
          flash_tf32_kernel<DQK, DV, NW>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (attr) return attr;
  const dim3 grid(B * H, (Sq + C::BQ - 1) / C::BQ);
  flash_tf32_kernel<DQK, DV, NW><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Sq,
      Skv, scale, causal, window, q_off, kv_len, kv_len_p);
  return static_cast<int>(cudaGetLastError());
}

// K5 in fp32: blocks of four warps (64 query rows); at head dim 128 of
// eight (128 rows) where those fill the SMs; of two (32) where 64-row
// blocks would leave SMs idle.
template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KV, int Sq, int Skv, float scale,
               int causal, int window, int q_off, int kv_len,
               const long long* kv_len_p, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long heads = (long long)B * H;
  if constexpr (DQK == 128) {
    if (heads * ((Sq + 127) / 128) >= sms)
      return launch_tf32<DQK, DV, 8>(q, k, v, o, lse, B, H, KV, Sq, Skv,
                                     scale, causal, window, q_off, kv_len,
                                     kv_len_p, stream);
  }
  if (heads * ((Sq + 63) / 64) >= sms)
    return launch_tf32<DQK, DV, 4>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale,
                                   causal, window, q_off, kv_len, kv_len_p,
                                   stream);
  return launch_tf32<DQK, DV, 2>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale,
                                 causal, window, q_off, kv_len, kv_len_p,
                                 stream);
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
// constant mask value).  Two passes on one stream, in bf16 and in fp32
// alike: the dQ pass, one block per (b, head, query tile) walking the key
// tiles, runs first and computes Delta of its rows on the way; then the
// dK/dV pass, one block per (b, KV head, key tile) and rank of a cluster
// that splits the G heads, walking its heads and the query tiles the masks
// leave.  dK, dV and dQ each accumulate
// in registers and are written once, in a fixed order (no atomics:
// deterministic); both passes recompute S and dP, so the backward runs
// seven products where the least is five (dQ's atomics are the price of
// five).

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;
  const float* lse;
  float* delta;       // written by the dQ pass, read by the dK/dV pass
  void* dq;
  void* dk;
  void* dv;
  int H, KV, Sq, Skv;
  float scale;
  int causal, window;
  int q_off, kv_len;              // the positions' shift, the valid keys
  const long long* kv_len_p;      // the valid keys on the card, or null
};

// The query rows [q_lo, q_hi) that see any of keys [k0, k0 + BK) below
// the kvl valid keys, a row i at position i + q_off: causal rows from k0 -
// q_off on, with a window those before k0 + BK - 1 + window - q_off; and
// from the first row that sees no key on (row_dead), every row to Sq,
// since such rows weigh every key
// (kernels/flash_attention.py::bwd_query_tiles in 64-row tiles).
__device__ __forceinline__ void query_range(int k0, int BK, int Sq, int causal,
                                            int window, int q_off, int kvl,
                                            int& q_lo, int& q_hi) {
  q_lo = Sq;
  q_hi = 0;
  if (k0 < kvl) {
    q_lo = causal ? max(0, k0 - q_off) : 0;
    q_hi = window ? min(Sq, k0 + BK - 1 + window - q_off) : Sq;
  }
  const int dead = kvl <= 0 ? 0
                   : (window ? max(0, kvl + window - 1 - q_off) : Sq);
  if (dead < Sq) {
    q_lo = q_hi <= q_lo ? dead : min(q_lo, dead);
    q_hi = Sq;
  }
}

// P and dS * scale of one (query, key) pair from the recomputed score s (in
// the scores' own units, unscaled) and dP; l2 is the row's lse * log2(e),
// -inf for a row that saw no key.
__device__ __forceinline__ void pair_grads(float s, float dp, int qi, int kj,
                                           float l2, float delta,
                                           const BwdArgs& a, int kvl,
                                           float scale_log2, float inv_skv,
                                           float& p, float& ds) {
  const bool valid = qi < a.Sq && kj < a.Skv;
  p = 0.0f;
  ds = 0.0f;
  if (l2 == -INFINITY) {
    p = valid ? inv_skv : 0.0f;
  } else if (valid &&
             !pair_masked(qi + a.q_off, kj, kvl, a.causal, a.window)) {
    p = exp2f(fmaf(s, scale_log2, -l2));
    ds = p * (dp - delta) * a.scale;
  }
}

__device__ __forceinline__ float lse_log2(float lse) {
  return lse == NEG_INF ? -INFINITY : lse * LOG2E;
}

// ---- bf16 on the tensor cores (wgmma) -------------------------------------
// A block owns 64 or 128 rows (keys of a KV head for dK/dV, query rows of
// a head for dQ) and keeps them in shared memory with their second operand
// (V, dO) for the whole walk; the other side (Q and dO, or K and V)
// streams through in 64-row tiles.  Tiles are K5's 128-byte-swizzled
// 64-column blocks, copied by K5's load_tile (cp.async, 16 bytes a thread,
// zeros past the rows and past D), so that every product is a wgmma with
// fp32 accumulators: S and dP (own . other^T) with both operands in shared
// memory, dV += P^T dO, dK += dS^T Q and dQ += dS K with P or dS, the
// accumulator fragment rounded to bf16, as A and the other tile read as an
// MN-major B (K5's P.V).
// - D <= 128 (SOLO): each warpgroup owns 64 of the block's 128 rows and
//   runs all of its products (S, dP, then dV and dK, or dQ) with no
//   hand-over, so each other tile serves 128 rows and one warpgroup's
//   softmax runs while the other's products do.  dK/dV at D 128: 64 + 64
//   accumulator registers a thread, so dV's product runs while dS is
//   formed and dK's A fragments take P's registers once it is done.
// - D = 256: dK and dV alone take 128 registers a thread, so the two
//   warpgroups split the products of a step, not the rows: both take the
//   block's 64 rows as the M side; warpgroup 0 runs S and forms P =
//   exp(S - lse), warpgroup 1 runs dP and, once warpgroup 0 has left P in
//   shared memory (a named barrier, arrive/sync), forms dS = P (dP -
//   Delta) scale.  Their fragments match element for element, so P passes
//   in fragment order.  Warpgroup 0 accumulates dV, warpgroup 1 dK; dQ's
//   columns split in two halves (warpgroup 1 leaves dS's fragments in
//   shared memory for warpgroup 0).
// - Copies behind products: two stages of the other side's tiles (and, for
//   dK/dV, its rows' lse and Delta, 4-byte cp.async).  The block barrier
//   that opens step s publishes step s's tiles and frees the stage of step
//   s - 1, and step s + 1's copies go out before step s's products.
// - dK/dV spread over a cluster: the G query heads of a KV head split over
//   the R ranks of a thread-block cluster (rank r takes heads r, r + R,
//   ...; R <= 8 from kernels/flash_attention.py::bwd_plan).  Each rank
//   accumulates its heads' dK and dV in a fixed order, leaves the fp32
//   partials in its shared memory, and after a cluster barrier each rank
//   sums a slice of the rows over the ranks in rank order (distributed
//   shared memory) and writes it: no atomics, the same bytes every call.
//   Key tiles go out heaviest first (under causal masking the first).
// - dQ stays its own deterministic pass, one block a (b, head, own query
//   rows), the heaviest query tiles first.  It runs first and computes
//   Delta = rowsum(dO o O) of its rows on the way (for itself, and into
//   the scratch the dK/dV pass reads), so no launch of its own reads O.
// - Masking as K5: only tiles that cross the causal diagonal, the window's
//   edge, the end of either sequence or hold a row that sees no key are
//   masked pair by pair, with selects, in a copy of the step of their own,
//   so that the other tiles' copy has no masking code (and no registers
//   for it).  A warpgroup whose 64 rows keep no pair of a tile (SOLO: the
//   first query tile of the upper keys, the last key tile of the lower
//   query rows) skips it.
// - Head dims (DQK, DV), the pairs of kernels/flash_attention.py::
//   HEAD_DIM_PAIRS, as K5's forward: the square 16..256, MLA's (96, 64),
//   ViT-632M's (80, 80) and (32, 16).  Q, K, dQ and dK take ceil(DQK / 64)
//   swizzled 64-column blocks, V, O, dO and dV ceil(DV / 64).  S = Q K^T runs
//   DQK / 16 k16 steps and dP = dO V^T DV / 16, so no product's depth reads
//   the zero columns past a dim.  dV = P^T dO and dK = dS^T Q (dQ = dS K)
//   run m64nNk16 over N = 64 ceil(DV / 64) (64 ceil(DQK / 64)) columns, the
//   products and fragment layouts of the square dims: at 80 and 96 a
//   PV<128> over 48 or 32 zero-filled columns, which the epilogue does not
//   write.  Up to 128 both dims are SOLO; D 256 is square.
// At D 256 a block holds 218 KB of shared memory (own 64 KB, two stages of
// 64 KB, P 16 KB, dS 8 KB, the rows' lse and Delta), at D 128 and (80, 80)
// 133 KB (own 64 KB, two stages of 32 KB, which the fp32 partials outgrow
// at the end), at (96, 64) 97 KB of tiles and 84 KB of partials: one block
// an SM.
constexpr int BWD_THREADS = 256;
constexpr int MAX_CLUSTER = 8;

// A warpgroup owns 64 rows of its own (SOLO) up to head dims of 128.
template <int DQK, int DV>
__host__ __device__ constexpr bool bwd_solo() {
  return DQK <= 128 && DV <= 128;
}

// Own rows a block: 64 a warpgroup (SOLO) or 64 shared.
template <int DQK, int DV>
__host__ __device__ constexpr int bwd_rows() {
  return bwd_solo<DQK, DV>() ? 128 : 64;
}

// Stages of the other side's tiles: two (a third at D <= 128 bought nothing,
// tools/k5b_ablate.py; at D 256 shared memory holds no more).
template <int DQK>
__host__ __device__ constexpr int bwd_stages() {
  return 2;
}

template <int DQK, int DV>
constexpr int bwd_bf16_smem_bytes() {
  // a 64-row tile of each side's pair: (Q or K) and (dO or V)
  constexpr int pair = (col_blocks(DQK) + col_blocks(DV)) * BLOCK_BYTES;
  constexpr int nst = bwd_stages<DQK>();
  // SOLO: own (2 x the pair), the stages of other (a pair each) tiles and
  // of 64 lse and 64 Delta; else own (a pair), stages, P fp32 64 x 64, dS's
  // bf16 fragments and the stages' rows; the rank's fp32 dV and dK
  // partials reuse the tiles; 1 KB to align
  constexpr int main = bwd_solo<DQK, DV>()
      ? (2 + nst) * pair + nst * 512
      : (1 + nst) * pair + 64 * 64 * 4 + 64 * 64 * 2 + nst * 512;
  constexpr int red = bwd_rows<DQK, DV>() * (DV + 4 + DQK + 4) * 4;
  return (main > red ? main : red) + 1024;
}

// Every copy group but the last N has landed: made visible to the tensor
// cores' (async proxy) reads, then a barrier of the block.
template <int N>
__device__ __forceinline__ void publish_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// 4 bytes global -> shared, zero-filled where !ok (src is then not read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Named barrier `id` over the block's 256 threads: one warpgroup arrives
// (its writes before are seen), the other waits.
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// True when query rows [q0, q0 + 64) hold one that sees no key (the
// last row's test decides: such rows are a suffix).
__device__ __forceinline__ bool tile_dead_rows(int q0, const BwdArgs& a,
                                               int kvl) {
  return row_dead(q0 + 63 + a.q_off, kvl, a.window);
}

// True when no pair of keys [k0, k0 + 64) and query rows [q0, q0 + 64) is
// kept: the tile lies past the query rows' end or the valid keys, above
// the shifted causal diagonal or beyond the window.
__device__ __forceinline__ bool pair_tile_empty(int k0, int q0,
                                                const BwdArgs& a, int kvl) {
  return k0 >= kvl || q0 >= a.Sq || (a.causal && k0 > q0 + 63 + a.q_off) ||
         (a.window && q0 + a.q_off - k0 - 63 >= a.window);
}

// True when keys [k0, k0 + 64) and query rows [q0, q0 + 64) need per-pair
// masking: the tile crosses the shifted causal diagonal or the window's
// edge, runs past the valid keys or Sq, or holds a query row that sees no
// key.
__device__ __forceinline__ bool pair_tile_masked(int k0, int q0,
                                                 const BwdArgs& a, int kvl) {
  return k0 + 64 > kvl || q0 + 64 > a.Sq ||
         (a.causal && k0 + 63 > q0 + a.q_off) ||
         (a.window && q0 + 63 + a.q_off - k0 >= a.window) ||
         tile_dead_rows(q0, a, kvl);
}

template <int DQK, int DV, bool KVM>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_bf16_kernel(const BwdArgs a) {
  constexpr int NDQ = col_blocks(DQK);      // 64-column blocks of q, k
  constexpr int NDV = col_blocks(DV);       // of v, o, dO
  constexpr int TQ = NDQ * BLOCK_BYTES;     // one 64-row tile of Q or K
  constexpr int TV = NDV * BLOCK_BYTES;     // of dO or V
  constexpr bool SOLO = bwd_solo<DQK, DV>();  // a warpgroup its own 64 rows
  static_assert(DQK % 16 == 0 && DV % 16 == 0 && (SOLO || DQK == DV),
                "k16 steps over each dim; D 256 square");
  constexpr int ROWS = bwd_rows<DQK, DV>();   // own rows a block
  constexpr int OWN = SOLO ? 2 : 1;         // own tiles of each operand
  constexpr int NST = bwd_stages<DQK>();    // stages of the other tiles
  // dQ's columns split over the warpgroups at D 256
  constexpr bool SPLIT = !KVM && !SOLO;
  // dV's accumulator (dK's too at D 256), or dQ's
  constexpr int NACC = KVM ? NDV * 32 : (SPLIT ? NDQ * 16 : NDQ * 32);
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_p = smem_raw + (base - smem_u32(smem_raw));
  // own1 holds K (dK/dV) or Q (dQ), own2 V or dO
  const uint32_t own1 = base, own2 = base + OWN * TQ;
  // stage s: other1 (Q or K) at oth + s (TQ + TV), other2 (dO or V) a TQ
  // after it
  const uint32_t oth = base + OWN * (TQ + TV);
  uint8_t* const after = base_p + (OWN + NST) * (TQ + TV);  // the tiles' end
  float* const xp = reinterpret_cast<float*>(after);
  uint32_t* const xd = reinterpret_cast<uint32_t*>(after + 16384);
  float* const rows_s =
      reinterpret_cast<float*>(SOLO ? after : after + 24576);

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = tid % 32;
  // this thread's fragment: own rows rr0 + 8 h (h = (i / 2) % 2) of its
  // warpgroup's 64, other columns col0 + 8 (i / 4) + (i % 2) for register i
  const int rr0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const int wrow = SOLO ? wg * 64 : 0;      // the warpgroup's first own row
  const int G = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E;
  const float inv_skv = 1.0f / a.Skv;
  const int kvl = valid_keys(a.kv_len_p, a.kv_len, a.Skv);
  const bf16* const Q = static_cast<const bf16*>(a.q);
  const bf16* const K = static_cast<const bf16*>(a.k);
  const bf16* const V = static_cast<const bf16*>(a.v);
  const bf16* const dO = static_cast<const bf16*>(a.dout);

  int b, kvh, own0, n_steps;
  // dK/dV: the rank, its heads' first query tile and tiles a head
  int R = 1, rank = 0, qt_lo = 0, nqt = 1;
  // dQ: the own head, its first key tile, the own rows' lse and Delta
  int bh_own = 0, j_lo = 0;
  float l2own[2] = {0.0f, 0.0f}, dlown[2] = {0.0f, 0.0f};
  if constexpr (KVM) {
    R = gridDim.x;                          // the cluster spans grid x
    rank = blockIdx.x;
    b = blockIdx.y / a.KV;
    kvh = blockIdx.y % a.KV;
    // key tiles heaviest first: under causal masking the first (they see
    // the most query rows), else the last (a window leaves them the most)
    own0 = (a.causal ? blockIdx.z : gridDim.z - 1 - blockIdx.z) * ROWS;
    int q_lo, q_hi;
    query_range(own0, ROWS, a.Sq, a.causal, a.window, a.q_off, kvl, q_lo,
                q_hi);
    qt_lo = q_lo / 64;
    nqt = q_hi > q_lo ? (q_hi + 63) / 64 - qt_lo : 0;
    const int heads = rank < G ? (G - rank + R - 1) / R : 0;
    n_steps = heads * nqt;
    load_tile<ROWS, NDQ>(own1, K + (size_t)blockIdx.y * a.Skv * DQK, own0,
                         a.Skv, DQK);
    load_tile<ROWS, NDV>(own2, V + (size_t)blockIdx.y * a.Skv * DV, own0,
                         a.Skv, DV);
  } else {
    const TileRange tr = tile_range(blockIdx.y, gridDim.y, blockIdx.x, ROWS,
                                    a.Sq, a.Skv, a.causal, a.window, a.q_off,
                                    kvl);
    bh_own = tr.bh;
    b = tr.bh / a.H;
    kvh = (tr.bh % a.H) / G;
    own0 = tr.q0;
    j_lo = tr.k_lo / 64;
    n_steps = max(0, (tr.k_hi + 63) / 64 - j_lo);
    load_tile<ROWS, NDQ>(own1, Q + (size_t)tr.bh * a.Sq * DQK, own0, a.Sq,
                         DQK);
    load_tile<ROWS, NDV>(own2, dO + (size_t)tr.bh * a.Sq * DV, own0, a.Sq,
                         DV);
    // Delta = rowsum(dO o O) of the own rows in fp32, TPR threads a row,
    // each over DV / TPR columns, then added across them; written for the
    // dK/dV pass, which runs after this one.
    constexpr int TPR = BWD_THREADS / ROWS;
    static_assert(DV / TPR % 8 == 0, "whole 16-byte chunks a thread");
    {
      const int row = tid / TPR, r = own0 + row;
      const size_t at =
          ((size_t)tr.bh * a.Sq + r) * DV + tid % TPR * (DV / TPR);
      float sum = 0.0f;
      if (r < a.Sq) {
#pragma unroll
        for (int j = 0; j < DV / TPR; j += 8) {
          const uint4 ov = ldg16(static_cast<const bf16*>(a.o) + at + j);
          const uint4 gv = ldg16(dO + at + j);
          const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            sum = fmaf(of.x, gf.x, sum);
            sum = fmaf(of.y, gf.y, sum);
          }
        }
      }
#pragma unroll
      for (int off = TPR / 2; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (tid % TPR == 0) {
        rows_s[row] = sum;
        if (r < a.Sq) a.delta[(size_t)tr.bh * a.Sq + r] = sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = own0 + wrow + rr0 + 8 * h;
      l2own[h] = r < a.Sq ? lse_log2(a.lse[(size_t)tr.bh * a.Sq + r]) : 0.0f;
      dlown[h] = rows_s[wrow + rr0 + 8 * h];
    }
  }

  // Step s's other tiles into stage st: (head, query tile) s of this rank
  // for dK/dV, key tile j_lo + s for dQ.
  auto other_row0 = [&](int s) {
    return KVM ? (qt_lo + s % nqt) * 64 : (j_lo + s) * 64;
  };
  auto load_step = [&](int s, int st) {
    const uint32_t o1 = oth + st * (TQ + TV), o2 = o1 + TQ;
    const int o0 = other_row0(s);
    if constexpr (KVM) {
      const size_t bh = (size_t)b * a.H + kvh * G + rank + R * (s / nqt);
      load_tile<64, NDQ>(o1, Q + bh * a.Sq * DQK, o0, a.Sq, DQK);
      load_tile<64, NDV>(o2, dO + bh * a.Sq * DV, o0, a.Sq, DV);
      if (tid < 128) {
        const int r = o0 + tid % 64;
        const float* src = (tid < 64 ? a.lse : a.delta) + bh * a.Sq + r;
        cp_async4(smem_u32(rows_s + st * 128 + tid), r < a.Sq ? src : a.lse,
                  r < a.Sq);
      }
    } else {
      const size_t kv = (size_t)b * a.KV + kvh;
      load_tile<64, NDQ>(o1, K + kv * a.Skv * DQK, o0, a.Skv, DQK);
      load_tile<64, NDV>(o2, V + kv * a.Skv * DV, o0, a.Skv, DV);
    }
  };
  // the first NST - 1 steps' tiles, one copy group each (the first with
  // the own tiles)
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_steps) load_step(i, i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  constexpr int NACC2 = SOLO && KVM ? NDQ * 32 : 1;
  float acc[NACC];              // dV (or dQ); dK where SOLO
  float acc2[NACC2];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NACC2; ++i) acc2[i] = 0.0f;
  // S then P, and dP then dS (SOLO); else x: S then P (warpgroup 0) or dP
  // then dS (1)
  float x[32], y[SOLO ? 32 : 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (SOLO ? 32 : 1); ++i) y[i] = 0.0f;
  uint32_t f[4][4];             // P or dS in bf16: the A fragments

  for (int s = 0; s < n_steps; ++s) {
    const int st = s % NST;
    // step s's tiles have landed; every product of step s - 1 is done,
    // so its stage is free for step s + NST - 1's copies
    publish_stage<NST - 2>();
    if (s + NST - 1 < n_steps) load_step(s + NST - 1, (s + NST - 1) % NST);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t o1 = oth + st * (TQ + TV), o2 = o1 + TQ;
    const int o0 = other_row0(s);
    const int k0 = KVM ? own0 + wrow : o0, q0 = KVM ? o0 : own0 + wrow;
    // one copy of the step for the tiles masked pair by pair, one for the
    // rest (with no masking code in it)
    auto step = [&](auto masked_flag) {
      constexpr bool MASKED = decltype(masked_flag)::value;
      fence_regs(x);
      fence_regs(y);
      wgmma_fence();
      if constexpr (SOLO) {
        qk_products<DQK / 16>(x, wgmma_desc(own1 + wg * TQ, 16, 1024),
                              wgmma_desc(o1, 16, 1024));
        qk_products<DV / 16>(y, wgmma_desc(own2 + wg * TV, 16, 1024),
                             wgmma_desc(o2, 16, 1024));
      } else {
        qk_products<DQK / 16>(x, wgmma_desc(wg ? own2 : own1, 16, 1024),
                              wgmma_desc(wg ? o2 : o1, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(y);

      // rows in the tile that see no key (lse NEG_INF): weights 1 / Skv on
      // every key, no gradient to Q or K
      const bool dead_rows = MASKED && tile_dead_rows(q0, a, kvl);
      const float* const lse_s = rows_s + st * 128;
      // P = exp(S - lse), in x (SOLO, or warpgroup 0)
      auto form_p = [&]() {
        // each row's lse in log2 units: the other side's 16 columns of this
        // thread (dK/dV), the own two rows (dQ)
        float l2c[16];
#pragma unroll
        for (int n = 0; n < 16; ++n)
          l2c[n] = KVM ? lse_log2(lse_s[col0 + 8 * (n / 2) + (n % 2)]) : 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = rr0 + 8 * ((i / 2) % 2);
          const int c = col0 + 8 * (i / 4) + (i % 2);
          const float l2 =
              KVM ? l2c[2 * (i / 4) + (i % 2)] : l2own[(i / 2) % 2];
          float p = ex2(fmaf(x[i], scale_log2, -l2));
          if constexpr (MASKED) {
            const int qi = KVM ? q0 + c : q0 + r, kj = KVM ? k0 + r : k0 + c;
            const bool valid = qi < a.Sq && kj < a.Skv;
            const bool keep =
                valid && !pair_masked(qi + a.q_off, kj, kvl, a.causal,
                                      a.window);
            p = keep ? p : 0.0f;
            if (dead_rows && l2 == -INFINITY) p = valid ? inv_skv : 0.0f;
          }
          x[i] = p;
        }
      };
      // dS = P (dP - Delta) scale from P in p(i) and dP in d, into d
      auto form_ds = [&](auto p, float (&d)[32]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = col0 + 8 * (i / 4) + (i % 2);
          const float dl = KVM ? lse_s[64 + c] : dlown[(i / 2) % 2];
          float ds = p(i) * (d[i] - dl) * a.scale;
          if (dead_rows &&
              (KVM ? lse_s[c] == NEG_INF : l2own[(i / 2) % 2] == -INFINITY))
            ds = 0.0f;
          d[i] = ds;
        }
      };
      auto pack = [&](uint32_t (&fr)[4][4], const float (&v)[32]) {
        fence_regs(fr);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 4; ++h)
            fr[kk][h] = pack_bf16(v[8 * kk + 2 * h], v[8 * kk + 2 * h + 1]);
      };
      if constexpr (SOLO) {
        form_p();
        if constexpr (KVM) {
          // dV += P^T dO runs while dS is formed; then dK += dS^T Q, its A
          // fragments in the same registers once dV's product is done
          pack(f, x);
          fence_regs(acc);
          wgmma_fence();
          pv_product<NDV>(acc, f, o2);
          form_ds([&](int i) { return x[i]; }, y);
          wgmma_wait<0>();
          fence_regs(acc);
          pack(f, y);
          fence_regs(acc2);
          wgmma_fence();
          pv_product<NDQ>(acc2, f, o1);
          wgmma_wait<0>();
          fence_regs(acc2);
        } else {
          form_ds([&](int i) { return x[i]; }, y);
          pack(f, y);
          fence_regs(acc);
          wgmma_fence();
          pv_product<NDQ>(acc, f, o1);  // dQ += dS K
          wgmma_wait<0>();
          fence_regs(acc);
        }
      } else {
        if (wg == 0) {
          form_p();
#pragma unroll
          for (int i = 0; i < 32; ++i) xp[i * 128 + t] = x[i];
          bar_arrive(1);
          pack(f, x);             // P, for dV
        } else {
          bar_wait(1);
          form_ds([&](int i) { return xp[i * 128 + t]; }, x);
          pack(f, x);             // dS, for dK or dQ
        }
        if constexpr (KVM) {
          // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q
          fence_regs(acc);
          wgmma_fence();
          pv_product<NDQ>(acc, f, wg ? o1 : o2);
          wgmma_wait<0>();
          fence_regs(acc);
        } else {
          // dQ += dS K, warpgroup w taking D / 2 columns from w D / 2
          if (wg == 1) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int h = 0; h < 4; ++h) xd[(kk * 4 + h) * 128 + t] = f[kk][h];
            bar_arrive(2);
          } else {
            bar_wait(2);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int h = 0; h < 4; ++h) f[kk][h] = xd[(kk * 4 + h) * 128 + t];
          }
          fence_regs(acc);
          fence_regs(f);
          wgmma_fence();
          pv_product<NDQ / 2>(acc, f, o1 + wg * (NDQ / 2) * BLOCK_BYTES);
          wgmma_wait<0>();
          fence_regs(acc);
        }
      }
    };
    // a warpgroup whose 64 rows keep no pair of the tile skips it, unless
    // a row there sees no key
    if (!pair_tile_masked(k0, q0, a, kvl))
      step(std::false_type{});
    else if (!SOLO || !pair_tile_empty(k0, q0, a, kvl) ||
             tile_dead_rows(q0, a, kvl))
      step(std::true_type{});
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  if constexpr (KVM) {
    // This rank's partials in fp32 over the tiles (every product and read
    // of them is done): ROWS dV rows of DV + 4, then ROWS dK rows of DQK +
    // 4; the zero columns past a dim are not kept.
    constexpr int RSV = DV + 4, RSK = DQK + 4;
    float* const red_v = reinterpret_cast<float*>(base_p);
    float* const red_k = red_v + ROWS * RSV;
    __syncthreads();
    if constexpr (SOLO) {
#pragma unroll
      for (int i = 0; i < NACC; i += 2) {
        const int r = rr0 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + col0;
        if (col < DV)
          *reinterpret_cast<float2*>(red_v + (wrow + r) * RSV + col) =
              make_float2(acc[i], acc[i + 1]);
      }
#pragma unroll
      for (int i = 0; i < NACC2; i += 2) {
        const int r = rr0 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + col0;
        if (col < DQK)
          *reinterpret_cast<float2*>(red_k + (wrow + r) * RSK + col) =
              make_float2(acc2[i], acc2[i + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NACC; i += 2) {
        const int r = rr0 + 8 * ((i / 2) % 2);
        const int col = 8 * (i / 4) + col0;
        *reinterpret_cast<float2*>((wg ? red_k + r * RSK : red_v + r * RSV) +
                                   col) = make_float2(acc[i], acc[i + 1]);
      }
    }
    cluster_sync();
    // Rank `rank` sums its slice of the rows' 4-column chunks (dV's, then
    // dK's) over the ranks in rank order and writes them.
    constexpr int NV4 = ROWS * DV / 4, N4 = NV4 + ROWS * DQK / 4;
    const int lo = rank * N4 / R, hi = (rank + 1) * N4 / R;
    for (int e = lo + tid; e < hi; e += BWD_THREADS) {
      const bool is_v = e < NV4;
      const int d = is_v ? DV : DQK, e4 = (is_v ? e : e - NV4) * 4;
      const int m = e4 / d, col = e4 % d;
      const uint32_t addr =
          smem_u32((is_v ? red_v + m * RSV : red_k + m * RSK) + col);
      float4 v = ld_cluster16(addr, 0);
      for (int q = 1; q < R; ++q) {
        const float4 w = ld_cluster16(addr, q);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      const int row = own0 + m;
      if (row < a.Skv) {
        bf16* const out = static_cast<bf16*>(is_v ? a.dv : a.dk) +
                          ((size_t)blockIdx.y * a.Skv + row) * d + col;
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v.z, v.w);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo2);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(out) = packed;
      }
    }
    cluster_sync();             // no block leaves while read remotely
  } else {
    // each warpgroup its own rows (SOLO) or its half of the columns
    const int cb = SPLIT ? wg * (DQK / 2) : 0;
    bf16* const out = static_cast<bf16*>(a.dq) + (size_t)bh_own * a.Sq * DQK;
#pragma unroll
    for (int i = 0; i < NACC; i += 2) {
      const int row = own0 + wrow + rr0 + 8 * ((i / 2) % 2);
      const int col = cb + 8 * (i / 4) + col0;
      if (row < a.Sq && col < DQK)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * DQK + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// ---- fp32: 3xTF32 on the tensor cores (mma.sync) -------------------------
// K5's fp32 helpers (tf_load, tf_split, the fragments, tf_scores,
// tf_accumulate) in the bf16 passes' two-pass shape.  A warp owns 16 rows
// (query rows for dQ, keys for dK/dV) and runs all its products: S and dP
// (own . other^T, three accumulators each), P and dS from them (pair_grads
// where the step is masked), then dQ += dS K, or dV += P^T dO and dK +=
// dS^T Q with P^T and dS^T split in registers as A fragments.  The own
// tiles are split once a block; the other side's tiles arrive by cp.async
// into two stages, one step ahead, and are split once they land.  The dQ
// pass runs first and computes Delta = rowsum(dO o O) of its rows on the
// way (fp32, a warp a row), for itself and into the scratch the dK/dV pass
// reads.  The dK/dV pass splits a KV head's G query heads over the R ranks
// of a cluster (bwd_plan's R for the fp32 rows), the ranks' fp32 partials
// summed in rank order through distributed shared memory as in bf16.  At
// head dim 256 the dK and dV of 16 keys are 256 registers a thread, so two
// warps share 16 keys, each recomputing S and dP and taking half of dK's
// and dV's columns; the dQ pass's block is 32 rows there.
template <int DQK, int DV>
struct TfBwd {
  static constexpr bool WIDE = DQK > 128;            // head dim 256
  static constexpr int KROWS = WIDE ? 16 : 64;       // own keys, dK/dV
  static constexpr int CS = WIDE ? 2 : 1;            // column groups
  static constexpr int KV_WARPS = KROWS / 16 * CS;
  static constexpr int QROWS = WIDE ? 32 : 64;       // own query rows, dQ
  static constexpr int Q_WARPS = QROWS / 16;
  static constexpr int BTK = 16;                     // query rows a dK/dV step
  static constexpr int BTQ = WIDE ? 8 : 16;          // keys a dQ step
  static constexpr int SQ = tf_stride(DQK), SV = tf_stride(DV);
  // own hi and lo of both operands, two stages of the other side's, and
  // the own rows' Delta (dQ) or each stage's rows' lse and Delta (dK/dV);
  // the dK/dV ranks' partials reuse the tiles
  static constexpr int Q_SMEM = 4 * (2 * (QROWS + 2 * BTQ) * (SQ + SV) + QROWS);
  static constexpr int KV_TILES =
      4 * (2 * (KROWS + 2 * BTK) * (SQ + SV) + 4 * BTK);
  static constexpr int KV_RED = 4 * KROWS * (SQ + SV);
  static constexpr int KV_SMEM = KV_TILES > KV_RED ? KV_TILES : KV_RED;
};

// Query rows [q0, q0 + nq) and keys [k0, k0 + nk) need masking pair by
// pair: the keys cross the shifted causal diagonal, the window's edge or
// the end of the valid keys, the rows run past Sq, or one sees no key.
__device__ __forceinline__ bool tf_pairs_masked(int k0, int nk, int q0,
                                                int nq, const BwdArgs& a,
                                                int kvl) {
  return k0 + nk > kvl || q0 + nq > a.Sq ||
         (a.causal && k0 + nk - 1 > q0 + a.q_off) ||
         (a.window && q0 + nq - 1 + a.q_off - k0 >= a.window) ||
         row_dead(q0 + nq - 1 + a.q_off, kvl, a.window);
}

// A warp skips a step where its pairs keep none and no row sees no key.
__device__ __forceinline__ bool tf_step_empty(int k0, int nk, int q0, int nq,
                                              const BwdArgs& a, int kvl) {
  return !row_dead(q0 + nq - 1 + a.q_off, kvl, a.window) &&
         (q0 >= a.Sq ||
          tf_none_kept(k0, nk, q0 + a.q_off, nq, kvl, a.causal, a.window));
}

template <int DQK, int DV>
__global__ void __launch_bounds__(32 * TfBwd<DQK, DV>::Q_WARPS, 1)
flash_bwd_dq_tf32_kernel(const BwdArgs a) {
  using C = TfBwd<DQK, DV>;
  constexpr int THREADS = 32 * C::Q_WARPS, BQ = C::QROWS, BT = C::BTQ;
  constexpr int SQ = C::SQ, SV = C::SV, NT = BT / 8;
  constexpr int KW = BT * SQ, VW = BT * SV, STAGE = 2 * (KW + VW);
  extern __shared__ float4 tf_smem[];
  float* const qh = reinterpret_cast<float*>(tf_smem);
  float* const ql = qh + BQ * SQ;
  float* const gh = ql + BQ * SQ;           // dO
  float* const gl = gh + BQ * SV;
  float* const st0 = gl + BQ * SV;          // stage s: K hi, K lo, V hi, V lo
  float* const delta_s = st0 + 2 * STAGE;   // the own rows' Delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp * 16, col0 = 2 * (lane % 4);
  const int G = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E, inv_skv = 1.0f / a.Skv;
  const int kvl = valid_keys(a.kv_len_p, a.kv_len, a.Skv);
  const TileRange tr = tile_range(blockIdx.y, gridDim.y, blockIdx.x, BQ,
                                  a.Sq, a.Skv, a.causal, a.window, a.q_off,
                                  kvl);
  const int b = tr.bh / a.H, kvh = (tr.bh % a.H) / G;
  const size_t kv = (size_t)b * a.KV + kvh;
  const float* const Qg = static_cast<const float*>(a.q) + (size_t)tr.bh * a.Sq * DQK;
  const float* const Gg = static_cast<const float*>(a.dout) + (size_t)tr.bh * a.Sq * DV;
  const float* const Og = static_cast<const float*>(a.o) + (size_t)tr.bh * a.Sq * DV;
  const float* const Kg = static_cast<const float*>(a.k) + kv * a.Skv * DQK;
  const float* const Vg = static_cast<const float*>(a.v) + kv * a.Skv * DV;
  const int j_lo = tr.k_lo / BT, j_hi = (tr.k_hi + BT - 1) / BT;

  // Each thread splits the chunks it copied (as in K5's forward): a tile
  // is split as this thread's copies land, and the barrier after
  // publishes it.
  auto stage = [&](int st) { return st0 + st * STAGE; };
  auto load_kv = [&](int j, int st) {
    tf_load<BT, DQK, THREADS>(stage(st), Kg, j * BT, a.Skv);
    tf_load<BT, DV, THREADS>(stage(st) + 2 * KW, Vg, j * BT, a.Skv);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto split_kv = [&](int st) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    tf_split<BT, DQK, THREADS>(stage(st), stage(st) + KW);
    tf_split<BT, DV, THREADS>(stage(st) + 2 * KW, stage(st) + 2 * KW + VW);
  };
  tf_load<BQ, DQK, THREADS>(qh, Qg, tr.q0, a.Sq);
  tf_load<BQ, DV, THREADS>(gh, Gg, tr.q0, a.Sq);
  if (j_lo < j_hi) load_kv(j_lo, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Delta of the warp's 16 rows, a warp a row, lanes over the columns
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {
    const int r = tr.q0 + wr + i;
    float sum = 0.0f;
    if (r < a.Sq)
      for (int d = lane; d < DV; d += 32)
        sum = fmaf(Og[(size_t)r * DV + d], Gg[(size_t)r * DV + d], sum);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      delta_s[wr + i] = sum;
      if (r < a.Sq) a.delta[(size_t)tr.bh * a.Sq + r] = sum;
    }
  }
  __syncwarp();
  const int row0 = tr.q0 + wr + lane / 4;   // this thread's: row0, row0 + 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    l2[r] = qi < a.Sq ? lse_log2(a.lse[(size_t)tr.bh * a.Sq + qi]) : 0.0f;
    dl[r] = delta_s[wr + lane / 4 + 8 * r];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (j_lo < j_hi) split_kv(0);
  tf_split<BQ, DQK, THREADS>(qh, ql);
  tf_split<BQ, DV, THREADS>(gh, gl);
  __syncthreads();

  float dq[DQK / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.0f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    const float* const kh = stage(st);
    const float* const kl = kh + KW;
    const float* const vh = kl + KW;
    const float* const vl = vh + VW;
    if (j + 1 < j_hi) load_kv(j + 1, st ^ 1);
    const int k0 = j * BT, q0 = tr.q0 + wr;
    if (!tf_step_empty(k0, BT, q0, 16, a, kvl)) {
      const bool masked = tf_pairs_masked(k0, BT, q0, 16, a, kvl);
      float s[NT][4], dp[NT][4];
      tf_scores<DQK, NT, SQ, SQ>(s, qh, ql, wr, kh, kl, lane);
      tf_scores<DV, NT, SV, SV>(dp, gh, gl, wr, vh, vl, lane);
      // dS = P (dP - Delta) scale, split as the A fragments of dQ += dS K
      uint32_t dh[NT][4], dlo[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i / 2;
          float p, ds;
          if (masked) {
            pair_grads(s[n][i], dp[n][i], row0 + 8 * r,
                       k0 + 8 * n + col0 + (i % 2), l2[r], dl[r], a, kvl,
                       scale_log2, inv_skv, p, ds);
          } else {
            p = ex2(fmaf(s[n][i], scale_log2, -l2[r]));
            ds = p * (dp[n][i] - dl[r]) * a.scale;
          }
          s[n][i] = ds;
        }
        tf_c_to_a(s[n], dh[n], dlo[n]);
      }
      tf_accumulate<DQK / 8, NT, SQ>(dq, dh, dlo, kh, kl, 0, lane);
    }
    if (j + 1 < j_hi) split_kv(st ^ 1);
    __syncthreads();
  }

  float* const out = static_cast<float*>(a.dq) + (size_t)tr.bh * a.Sq * DQK;
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < a.Sq)
        *reinterpret_cast<float2*>(out + (size_t)(row0 + 8 * r) * DQK + 8 * n +
                                   col0) =
            make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(32 * TfBwd<DQK, DV>::KV_WARPS, 1)
flash_bwd_dkdv_tf32_kernel(const BwdArgs a) {
  using C = TfBwd<DQK, DV>;
  constexpr int THREADS = 32 * C::KV_WARPS, ROWS = C::KROWS, BT = C::BTK;
  constexpr int CS = C::CS, SQ = C::SQ, SV = C::SV, NT = BT / 8;
  constexpr int NDV = DV / 8 / CS, NDK = DQK / 8 / CS;  // a warp's 8-column tiles
  static_assert(DV / 8 % CS == 0 && DQK / 8 % CS == 0, "whole column groups");
  constexpr int QW = BT * SQ, GW = BT * SV, STAGE = 2 * (QW + GW);
  extern __shared__ float4 tf_smem[];
  float* const kh = reinterpret_cast<float*>(tf_smem);
  float* const kl = kh + ROWS * SQ;
  float* const vh = kl + ROWS * SQ;
  float* const vl = vh + ROWS * SV;
  float* const st0 = vl + ROWS * SV;        // stage s: Q hi, lo, dO hi, lo
  float* const rows_s = st0 + 2 * STAGE;    // stage s: lse at 2 BT s, Delta BT on

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kr = warp / CS * 16, cw = warp % CS;  // own rows, column group
  const int col0 = 2 * (lane % 4);
  const int G = a.H / a.KV;
  const float scale_log2 = a.scale * LOG2E, inv_skv = 1.0f / a.Skv;
  const int kvl = valid_keys(a.kv_len_p, a.kv_len, a.Skv);
  const int R = gridDim.x, rank = blockIdx.x;   // the cluster spans grid x
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  // key tiles heaviest first, as in bf16
  const int own0 = (a.causal ? blockIdx.z : gridDim.z - 1 - blockIdx.z) * ROWS;
  int q_lo, q_hi;
  query_range(own0, ROWS, a.Sq, a.causal, a.window, a.q_off, kvl, q_lo, q_hi);
  const int qt_lo = q_lo / BT;
  const int nqt = q_hi > q_lo ? (q_hi + BT - 1) / BT - qt_lo : 0;
  const int heads = rank < G ? (G - rank + R - 1) / R : 0;
  const int n_steps = heads * nqt;
  const float* const Q = static_cast<const float*>(a.q);
  const float* const dO = static_cast<const float*>(a.dout);
  tf_load<ROWS, DQK, THREADS>(
      kh, static_cast<const float*>(a.k) + (size_t)blockIdx.y * a.Skv * DQK,
      own0, a.Skv);
  tf_load<ROWS, DV, THREADS>(
      vh, static_cast<const float*>(a.v) + (size_t)blockIdx.y * a.Skv * DV,
      own0, a.Skv);

  // step s: head rank + R (s / nqt) of the KV head's G, query tile s % nqt;
  // each thread splits the chunks it copied, as in K5's forward
  auto stage = [&](int st) { return st0 + st * STAGE; };
  auto load_step = [&](int s, int st) {
    const size_t bh = (size_t)b * a.H + kvh * G + rank + R * (s / nqt);
    const int o0 = (qt_lo + s % nqt) * BT;
    tf_load<BT, DQK, THREADS>(stage(st), Q + bh * a.Sq * DQK, o0, a.Sq);
    tf_load<BT, DV, THREADS>(stage(st) + 2 * QW, dO + bh * a.Sq * DV, o0,
                             a.Sq);
    for (int i = tid; i < 2 * BT; i += THREADS) {
      const int r = o0 + i % BT;
      const float* src = (i < BT ? a.lse : a.delta) + bh * a.Sq + r;
      cp_async4(smem_u32(rows_s + st * 2 * BT + i), r < a.Sq ? src : a.lse,
                r < a.Sq);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto split_step = [&](int st) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    tf_split<BT, DQK, THREADS>(stage(st), stage(st) + QW);
    tf_split<BT, DV, THREADS>(stage(st) + 2 * QW, stage(st) + 2 * QW + GW);
  };
  asm volatile("cp.async.commit_group;\n" ::: "memory");  // the own tiles
  if (n_steps > 0) load_step(0, 0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  tf_split<ROWS, DQK, THREADS>(kh, kl);
  tf_split<ROWS, DV, THREADS>(vh, vl);
  if (n_steps > 0) split_step(0);
  __syncthreads();

  float dv[NDV][4], dk[NDK][4];
#pragma unroll
  for (int n = 0; n < NDV; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dv[n][i] = 0.0f;
#pragma unroll
  for (int n = 0; n < NDK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    const int st = s & 1;
    const float* const qh = stage(st);
    const float* const ql = qh + QW;
    const float* const gh = ql + QW;
    const float* const gl = gh + GW;
    if (s + 1 < n_steps) load_step(s + 1, st ^ 1);
    const int o0 = (qt_lo + s % nqt) * BT, k0 = own0 + kr;
    if (!tf_step_empty(k0, 16, o0, BT, a, kvl)) {
      const bool masked = tf_pairs_masked(k0, 16, o0, BT, a, kvl);
      // S^T and dP^T: own keys . the step's query rows
      float sT[NT][4], dpT[NT][4];
      tf_scores<DQK, NT, SQ, SQ>(sT, kh, kl, kr, qh, ql, lane);
      tf_scores<DV, NT, SV, SV>(dpT, vh, vl, kr, gh, gl, lane);
      const float* const lse_s = rows_s + st * 2 * BT;
      // P^T into sT, dS^T into dpT
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * n + col0 + (i % 2);   // the query row in the tile
          const float l2 = lse_log2(lse_s[c]);
          float p, ds;
          if (masked) {
            pair_grads(sT[n][i], dpT[n][i], o0 + c,
                       k0 + lane / 4 + 8 * (i / 2), l2, lse_s[BT + c], a, kvl,
                       scale_log2, inv_skv, p, ds);
          } else {
            p = ex2(fmaf(sT[n][i], scale_log2, -l2));
            ds = p * (dpT[n][i] - lse_s[BT + c]) * a.scale;
          }
          sT[n][i] = p;
          dpT[n][i] = ds;
        }
      uint32_t fh[NT][4], fl[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) tf_c_to_a(sT[n], fh[n], fl[n]);
      tf_accumulate<NDV, NT, SV>(dv, fh, fl, gh, gl, cw * (DV / CS), lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) tf_c_to_a(dpT[n], fh[n], fl[n]);
      tf_accumulate<NDK, NT, SQ>(dk, fh, fl, qh, ql, cw * (DQK / CS), lane);
    }
    if (s + 1 < n_steps) split_step(st ^ 1);
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // This rank's partials in fp32 over the tiles: ROWS dV rows of DV + 4,
  // then ROWS dK rows of DQK + 4.
  constexpr int RSV = DV + 4, RSK = DQK + 4;
  float* const red_v = reinterpret_cast<float*>(tf_smem);
  float* const red_k = red_v + ROWS * RSV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr + lane / 4 + 8 * r;
#pragma unroll
    for (int n = 0; n < NDV; ++n)
      *reinterpret_cast<float2*>(red_v + row * RSV + cw * (DV / CS) + 8 * n +
                                 col0) = make_float2(dv[n][2 * r],
                                                     dv[n][2 * r + 1]);
#pragma unroll
    for (int n = 0; n < NDK; ++n)
      *reinterpret_cast<float2*>(red_k + row * RSK + cw * (DQK / CS) + 8 * n +
                                 col0) = make_float2(dk[n][2 * r],
                                                     dk[n][2 * r + 1]);
  }
  cluster_sync();
  // Rank `rank` sums its slice of the rows' 4-column chunks (dV's, then
  // dK's) over the ranks in rank order and writes them.
  constexpr int NV4 = ROWS * DV / 4, N4 = NV4 + ROWS * DQK / 4;
  const int lo = rank * N4 / R, hi = (rank + 1) * N4 / R;
  for (int e = lo + tid; e < hi; e += THREADS) {
    const bool is_v = e < NV4;
    const int d = is_v ? DV : DQK, e4 = (is_v ? e : e - NV4) * 4;
    const int m = e4 / d, col = e4 % d;
    const uint32_t addr =
        smem_u32((is_v ? red_v + m * RSV : red_k + m * RSK) + col);
    float4 v = ld_cluster16(addr, 0);
    for (int q = 1; q < R; ++q) {
      const float4 w = ld_cluster16(addr, q);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int row = own0 + m;
    if (row < a.Skv)
      *reinterpret_cast<float4*>(static_cast<float*>(is_v ? a.dv : a.dk) +
                                 ((size_t)blockIdx.y * a.Skv + row) * d +
                                 col) = v;
  }
  cluster_sync();             // no block leaves while read remotely
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// A dK/dV pass over `grid`, its clusters of grid.x blocks along x.
template <typename Kernel>
int launch_clusters(Kernel kernel, dim3 grid, int threads, int smem,
                    cudaStream_t stream, const BwdArgs& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = grid.x;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

// The launches of K5b at head dims (DQK, DV): the dQ pass first (it writes
// Delta, which the dK/dV pass reads), then the dK/dV pass in clusters of
// `cluster` blocks; `bf16` picks the wgmma kernels, else the 3xTF32 ones.
// The shared-memory limits are raised once a kernel and process.
template <int DQK, int DV, bool BF16>
int launch_bwd(const BwdArgs& a, int B, int cluster, cudaStream_t stream) {
  int err;
  if constexpr (BF16) {
    constexpr int smem = bwd_bf16_smem_bytes<DQK, DV>();
    static const int attr_kv =
        set_smem(flash_bwd_bf16_kernel<DQK, DV, true>, smem);
    static const int attr_q =
        set_smem(flash_bwd_bf16_kernel<DQK, DV, false>, smem);
    if (attr_kv) return attr_kv;
    if (attr_q) return attr_q;
    constexpr int rows = bwd_rows<DQK, DV>();
    flash_bwd_bf16_kernel<DQK, DV, false>
        <<<dim3(B * a.H, (a.Sq + rows - 1) / rows), BWD_THREADS, smem,
           stream>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    err = launch_clusters(flash_bwd_bf16_kernel<DQK, DV, true>,
                          dim3(cluster, B * a.KV, (a.Skv + rows - 1) / rows),
                          BWD_THREADS, smem, stream, a);
  } else {
    using C = TfBwd<DQK, DV>;
    static const int attr_q =
        set_smem(flash_bwd_dq_tf32_kernel<DQK, DV>, C::Q_SMEM);
    static const int attr_kv =
        set_smem(flash_bwd_dkdv_tf32_kernel<DQK, DV>, C::KV_SMEM);
    if (attr_q) return attr_q;
    if (attr_kv) return attr_kv;
    flash_bwd_dq_tf32_kernel<DQK, DV>
        <<<dim3(B * a.H, (a.Sq + C::QROWS - 1) / C::QROWS), 32 * C::Q_WARPS,
           C::Q_SMEM, stream>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    err = launch_clusters(
        flash_bwd_dkdv_tf32_kernel<DQK, DV>,
        dim3(cluster, B * a.KV, (a.Skv + C::KROWS - 1) / C::KROWS),
        32 * C::KV_WARPS, C::KV_SMEM, stream, a);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,Sq,D), k (B,KV,Skv,D), v (B,KV,Skv,Dv), o (B,H,Sq,Dv), all
// contiguous of dtype (fp32 or bf16) and 16-byte aligned; (D, Dv) one of the
// pairs below (kernels/flash_attention.py::HEAD_DIM_PAIRS); H a multiple of
// KV.  `lse`, fp32 (B,H,Sq), receives each row's m + log l (row_lse) where
// it is not null.  q_offset >= 0 shifts the queries' positions; kv_len in
// [0, Skv] counts the valid keys, or kv_len_p, where not null, points to
// an int64 on the card that every block reads in its place.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int KV,
                               int Sq, int Skv, int D, int Dv, float scale,
                               int causal, int window, int q_offset,
                               int kv_len, const long long* kv_len_p,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, window, \
             q_offset, kv_len, kv_len_p, s
#define PAIR(a, b) ((a) * 1024 + (b))
  if (dtype == DTYPE_F32) {
    switch (PAIR(D, Dv)) {
      case PAIR(16, 16): return launch_f32<16, 16>(ARGS);
      case PAIR(32, 32): return launch_f32<32, 32>(ARGS);
      case PAIR(64, 64): return launch_f32<64, 64>(ARGS);
      case PAIR(128, 128): return launch_f32<128, 128>(ARGS);
      case PAIR(256, 256): return launch_f32<256, 256>(ARGS);
      case PAIR(96, 64): return launch_f32<96, 64>(ARGS);
      case PAIR(80, 80): return launch_f32<80, 80>(ARGS);
      case PAIR(32, 16): return launch_f32<32, 16>(ARGS);
    }
  } else if (dtype == DTYPE_BF16) {
    switch (PAIR(D, Dv)) {
      case PAIR(16, 16): return launch_bf16<16, 16>(ARGS);
      case PAIR(32, 32): return launch_bf16<32, 32>(ARGS);
      case PAIR(64, 64): return launch_bf16<64, 64>(ARGS);
      case PAIR(128, 128): return launch_bf16<128, 128>(ARGS);
      case PAIR(256, 256): return launch_bf16<256, 256>(ARGS);
      case PAIR(96, 64): return launch_bf16<96, 64>(ARGS);
      case PAIR(80, 80): return launch_bf16<80, 80>(ARGS);
      case PAIR(32, 16): return launch_bf16<32, 16>(ARGS);
    }
  }
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5b.  q, dq (B,H,Sq,D); k, dk (B,KV,Skv,D); v, dv (B,KV,Skv,Dv); o, dout
// (B,H,Sq,Dv), all contiguous of dtype (fp32 or bf16) and 16-byte aligned;
// (D, Dv) one of the pairs below (kernels/flash_attention.py::
// HEAD_DIM_PAIRS), any other refused; lse fp32 (B,H,Sq) as flash_attention
// wrote it for these inputs; delta fp32 (B,H,Sq) scratch; `cluster` (1..8)
// the ranks that split a KV head's query heads in the bf16 dK/dV pass, as
// kernels/flash_attention.py::bwd_plan gives it; q_offset, kv_len and
// kv_len_p as flash_attention took them.  dq, dk and dv are written whole
// (zeros where no pair reaches them).  Launches two kernels (bf16) or
// three (fp32) on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const float* lse,
                                   const void* dout, float* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int KV,
                                   int Sq, int Skv, int D, int Dv, float scale,
                                   int causal, int window, int q_offset,
                                   int kv_len, const long long* kv_len_p,
                                   int cluster, int dtype, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{q, k, v, dout, o, lse, delta, dq, dk, dv, H, KV, Sq, Skv,
                  scale, causal, window, q_offset, kv_len, kv_len_p};
#define ARGS a, B, cluster, s
  if (dtype == DTYPE_F32) {
    switch (PAIR(D, Dv)) {
      case PAIR(16, 16): return launch_bwd<16, 16, false>(ARGS);
      case PAIR(32, 32): return launch_bwd<32, 32, false>(ARGS);
      case PAIR(64, 64): return launch_bwd<64, 64, false>(ARGS);
      case PAIR(128, 128): return launch_bwd<128, 128, false>(ARGS);
      case PAIR(256, 256): return launch_bwd<256, 256, false>(ARGS);
      case PAIR(96, 64): return launch_bwd<96, 64, false>(ARGS);
      case PAIR(80, 80): return launch_bwd<80, 80, false>(ARGS);
      case PAIR(32, 16): return launch_bwd<32, 16, false>(ARGS);
    }
  } else if (dtype == DTYPE_BF16) {
    switch (PAIR(D, Dv)) {
      case PAIR(16, 16): return launch_bwd<16, 16, true>(ARGS);
      case PAIR(32, 32): return launch_bwd<32, 32, true>(ARGS);
      case PAIR(64, 64): return launch_bwd<64, 64, true>(ARGS);
      case PAIR(128, 128): return launch_bwd<128, 128, true>(ARGS);
      case PAIR(256, 256): return launch_bwd<256, 256, true>(ARGS);
      case PAIR(96, 64): return launch_bwd<96, 64, true>(ARGS);
      case PAIR(80, 80): return launch_bwd<80, 80, true>(ARGS);
      case PAIR(32, 16): return launch_bwd<32, 16, true>(ARGS);
    }
  }
#undef ARGS
#undef PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
