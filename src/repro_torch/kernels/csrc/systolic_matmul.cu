// K1: the DSA systolic array's GEMM, (M,K) @ (K,N) [+ bias] with an fp32
// accumulator and the vector engine's activation fused into the epilogue,
// cast to the output type.
//
// Replaces: src/repro/kernels/systolic_matmul.py::systolic_matmul
// (_matmul_kernel), the Pallas TPU kernel that streams (bm,bk)x(bk,bn)
// tiles through VMEM into the MXU and accumulates over a sequential K grid
// dimension.
//
// What bounds it on the H100: the bytes, then the operations.  The
// ResNet-50 convolutions it serves (im2col GEMMs, e.g. M=12544 K=147 N=64
// for the stem, M=3136 K=576 N=64 in stage 1) do 2*M*N*K flops on (M*K +
// K*N + M*N) words.  The port holds fp32 results to rtol 1e-4, which one
// TF32 product (10-bit mantissa, ~2^-11 of each product) misses, while the
// fp32 FMA pipes peak at 67 TFLOP/s.  Three TF32 products at 495 TFLOP/s
// and 3.35 TB/s bound the request's 53 GEMMs at 0.069 ms, 0.026 ms of it
// operations-bound; the FMA pipes alone would take 0.122 ms.
//
// What the design does about it.
// fp32 runs on the tensor cores as 3xTF32: each operand element v is split
// into hi = v with the low 13 mantissa bits cleared (TF32 by truncation: a
// finite v never becomes inf, where round-to-nearest would send values
// within 2^-11 of FLT_MAX to inf) and lo = (v - hi), truncated the same way,
// and each k8 step accumulates A_lo.B_hi + A_hi.B_lo + A_hi.B_hi (lo.lo
// dropped) in fp32 with wgmma m64nNk8 .tf32: about 2^-21 of each product,
// the error of fp32.  Non-finite inputs: hi = v (NaN made canonical) and
// lo = 0, so exactly the outputs that the plain version makes non-finite
// are non-finite, but a cross term such as inf * b_lo with b_lo = 0 is NaN:
// NaN may stand where the plain version has +-inf.  bf16 runs one product,
// wgmma m64nNk16 .bf16, on the same pipeline.
// A block owns a BM x BN output tile, BM = 64 per warpgroup (one or two),
// BN 32 or 64, and walks its K range in tiles of 128 bytes of k (32 fp32 or
// 64 bf16 values).  Operands in shared memory sit in the 128-byte swizzled
// K-major layout of wgmma (16-byte chunk c of row r at chunk c ^ (r % 8)):
// w transposed on its way in (TF32 takes K-major operands only) unless the
// caller hands it over K-major, as models/vision.py does for the 3x3 and
// 7x7 convolutions.  fp32 x never enters shared memory: within a k tile
// the k order is permuted so that each thread's A fragment is 8 contiguous
// k of two rows, loaded as 16-byte chunks, split in registers and fed to
// wgmma from registers; w's hi and lo tiles are stored in the same order.
// That cuts the shared-memory traffic of a 64 x 32 tile from ~60 KB to
// ~20 KB a k tile (tools/k1_ablate.py measured shared memory, not the
// tensor cores, as the limit).  bf16 x goes through shared memory.
// The pipeline: two stages in shared memory and two register sets.  While
// tile t's products run, tile t + 1 is split and stored, and tile t + 2 is
// loaded from global memory (16 bytes at a time where K, N and the base
// allow it, else element by element with zero fill: any shape, view or
// offset is taken).  (A third stage, to let tile t - 1's products run on
// under tile t's, cost registers and blocks per SM and was no faster.)
// Ragged edges are zeros on the load and skipped on the store.
// Split-K inside the launch: where the output has too few tiles to fill the
// card, the wrapper's picker (systolic_matmul.py::tile_plan) cuts K into up
// to 8 slices (the portable cluster size), and the slices of one output
// tile form one thread-block cluster along blockIdx.z.  Each block leaves
// its fp32 partial tile in its own shared memory; after a cluster barrier,
// block z sums its share of the tile's rows over ranks 0, 1, ... in order
// through distributed shared memory (so results are bit-identical from run
// to run), applies bias, activation and cast, and stores its rows, 16 bytes
// at a time (8 for bf16) where N and the output's alignment allow.  An
// unsplit tile leaves from its accumulator fragment.  The epilogue is
// compiled once for each activation: a switch inside it cost more than the
// rest of the epilogue.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int ROW_BYTES = 128;   // a k tile: 32 fp32 or 64 bf16 values a row
constexpr int MAX_SLICES = 8;    // the portable cluster size

// d (64 x N, fp32) += A (64 x k) . B (k x N, shared, K-major): one k8 step
// in TF32 with A in registers, or one k16 step in bf16 with A in shared
// memory (K-major).
template <int N>
struct Mma;

template <>
struct Mma<32> {
  // A (64 x k8) in registers: the tf32 fragment a[0..3].
  __device__ __forceinline__ static void tf32_rs(float* d,
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
  __device__ __forceinline__ static void bf16(float* d, uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}"
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<64> {
  // A (64 x k8) in registers: the tf32 fragment a[0..3].
  __device__ __forceinline__ static void tf32_rs(float* d,
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
  __device__ __forceinline__ static void bf16(float* d, uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}"
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int A>
using ActC = std::integral_constant<int, A>;

struct Params {
  const void* x;
  const void* w;
  const float* bias;
  void* out;
  int M, N, K;
  int kc;         // K of a slice, a multiple of the k tile
  int act;
  int out_bf16;
  int vec_x;      // K % (16 B of elements) == 0 and x 16-byte aligned
  int wt;         // w is K-major: a (K, N) view with strides (1, K)
  int vec_w;      // w's rows (N, or K where wt) a whole number of 16-byte
                  // chunks, and w 16-byte aligned
  int vec_out;    // N % 4 == 0 and out aligned for 4 elements
  int vec_out2;   // N % 2 == 0 and out aligned for 2 elements
};

// Shared-memory copies of each w element: fp32 keeps hi and lo.
template <typename Tin>
constexpr int kParts = std::is_same<Tin, float>::value ? 2 : 1;

template <typename Tin, int NWG, int BN>
constexpr int smem_bytes() {
  constexpr int BM = 64 * NWG;
  constexpr int a = kParts<Tin> == 2 ? 0 : BM;   // fp32: A in registers
  constexpr int ring = 2 * (a + kParts<Tin> * BN) * ROW_BYTES;
  constexpr int partial = BM * (BN + 8) * 4;
  return (ring > partial ? ring : partial) + 1024;   // + 1 KB to align
}

// v = hi + lo + (what is dropped, ~2^-22 |v|), hi and lo TF32 values.
__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi,
                                           uint32_t& lo) {
  if ((bits & 0x7f800000u) == 0x7f800000u) {     // inf or NaN
    hi = (bits & 0x007fffffu) ? 0x7fffffffu : bits;
    lo = 0u;
    return;
  }
  hi = bits & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)) &
       0xffffe000u;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One 16-byte chunk read element by element: the first `n` elements (zeros
// past them), for rows and bases that 16-byte loads cannot take.
__device__ __forceinline__ uint4 ld_chunk(const float* p, int n) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? __float_as_uint(p[j]) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint4 ld_chunk(const __nv_bfloat16* p, int n) {
  const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (2 * j < n ? q[2 * j] : 0u) |
           ((2 * j + 1 < n ? static_cast<uint32_t>(q[2 * j + 1]) : 0u) << 16);
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st_shared16(uint32_t a, uint32_t x0,
                                            uint32_t x1, uint32_t x2,
                                            uint32_t x3) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(x0), "r"(x1), "r"(x2), "r"(x3)
               : "memory");
}
__device__ __forceinline__ void st_shared4(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared2(uint32_t a, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a), "h"(v) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a 128-byte swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// 16 bytes at shared address `addr` of cluster rank `rank`.
__device__ __forceinline__ float4 ld_cluster16(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Elements o[0 .. W) of a row of the output at `at`, of which only the
// first `n` exist; whole W-element stores where the output allows them.
template <int W>
__device__ __forceinline__ void store_out(const Params& p, size_t at,
                                          const float (&o)[W], int n) {
  const bool vec = n >= W && (W == 4 ? p.vec_out : p.vec_out2);
  if (p.out_bf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + at;
    if (vec) {
      uint32_t u[W / 2];
#pragma unroll
      for (int j = 0; j < W / 2; ++j) {
        __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
        u[j] = *reinterpret_cast<uint32_t*>(&h);
      }
      if constexpr (W == 4)
        *reinterpret_cast<uint2*>(out) = make_uint2(u[0], u[1]);
      else
        *reinterpret_cast<uint32_t*>(out) = u[0];
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (j < n) out[j] = from_f32<__nv_bfloat16>(o[j]);
    }
  } else {
    float* out = static_cast<float*>(p.out) + at;
    if (vec) {
      if constexpr (W == 4)
        *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
      else
        *reinterpret_cast<float2*>(out) = make_float2(o[0], o[1]);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (j < n) out[j] = o[j];
    }
  }
}

template <typename Tin, int NWG, int BN>
__global__ void __launch_bounds__(NWG * 128, 1)
matmul_kernel(const Params p) {
  constexpr int THREADS = NWG * 128;
  constexpr int BM = NWG * 64;
  constexpr bool F32 = kParts<Tin> == 2;
  constexpr int VEC = 16 / sizeof(Tin);           // elements a 16-byte chunk
  constexpr int BK = ROW_BYTES / sizeof(Tin);     // k a tile
  constexpr int A_BYTES = F32 ? 0 : BM * ROW_BYTES;   // bf16: A in the ring
  constexpr int B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE = A_BYTES + kParts<Tin> * B_BYTES;
  constexpr int A_CH = 4;                         // x chunks a thread
  constexpr int NCH = BN / VEC;                   // chunks along a row of w
  constexpr int B_CH = BK * NCH / THREADS;        // w chunks a thread
  static_assert(BM * 8 == A_CH * THREADS && B_CH >= 1 &&
                    B_CH * THREADS == BK * NCH && NCH >= 2,
                "whole chunks a thread, two w chunks a k row at least");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);

  const Tin* __restrict__ x = static_cast<const Tin*>(p.x);
  const Tin* __restrict__ w = static_cast<const Tin*>(p.w);
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_lo = min(p.K, static_cast<int>(blockIdx.z) * p.kc);
  const int k_hi = min(p.K, k_lo + p.kc);
  const int tiles = (k_hi - k_lo + BK - 1) / BK;

  // fp32: the k order inside a tile is permuted (a tile's sum does not
  // depend on it) so that thread (lane % 4 = t) of the A fragment owns the
  // 8 contiguous k of 8t .. 8t + 7: k8 step ks takes 8t + 2 ks at fragment
  // column t and 8t + 2 ks + 1 at column t + 4.  Its rows are warp * 16 +
  // lane / 4 and 8 below: two 16-byte loads a row, split in registers, fed
  // to wgmma from registers.  B is stored in the same order: element (n, k)
  // at word k / 8 of 16-byte chunk k % 8 of row n.
  const int a_row = m0 + wg * 64 + warp * 16 + lane / 4;
  const int a_k = 8 * (lane % 4);

  // Two register sets: tile j's chunks travel from global memory in set
  // j % 2, so tiles t + 1 and t + 2 are in flight while tile t's products
  // run.  Set indices are compile-time (the K loop is unrolled by two).
  uint4 ra[2][A_CH], rb[2][B_CH];

  // One 16-byte chunk of a K-major operand (x, or a K-major w): row g of
  // `rows`, k ..; zeros past its rows and this block's K range.
  auto load_k_major = [&](const Tin* src, int g, int rows, int k, int vec) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < rows) {
      src += static_cast<size_t>(g) * p.K + k;
      if (vec) {
        if (k < k_hi) v = ldg16(src);
      } else {
        v = ld_chunk(src, k_hi - k);
      }
    }
    return v;
  };

  // fp32 x: rows a_row and a_row + 8, k a_k .. a_k + 7 (chunks 2r, 2r + 1);
  // bf16 x: chunk (e & 7) of tile row e >> 3.  w chunk: k row kh * 16 +
  // kl, columns n0 + nc * VEC ..: a warp reads 16 k rows of 2 chunks; a
  // K-major w is read as bf16 x is.
  auto load = [&](auto set, int k0) {
    constexpr int S = decltype(set)::value;
#pragma unroll
    for (int it = 0; it < A_CH; ++it) {
      if constexpr (F32) {
        ra[S][it] = load_k_major(x, a_row + 8 * (it / 2), p.M,
                                 k0 + a_k + 4 * (it % 2), p.vec_x);
      } else {
        const int e = it * THREADS + tid;
        ra[S][it] = load_k_major(x, m0 + (e >> 3), p.M, k0 + (e & 7) * VEC,
                                 p.vec_x);
      }
    }
#pragma unroll
    for (int it = 0; it < B_CH; ++it) {
      const int e = it * THREADS + tid;
      if (p.wt) {
        rb[S][it] = load_k_major(w, n0 + (e >> 3), p.N, k0 + (e & 7) * VEC,
                                 p.vec_w);
        continue;
      }
      const int gk = k0 + ((e >> 4) / NCH) * 16 + (e & 15);
      const int gn = n0 + ((e >> 4) % NCH) * VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < k_hi) {
        const Tin* src = w + static_cast<size_t>(gk) * p.N + gn;
        if (p.vec_w) {
          if (gn < p.N) v = ldg16(src);
        } else {
          v = ld_chunk(src, p.N - gn);
        }
      }
      rb[S][it] = v;
    }
  };

  // Register set -> stage s.  fp32: w alone, split into its hi and lo
  // tiles, element by element in the permuted k order.  bf16: x's chunks as
  // they lie, w's as they lie where K-major, else transposed (chunk element
  // i of column n goes to row n + i, at w's k).
  auto store = [&](auto set, int s) {
    constexpr int S = decltype(set)::value;
    const uint32_t a_st = base + s * STAGE;            // bf16 only
    const uint32_t b_hi = a_st + A_BYTES;
    const uint32_t b_lo = b_hi + B_BYTES;              // fp32 only
    if constexpr (F32) {
#pragma unroll
      for (int it = 0; it < B_CH; ++it) {
        const int e = it * THREADS + tid;
        const uint4 v = rb[S][it];
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // (n, k) of element i: K-major w's chunk runs along k, row-major
          // w's along n.
          const int n = p.wt ? (e >> 3) : ((e >> 4) % NCH) * 4 + i;
          const int k = p.wt ? (e & 7) * 4 + i
                             : ((e >> 4) / NCH) * 16 + (e & 15);
          const uint32_t off = swz(n, k & 7) + 4 * (k >> 3);
          uint32_t h, l;
          split_tf32(words[i], h, l);
          st_shared4(b_hi + off, h);
          st_shared4(b_lo + off, l);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < A_CH; ++it) {
        const int e = it * THREADS + tid;
        const uint4 v = ra[S][it];
        st_shared16(a_st + swz(e >> 3, e & 7), v.x, v.y, v.z, v.w);
      }
#pragma unroll
      for (int it = 0; it < B_CH; ++it) {
        const int e = it * THREADS + tid;
        const uint4 v = rb[S][it];
        if (p.wt) {
          st_shared16(b_hi + swz(e >> 3, e & 7), v.x, v.y, v.z, v.w);
          continue;
        }
        const int kb = (((e >> 4) / NCH) * 16 + (e & 15)) * 2;
        const int n = ((e >> 4) % NCH) * VEC;
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          st_shared2(b_hi + swz(n + i, kb >> 4) + (kb & 15),
                     static_cast<uint16_t>(words[i / 2] >> (16 * (i % 2))));
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t a_hi[4][4], a_lo[4][4];   // fp32: tile t's A fragments, by k8 step

  using Set0 = std::integral_constant<int, 0>;
  using Set1 = std::integral_constant<int, 1>;
  if (tiles > 0) load(Set0{}, k_lo);
  if (tiles > 1) load(Set1{}, k_lo + BK);
  if (tiles > 0) store(Set0{}, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Tile t: (fp32) its A fragments split from its register set; tile
  // t + 2's loads into that set; its products on stage t % 2; tile t + 1
  // (loaded one step ago) stored into the other stage, whose products
  // finished before the last barrier.
  auto step = [&](auto set, int t) {
    constexpr int S = decltype(set)::value;
    using Next = std::integral_constant<int, 1 - S>;
    const int s = t & 1;
    if constexpr (F32) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint4 r0 = ra[S][ks / 2], r1 = ra[S][2 + ks / 2];
        const uint32_t v[4] = {ks % 2 ? r0.z : r0.x, ks % 2 ? r1.z : r1.x,
                               ks % 2 ? r0.w : r0.y, ks % 2 ? r1.w : r1.y};
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(v[j], a_hi[ks][j], a_lo[ks][j]);
      }
    }
    if (t + 2 < tiles) load(set, k_lo + (t + 2) * BK);
    const uint64_t db = wgmma_desc(base + s * STAGE + A_BYTES, 16, 1024);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {       // 32 bytes of k a step
      const uint64_t o = ks * 2;
      if constexpr (F32) {
        const uint64_t dbl = db + B_BYTES / 16;
        Mma<BN>::tf32_rs(acc, a_lo[ks], db + o);
        Mma<BN>::tf32_rs(acc, a_hi[ks], dbl + o);
        Mma<BN>::tf32_rs(acc, a_hi[ks], db + o);
      } else {
        const uint32_t a_st = base + s * STAGE + wg * 64 * ROW_BYTES;
        Mma<BN>::bf16(acc, wgmma_desc(a_st, 16, 1024) + o, db + o);
      }
    }
    wgmma_commit();
    if (t + 1 < tiles) store(Next{}, s ^ 1);
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (F32) {
      fence_regs(a_hi);
      fence_regs(a_lo);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  for (int t = 0; t < tiles; t += 2) {
    step(Set0{}, t);
    if (t + 1 < tiles) step(Set1{}, t + 1);
  }

  // The epilogue, compiled once for each activation and picked once: a
  // switch on the activation inside the unrolled fragment loop costs more
  // than the rest of the epilogue.
  const int S = gridDim.z;
  auto finish = [&](auto act) {
    constexpr int ACT = decltype(act)::value;
    if (S == 1) {
      // No split: bias, activation and cast on the fragment, stored as it
      // lies (a quad of lanes writes 8 or 16 contiguous bytes of a row).
      // Fragment register i of thread (warp, lane) holds row warp * 16 +
      // lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) +
      // i % 2.
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int gm =
            m0 + wg * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
        const int gn = n0 + 8 * (i / 4) + 2 * (lane % 4);
        if (gm < p.M && gn < p.N) {
          float o[2] = {acc[i], acc[i + 1]};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (p.bias != nullptr && gn + j < p.N) o[j] += p.bias[gn + j];
            o[j] = apply_act(ACT, o[j]);
          }
          store_out(p, static_cast<size_t>(gm) * p.N + gn, o, p.N - gn);
        }
      }
      return;
    }

    // Split K: the partial tile (fp32, rows BN + 8 floats apart) over the
    // ring, then this rank's share of the tile's rows summed over the
    // cluster in rank order, every rank's loads issued before any sum
    // waits on them.
    constexpr int PS = BN + 8;
    float* const part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int row = wg * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + row * PS + col) =
          make_float2(acc[i], acc[i + 1]);
    }
    cluster_sync();

    constexpr int C4 = BN / 4;
    constexpr int ITER = ((BM / 2) * C4 + THREADS - 1) / THREADS;  // S >= 2
    const int share = (BM + S - 1) / S;
    const int r_lo = static_cast<int>(cluster_rank()) * share;
    const int chunks = (min(BM, r_lo + share) - r_lo) * C4;
    uint32_t at[ITER];
    float4 v[ITER];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int e = max(0, min(it * THREADS + tid, chunks - 1));
      at[it] = smem_u32(part + (r_lo + e / C4) * PS + (e % C4) * 4);
      v[it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < MAX_SLICES; ++q) {
      if (q < S) {
#pragma unroll
        for (int it = 0; it < ITER; ++it) {
          const float4 u = ld_cluster16(at[it], q);
          v[it].x += u.x;
          v[it].y += u.y;
          v[it].z += u.z;
          v[it].w += u.w;
        }
      }
    }
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int e = it * THREADS + tid;
      const int gm = m0 + r_lo + e / C4, gn = n0 + (e % C4) * 4;
      if (e < chunks && gm < p.M && gn < p.N) {
        float o[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (p.bias != nullptr && gn + j < p.N) o[j] += p.bias[gn + j];
          o[j] = apply_act(ACT, o[j]);
        }
        store_out(p, static_cast<size_t>(gm) * p.N + gn, o, p.N - gn);
      }
    }
    cluster_sync();   // every rank has read this block's partial tile
  };
  switch (p.act) {
    case ACT_RELU: finish(ActC<ACT_RELU>{}); break;
    case ACT_GELU: finish(ActC<ACT_GELU>{}); break;
    case ACT_SILU: finish(ActC<ACT_SILU>{}); break;
    case ACT_TANH: finish(ActC<ACT_TANH>{}); break;
    case ACT_SIGMOID: finish(ActC<ACT_SIGMOID>{}); break;
    default: finish(ActC<ACT_NONE>{});
  }
}

template <typename Tin, int NWG, int BN>
int launch(const Params& p, int slices, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tin, NWG, BN>();
  static bool configured = false;   // once per instance and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel<Tin, NWG, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.M + 64 * NWG - 1) / (64 * NWG), (p.N + BN - 1) / BN,
                     slices);
  cfg.blockDim = dim3(NWG * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = slices;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, matmul_kernel<Tin, NWG, BN>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int smem_of(int bm, int bn) {
  if (bm == 64 && bn == 32) return smem_bytes<Tin, 1, 32>();
  if (bm == 64 && bn == 64) return smem_bytes<Tin, 1, 64>();
  if (bm == 128 && bn == 32) return smem_bytes<Tin, 2, 32>();
  if (bm == 128 && bn == 64) return smem_bytes<Tin, 2, 64>();
  return -1;
}

template <typename Tin>
int dispatch(const Params& p, int bm, int bn, int slices, cudaStream_t s) {
  if (bm == 64 && bn == 32) return launch<Tin, 1, 32>(p, slices, s);
  if (bm == 64 && bn == 64) return launch<Tin, 1, 64>(p, slices, s);
  if (bm == 128 && bn == 32) return launch<Tin, 2, 32>(p, slices, s);
  if (bm == 128 && bn == 64) return launch<Tin, 2, 64>(p, slices, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M,K) row-major and w (K,N) row-major, or K-major (strides (1, K))
// where w_kmajor, of in_dtype, any alignment; bias (N,) fp32
// or null; out (M,N) row-major of out_dtype.  The tile is bm x bn (bm 64 or
// 128, bn 32, 64 or 128) and K is cut into `slices` (1 to 8) ranges of whole
// k tiles, one cluster of `slices` blocks a tile.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int systolic_matmul(const void* x, const void* w, int w_kmajor,
                               const float* bias, void* out, int M, int N,
                               int K, int bm, int bn, int slices,
                               int in_dtype, int out_dtype, int act,
                               void* stream) {
  if (slices < 1 || slices > MAX_SLICES ||
      (out_dtype != DTYPE_F32 && out_dtype != DTYPE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esz = in_dtype == DTYPE_F32 ? 4 : 2;
  const int bk = ROW_BYTES / esz;
  const int vec = 16 / esz;
  const auto aligned = [](const void* q, int bytes) {
    return reinterpret_cast<uintptr_t>(q) % bytes == 0;
  };
  Params p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.kc = K > 0 ? ((K + slices - 1) / slices + bk - 1) / bk * bk : bk;
  p.act = act;
  p.out_bf16 = out_dtype == DTYPE_BF16;
  p.vec_x = K % vec == 0 && aligned(x, 16);
  p.wt = w_kmajor != 0;
  p.vec_w = (p.wt ? K : N) % vec == 0 && aligned(w, 16);
  p.vec_out = N % 4 == 0 && aligned(out, p.out_bf16 ? 8 : 16);
  p.vec_out2 = N % 2 == 0 && aligned(out, p.out_bf16 ? 4 : 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DTYPE_F32) return dispatch<float>(p, bm, bn, slices, s);
  if (in_dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(p, bm, bn, slices, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a block of the bm x bn instance, in bytes (-1 for
// a tile the kernel does not have).
extern "C" int systolic_matmul_smem_bytes(int bm, int bn, int in_dtype) {
  return in_dtype == DTYPE_F32 ? smem_of<float>(bm, bn)
                               : smem_of<__nv_bfloat16>(bm, bn);
}
