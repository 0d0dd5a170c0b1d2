// The DSA vector engine's three kernels.
//
// K2: the fused affine pass, y = act(x * scale + bias) with per-column (N,)
// scale and bias, computed in fp32 and cast.
//
// Replaces: src/repro/kernels/vector_engine.py::fused_affine_act
// (_affine_kernel), the Pallas TPU kernel that gives each grid step a block
// of bm rows with all N columns in VMEM.
//
// What bounds it on the H100: bytes.  It reads each x element once and
// writes one output for 2 flops, so it runs at the memory rate; at the
// request's shape, (1, 150528) with f1's per-column scale and bias as long
// as x, the call moves 2.4 MB (0.0007 ms), less than a launch's fixed cost.
//
// What the design does about it:
// - Two-dimensional indexing.  blockIdx.x takes a slab of THREADS vectors of
//   columns, blockIdx.y a group of rows walked with a stride of gridDim.y:
//   a thread's columns come from its position, so no element pays a
//   division, and it reads its scale and bias once and reuses them on every
//   row it walks (at (256, 1024) they are read once a block, not once an
//   element).
// - 16-byte vectors: 4 fp32 or 8 bf16 of x a load, the outputs in one
//   8-byte (fp32 in, bf16 out), one or two 16-byte stores.  A vector's
//   columns start at a multiple of its width, where scale and bias (16-byte
//   aligned, as the wrapper hands them over) are aligned.  A row whose x or
//   output is not aligned there (an unaligned base, or an N no multiple of
//   the vector) is read or written element by element in that row, and the
//   columns past a row's last whole vector are taken by one more thread,
//   element by element.
// - One wave: the grid is at most the blocks the card holds at once; a
//   thread with many rows issues the loads of ROW_UNROLL rows before it
//   computes any, and one with a few takes them one at a time.
// Multiply and add are rounded separately, as the plain PyTorch version's
// two operations are.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROW_UNROLL = 4;                 // rows a thread loads at once
constexpr int BLOCKS_PER_SM = 2048 / THREADS;

template <typename T>
constexpr int VEC_OF = static_cast<int>(16 / sizeof(T));  // a 16-byte vector

// One vector of x (aligned: one 16-byte load) or its first n elements.
template <int V>
__device__ __forceinline__ void load_x(const float* p, bool aligned, int n,
                                       float (&v)[V]) {
  if (aligned) {
    const uint4 w = ldg16(p);
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = j < n ? __ldg(p + j) : 0.0f;
}
template <int V>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, bool aligned,
                                       int n, float (&v)[V]) {
  if (aligned) {
    const uint4 w = ldg16(p);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(u[j] << 16);
      v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = j < n ? to_f32(p[j]) : 0.0f;
}

// V outputs (aligned: in vector stores) or their first n.
template <int V>
__device__ __forceinline__ void store_out(float* p, bool aligned, int n,
                                          const float (&v)[V]) {
  if (aligned) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < n) p[j] = v[j];
}
template <int V>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, bool aligned,
                                          int n, const float (&v)[V]) {
  if (aligned) {
    uint32_t u[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (V == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < n) p[j] = from_f32<__nv_bfloat16>(v[j]);
}

template <typename T>
__device__ __forceinline__ bool aligned_to(const T* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// One row's vector (or the tail's n < V elements) from its x values.
template <int ACT, typename Tout, int V>
__device__ __forceinline__ void affine_row(Tout* orow, int n,
                                           const float (&sc)[V],
                                           const float (&bi)[V],
                                           const float (&xv)[V]) {
  constexpr int OUT_ALIGN = V * sizeof(Tout) < 16 ? V * sizeof(Tout) : 16;
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = apply_act(ACT, __fadd_rn(__fmul_rn(xv[j], sc[j]), bi[j]));
  store_out(orow, n == V && aligned_to(orow, OUT_ALIGN), n, v);
}

template <int ACT, typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
affine_act_kernel(const Tin* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, Tout* __restrict__ out,
                  long long M, int N) {
  constexpr int V = VEC_OF<Tin>;
  const int nvec = N / V;                     // whole vectors a row
  const int k = blockIdx.x * THREADS + threadIdx.x;
  const int n = k < nvec ? V : N - nvec * V;  // the tail's thread: N % V
  if (k > nvec || n == 0) return;
  const int c0 = k * V;
  float sc[V], bi[V];
  if (n == V) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const uint4 a = ldg16(scale + c0 + j), b = ldg16(bias + c0 + j);
      sc[j] = __uint_as_float(a.x), sc[j + 1] = __uint_as_float(a.y);
      sc[j + 2] = __uint_as_float(a.z), sc[j + 3] = __uint_as_float(a.w);
      bi[j] = __uint_as_float(b.x), bi[j + 1] = __uint_as_float(b.y);
      bi[j + 2] = __uint_as_float(b.z), bi[j + 3] = __uint_as_float(b.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sc[j] = j < n ? __ldg(scale + c0 + j) : 0.0f;
      bi[j] = j < n ? __ldg(bias + c0 + j) : 0.0f;
    }
  }
  const long long gy = gridDim.y;
  long long r = blockIdx.y;
  // whole groups of ROW_UNROLL rows: every load issued before any is used
  for (; r + (ROW_UNROLL - 1) * gy < M; r += ROW_UNROLL * gy) {
    float xv[ROW_UNROLL][V];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const Tin* xr = x + (r + u * gy) * N + c0;
      load_x(xr, n == V && aligned_to(xr, 16), n, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u)
      affine_row<ACT>(out + (r + u * gy) * N + c0, n, sc, bi, xv[u]);
  }
  for (; r < M; r += gy) {                    // the rest, a row at a time
    float xv[V];
    const Tin* xr = x + r * N + c0;
    load_x(xr, n == V && aligned_to(xr, 16), n, xv);
    affine_row<ACT>(out + r * N + c0, n, sc, bi, xv);
  }
}

// The blocks the current device holds at once, for THREADS-thread blocks.
__host__ long long affine_grid_blocks() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<long long>(sms) * BLOCKS_PER_SM;
}

template <int ACT, typename Tin, typename Tout>
void launch_act(dim3 grid, const void* x, const float* scale,
                const float* bias, void* out, long long M, int N,
                cudaStream_t stream) {
  affine_act_kernel<ACT, Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), scale, bias, static_cast<Tout*>(out), M, N);
}

// The activation is a template argument, so no element pays a switch.
template <typename Tin, typename Tout>
int launch(const void* x, const float* scale, const float* bias, void* out,
           long long M, int N, int act, cudaStream_t stream) {
  constexpr int V = VEC_OF<Tin>;
  const long long slots = N / V + (N % V ? 1 : 0);
  const long long gx = (slots + THREADS - 1) / THREADS;
  long long gy = affine_grid_blocks() / gx;
  if (gy < 1) gy = 1;
  if (gy > M) gy = M;
  if (gy > 65535) gy = 65535;
  if (gx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  switch (act) {
    case ACT_NONE:
      launch_act<ACT_NONE, Tin, Tout>(grid, x, scale, bias, out, M, N, stream);
      break;
    case ACT_RELU:
      launch_act<ACT_RELU, Tin, Tout>(grid, x, scale, bias, out, M, N, stream);
      break;
    case ACT_GELU:
      launch_act<ACT_GELU, Tin, Tout>(grid, x, scale, bias, out, M, N, stream);
      break;
    case ACT_SILU:
      launch_act<ACT_SILU, Tin, Tout>(grid, x, scale, bias, out, M, N, stream);
      break;
    case ACT_TANH:
      launch_act<ACT_TANH, Tin, Tout>(grid, x, scale, bias, out, M, N, stream);
      break;
    case ACT_SIGMOID:
      launch_act<ACT_SIGMOID, Tin, Tout>(grid, x, scale, bias, out, M, N,
                                         stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M,N) row-major of in_dtype, at any base; scale, bias (N,) fp32,
// 16-byte aligned; out (M,N) row-major of out_dtype.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int fused_affine_act(const void* x, const float* scale,
                                const float* bias, void* out, long long M,
                                int N, int in_dtype, int out_dtype, int act,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(bias)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (in_dtype == DTYPE_F32 && out_dtype == DTYPE_F32)
    return launch<float, float>(x, scale, bias, out, M, N, act, s);
  if (in_dtype == DTYPE_F32 && out_dtype == DTYPE_BF16)
    return launch<float, __nv_bfloat16>(x, scale, bias, out, M, N, act, s);
  if (in_dtype == DTYPE_BF16 && out_dtype == DTYPE_F32)
    return launch<__nv_bfloat16, float>(x, scale, bias, out, M, N, act, s);
  if (in_dtype == DTYPE_BF16 && out_dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, out, M, N, act,
                                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3 and K4: per-row symmetric int8 quantization and its inverse.
//
//   scale_r = max(absmax_r, 1e-12) / 127,  q = clip(rint(x / scale_r), +-127)
//   x' = float(q) * scale_r, cast to the output type
//
// Replaces: src/repro/kernels/vector_engine.py::quantize_int8 (_quant_kernel)
// and ::dequantize_int8 (_dequant_kernel), Pallas TPU kernels whose grid
// gives each step bm whole rows in VMEM, so the row's absmax is one
// in-register reduction.  The codes must equal the plain version (and the
// TPU kernel) byte for byte.
//
// What bounds them on the H100: bytes.  K3 reads each element (4 or 2
// bytes) and writes one byte; K4 reads one byte and writes 4 or 2; a few
// operations an element.  The training path hands K3 each gradient leaf
// flattened to ONE row, ten leaves a step, up to 215,482,368 fp32 elements
// (Mamba-2 370M's stacked in_proj: 862 MB, far more than the card holds on
// chip), and seven of the ten leaves are small enough that a launch's
// latency is all they cost.
//
// K3's design: one persistent, cooperative launch a call.
// - The grid is at most the co-resident blocks (SMs x the occupancy of 256
//   threads), launched with the cooperative attribute, which guarantees
//   they all run at once or refuses the launch.  Each row is cut into
//   `segs` items of whole 16-byte vectors (a row with few vectors is one
//   item; many rows give one item each), and block b takes items b, b+G,
//   b+2G, ...  A grid barrier parts the two phases:
//   phase 1 takes each item's absmax into `part[item]`, phase 2 takes the
//   row's absmax from its items' words and writes the codes and the scale.
//   Every word of `part` is written before the barrier and read after it,
//   so no memset comes first; the barrier's own two words (arrivals and
//   generation, a __device__ global) return to rest in every launch, so a
//   CUDA graph replays the launch as it is.  Two K3 launches must not run
//   at once on one device (they share the barrier): PyTorch's current
//   stream orders them on every path of the port.
// - 16-byte loads (4 fp32 or 8 bf16, each asking L2 for the 256 bytes
//   around it) and 4- or 8-byte stores of the codes, four vectors in
//   flight a thread.  A row's head (up to the first 16-byte
//   boundary) and tail (past its last whole vector) are taken one element
//   at a time by the row's first and last items, so any base offset and
//   any N take the same kernel.  Where x's base is not 16-byte aligned the
//   codes of the vectors are stored a byte at a time.
// - Read once where it fits: each block keeps the first 24 KB of its share
//   in shared memory across the barrier (the whole share of a row up to
//   ~6,000 fp32 elements an item: every small leaf and every short row).
//   Phase 2 walks the rest of its share in the reverse of phase 1's order,
//   so its first reloads are what phase 1 read last, still in the 50 MB L2.
// - Given absmax (GIVEN): the caller hands each row's absmax, as a
//   rank holding one block of a gradient leaf that is split over a mesh
//   does with the whole leaf's (an all-reduce MAX over the blocks), so
//   that its codes are the whole leaf's, block for block.  Phase 1 and
//   the grid barrier go; the same grid walks phase 2, reading x from
//   global memory, in an ordinary (not cooperative) launch, and `part`
//   is not touched.
//   The code stores are marked evict-first (the reloads are not: marked so
//   they took 0.757 ms at the largest leaf on an H100, against 0.714
//   unmarked, tools/k3_ablate.py).
// - The arithmetic is the plain version's, byte for byte: the absmax
//   is taken on the bits of |x|, which order exactly as the floats do for
//   values >= 0, so it is the row's exact max in any order, and |NaN|'s
//   bits exceed every other value's, so a row holding a NaN gets a NaN
//   absmax and scale (fmaxf would drop a NaN); the scale and x / scale are
//   IEEE divisions (__fdiv_rn, never a multiply by the reciprocal; the
//   build has no fast math); rintf rounds half to even as jnp.round and
//   torch.round do; the clamp comes before the cast; a NaN quotient gets
//   code 0 (as XLA's and PyTorch's float-to-int casts give it), and K4's
//   0 * NaN or 0 * Inf then makes the whole row NaN.
//
// K4's design: a row is cut into `segs` segments, one block each, in a
// flat grid of M * segs blocks, one rounded multiply an element, cast with
// round-to-nearest-even.  It runs at ~80% of its bound and is left so.
namespace {

constexpr int QTHREADS = 256;
constexpr int QUNROLL = 4;                    // vectors in flight a thread
constexpr int STASH_BYTES = 24 * 1024;        // a block's share kept on chip
constexpr int STASH_VECS = STASH_BYTES / 16;
constexpr long long MIN_ITEM_VECS = 2LL * QTHREADS;

// K4's segments a row: enough blocks in all to fill the card, none with
// fewer than ~16 elements a thread.
__host__ int row_segments(long long M, long long N) {
  const long long per_block = 16LL * QTHREADS;
  long long segs = (N + per_block - 1) / per_block;
  long long cap = 132LL * 32 / (M > 0 ? M : 1);
  if (cap < 1) cap = 1;
  if (segs > cap) segs = cap;
  return static_cast<int>(segs < 1 ? 1 : segs);
}

// 16 bytes through the read-only path, asking L2 to fetch the 256 bytes
// around them (0.714 -> 0.691 ms at the largest leaf on an H100,
// tools/k3_ablate.py).
__device__ __forceinline__ uint4 ldg16_l2(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float quant_scale(float absmax) {
  return __fdiv_rn(isnan(absmax) ? absmax : fmaxf(absmax, 1e-12f), 127.0f);
}

__device__ __forceinline__ int quant1(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return isnan(r) ? 0 : static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// The grid barrier of K3's launch: arrivals and generation.
__device__ unsigned int g_quant_barrier[2];

// Every block of the grid arrives; none leaves before all have.  Thread 0
// of the last block to arrive puts the count back to 0 and moves the
// generation on, so the words are at rest again after the launch.
__device__ void grid_sync() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &g_quant_barrier[1];
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(&g_quant_barrier[0], 1u) == gridDim.x - 1) {
      atomicExch(&g_quant_barrier[0], 0u);
      __threadfence();
      atomicAdd(&g_quant_barrier[1], 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The max of `m` over the block, in every thread.
__device__ __forceinline__ unsigned int block_max(unsigned int m,
                                                  unsigned int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < QTHREADS / 32; ++w) m = max(m, red[w]);
  __syncthreads();
  return m;
}

// Per element type: the bits of |x| folded into a running max (bf16 as
// two packed 16-bit maxima, unpacked by `finish`), one element's value,
// and a vector's codes.
template <typename E> struct Quant;

template <> struct Quant<float> {
  static constexpr int VEC = 4;
  using Codes = unsigned int;
  __device__ static unsigned int fold(unsigned int m, uint4 v) {
    m = max(m, v.x & 0x7fffffffu);
    m = max(m, v.y & 0x7fffffffu);
    m = max(m, v.z & 0x7fffffffu);
    return max(m, v.w & 0x7fffffffu);
  }
  __device__ static unsigned int fold1(unsigned int m, float e) {
    return max(m, __float_as_uint(e) & 0x7fffffffu);
  }
  __device__ static unsigned int finish(unsigned int m) { return m; }
  __device__ static float value(float e) { return e; }
  __device__ static Codes codes(uint4 v, float s) {
    return (quant1(__uint_as_float(v.x), s) & 0xff) |
           (quant1(__uint_as_float(v.y), s) & 0xff) << 8 |
           (quant1(__uint_as_float(v.z), s) & 0xff) << 16 |
           static_cast<unsigned int>(quant1(__uint_as_float(v.w), s)) << 24;
  }
};

template <> struct Quant<__nv_bfloat16> {
  static constexpr int VEC = 8;
  using Codes = uint2;
  __device__ static unsigned int fold(unsigned int m, uint4 v) {
    m = __vmaxu2(m, v.x & 0x7fff7fffu);
    m = __vmaxu2(m, v.y & 0x7fff7fffu);
    m = __vmaxu2(m, v.z & 0x7fff7fffu);
    return __vmaxu2(m, v.w & 0x7fff7fffu);
  }
  __device__ static unsigned int fold1(unsigned int m, __nv_bfloat16 e) {
    return __vmaxu2(m, __bfloat16_as_ushort(e) & 0x7fffu);
  }
  // the larger half, as the bits of the fp32 value (exact: bf16 -> fp32
  // appends 16 zero bits)
  __device__ static unsigned int finish(unsigned int m) {
    return max(m & 0xffffu, m >> 16) << 16;
  }
  __device__ static float value(__nv_bfloat16 e) { return to_f32(e); }
  __device__ static unsigned int pair(unsigned int w, float s) {
    return (quant1(__uint_as_float(w << 16), s) & 0xff) |
           (quant1(__uint_as_float(w & 0xffff0000u), s) & 0xff) << 8;
  }
  __device__ static Codes codes(uint4 v, float s) {
    return make_uint2(pair(v.x, s) | pair(v.y, s) << 16,
                      pair(v.z, s) | pair(v.w, s) << 16);
  }
};

// An item: the vectors [v0, v1) of row `row`'s body, which starts `h`
// elements in (the row's head, up to the first 16-byte boundary of x); the
// row's tail starts at element `tail`.  The first item of a row also takes
// its head, the last its tail.
struct Item {
  long long row, v0, v1, h, tail;
  bool first, last;
};

template <int VEC>
__device__ __forceinline__ Item item_of(long long it, long long N, int segs,
                                        int xoff) {
  Item s;
  s.row = it / segs;
  const long long seg = it - s.row * segs;
  const long long a = (xoff + s.row * N) % VEC;
  s.h = a ? VEC - a : 0;
  if (s.h > N) s.h = N;
  const long long nv = (N - s.h) / VEC;
  s.v0 = nv * seg / segs;
  s.v1 = nv * (seg + 1) / segs;
  s.tail = s.h + nv * VEC;
  s.first = seg == 0;
  s.last = seg == segs - 1;
  return s;
}

// x (M, N) -> q (M, N), scales (M,); part (M * segs) 32-bit scratch.
// xoff: x's base address modulo 16, in elements.  QV: the codes of a
// vector go out in one store (x's base is 16-byte aligned).  GIVEN: the
// rows' absmax is read from `given` (M,), and neither phase 1 nor the
// barrier runs.
template <typename E, bool QV, bool GIVEN>
__global__ void __launch_bounds__(QTHREADS, 4)
quantize_int8_kernel(const E* __restrict__ x, signed char* __restrict__ q,
                     float* __restrict__ scales, unsigned int* part,
                     const float* __restrict__ given, long long M,
                     long long N, int segs, int xoff) {
  using Q = Quant<E>;
  constexpr int VEC = Q::VEC;
  constexpr long long STEP = static_cast<long long>(QTHREADS) * QUNROLL;
  __shared__ uint4 stash[STASH_VECS];
  __shared__ unsigned int red[QTHREADS / 32];
  const long long items = M * segs;
  const long long G = gridDim.x;
  const int tid = threadIdx.x;

  // ---- phase 1: each item's absmax; the first STASH_VECS of the block's
  // vectors kept in shared memory
  long long sbase = 0;                  // the block's vectors so far
  for (long long it = blockIdx.x; !GIVEN && it < items; it += G) {
    const Item s = item_of<VEC>(it, N, segs, xoff);
    const E* xr = x + s.row * N;
    unsigned int m = 0u;
    if (s.first)
      for (long long e = tid; e < s.h; e += QTHREADS) m = Q::fold1(m, xr[e]);
    if (s.last)
      for (long long e = s.tail + tid; e < N; e += QTHREADS)
        m = Q::fold1(m, xr[e]);
    const uint4* xv = reinterpret_cast<const uint4*>(xr + s.h) + s.v0;
    const long long nv = s.v1 - s.v0;
    for (long long k0 = 0; k0 < nv; k0 += STEP) {
      uint4 v[QUNROLL];
#pragma unroll
      for (int u = 0; u < QUNROLL; ++u) {
        const long long k = k0 + u * QTHREADS + tid;
        v[u] = k < nv ? ldg16_l2(xv + k) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < QUNROLL; ++u) {
        const long long k = k0 + u * QTHREADS + tid;
        m = Q::fold(m, v[u]);           // a zero vector leaves m as it is
        if (k < nv && sbase + k < STASH_VECS) stash[sbase + k] = v[u];
      }
    }
    m = block_max(Q::finish(m), red);
    if (tid == 0) part[it] = m;
    sbase += nv;
  }

  if constexpr (!GIVEN) grid_sync();

  // ---- phase 2: the block's items and vectors in reverse order
  const long long mine = (items - blockIdx.x + G - 1) / G;
  for (long long it = blockIdx.x + (mine - 1) * G; it >= 0; it -= G) {
    const Item s = item_of<VEC>(it, N, segs, xoff);
    const long long nv = s.v1 - s.v0;
    sbase -= nv;
    float absmax;
    if constexpr (GIVEN) {
      absmax = __ldg(given + s.row);
    } else {
      unsigned int m = 0u;
      const unsigned int* pr = part + s.row * segs;
      for (int i = tid; i < segs; i += QTHREADS) m = max(m, __ldcg(pr + i));
      absmax = __uint_as_float(block_max(m, red));
    }
    const float scale = quant_scale(absmax);
    if (s.first && tid == 0) scales[s.row] = scale;
    const E* xr = x + s.row * N;
    signed char* qr = q + s.row * N;
    const uint4* xv = reinterpret_cast<const uint4*>(xr + s.h) + s.v0;
    signed char* qv = qr + s.h + s.v0 * VEC;
    for (long long k0 = nv > 0 ? (nv - 1) / STEP * STEP : -1; k0 >= 0;
         k0 -= STEP) {
      uint4 v[QUNROLL];
#pragma unroll
      for (int u = QUNROLL - 1; u >= 0; --u) {
        const long long k = k0 + u * QTHREADS + tid;
        if (k < nv)
          v[u] = !GIVEN && sbase + k < STASH_VECS ? stash[sbase + k]
                                                  : ldg16_l2(xv + k);
      }
#pragma unroll
      for (int u = QUNROLL - 1; u >= 0; --u) {
        const long long k = k0 + u * QTHREADS + tid;
        if (k >= nv) continue;
        const typename Q::Codes c = Q::codes(v[u], scale);
        if constexpr (QV) {
          __stcs(reinterpret_cast<typename Q::Codes*>(qv) + k, c);
        } else {
          const unsigned char* b = reinterpret_cast<const unsigned char*>(&c);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            qv[k * VEC + i] = static_cast<signed char>(b[i]);
        }
      }
    }
    if (s.first)
      for (long long e = tid; e < s.h; e += QTHREADS)
        qr[e] = static_cast<signed char>(quant1(Q::value(xr[e]), scale));
    if (s.last)
      for (long long e = s.tail + tid; e < N; e += QTHREADS)
        qr[e] = static_cast<signed char>(quant1(Q::value(xr[e]), scale));
  }
}

template <typename Tout>
__global__ void __launch_bounds__(QTHREADS)
dequantize_kernel(const signed char* __restrict__ q,
                  const float* __restrict__ scales, Tout* __restrict__ out,
                  long long N, int segs) {
  const long long row = blockIdx.x / segs;
  const int seg = static_cast<int>(blockIdx.x - row * segs);
  const float scale = scales[row];
  const signed char* qr = q + row * N;
  Tout* outr = out + row * N;
  const long long stride = static_cast<long long>(segs) * QTHREADS;
  for (long long i = static_cast<long long>(seg) * QTHREADS + threadIdx.x;
       i < N; i += stride)
    outr[i] = from_f32<Tout>(
        __fmul_rn(static_cast<float>(qr[i]), scale));
}

// K3's plan at (M, N): the co-resident blocks, the items a row and the
// grid.  The occupancy is read once per kernel instance and device 0's SM
// count is taken for every device (the port runs on one kind of card).
struct QuantPlan {
  long long resident, segs, grid;
};

template <typename E, bool QV>
long long resident_blocks() {
  static const long long n = [] {
    auto kernel = quantize_int8_kernel<E, QV, false>;
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, QTHREADS,
                                                  0);
    return static_cast<long long>(sms) * per_sm;
  }();
  return n;
}

template <typename E, bool QV>
QuantPlan quant_plan(long long M, long long N) {
  QuantPlan p;
  p.resident = resident_blocks<E, QV>();
  const long long nv = N / Quant<E>::VEC;
  long long segs = (nv + MIN_ITEM_VECS - 1) / MIN_ITEM_VECS;
  long long cap = p.resident / M;
  if (cap < 1) cap = 1;
  if (segs > cap) segs = cap;
  p.segs = segs < 1 ? 1 : segs;
  p.grid = M * p.segs < p.resident ? M * p.segs : p.resident;
  return p;
}

// The plan is the cooperative kernel's for either form, so a given
// absmax walks the same items with the same grid.
template <typename E, bool QV>
int launch_quantize(const void* x, signed char* q, float* scales,
                    unsigned int* part, const float* given, long long M,
                    long long N, int xoff, long long segs,
                    cudaStream_t stream) {
  const QuantPlan p = quant_plan<E, QV>(M, N);
  if (p.resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (p.segs != segs) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.grid));
  cfg.blockDim = dim3(QTHREADS);
  cfg.stream = stream;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cfg.attrs = given ? nullptr : &coop;
  cfg.numAttrs = given ? 0 : 1;
  const E* xe = static_cast<const E*>(x);
  const int sg = static_cast<int>(p.segs);
  const cudaError_t err =
      given ? cudaLaunchKernelEx(&cfg, quantize_int8_kernel<E, QV, true>, xe,
                                 q, scales, part, given, M, N, sg, xoff)
            : cudaLaunchKernelEx(&cfg, quantize_int8_kernel<E, QV, false>,
                                 xe, q, scales, part, given, M, N, sg, xoff);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
QuantPlan plan_for(long long M, long long N, bool qv) {
  return qv ? quant_plan<E, true>(M, N) : quant_plan<E, false>(M, N);
}

}  // namespace

// K3's launch at (M, N) for `dtype`, into out[0..4]: the grid, the items a
// row (the scratch `part` of quantize_int8 holds M times as many words),
// the co-resident blocks, the threads a block and the shared memory a
// block keeps across the barrier.  `aligned`: x's base is 16-byte aligned.
extern "C" int quantize_int8_plan(long long M, long long N, int dtype,
                                  int aligned, long long* out) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  QuantPlan p;
  if (dtype == DTYPE_F32)
    p = plan_for<float>(M, N, aligned != 0);
  else if (dtype == DTYPE_BF16)
    p = plan_for<__nv_bfloat16>(M, N, aligned != 0);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.grid;
  out[1] = p.segs;
  out[2] = p.resident;
  out[3] = QTHREADS;
  out[4] = STASH_BYTES;
  return static_cast<int>(cudaGetLastError());
}

// x (M, N) row-major of `dtype` (common.cuh's code), any base offset;
// q (M, N) int8 with a 16-byte aligned base, scales (M,) fp32; part
// (M * segs) 32-bit scratch, segs from quantize_int8_plan; absmax null, or
// the rows' (M,) fp32 absmax, given (then part may be null).  One launch
// on `stream`; returns cudaGetLastError().
extern "C" int quantize_int8(const void* x, signed char* q, float* scales,
                             unsigned int* part, const float* absmax,
                             long long M, long long N, long long segs,
                             int dtype, void* stream) {
  const int esz = dtype == DTYPE_BF16 ? 2 : 4;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (M <= 0 || N <= 0 || segs <= 0 || xa % esz != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || (!part && !absmax))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xoff = static_cast<int>(xa % 16) / esz;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return xoff ? launch_quantize<float, false>(x, q, scales, part, absmax,
                                                  M, N, xoff, segs, s)
                  : launch_quantize<float, true>(x, q, scales, part, absmax,
                                                 M, N, xoff, segs, s);
    case DTYPE_BF16:
      return xoff ? launch_quantize<__nv_bfloat16, false>(
                        x, q, scales, part, absmax, M, N, xoff, segs, s)
                  : launch_quantize<__nv_bfloat16, true>(
                        x, q, scales, part, absmax, M, N, xoff, segs, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (M, N) int8 and scales (M,) fp32 -> out (M, N) of `out_dtype`.
extern "C" int dequantize_int8(const signed char* q, const float* scales,
                               void* out, long long M, long long N,
                               int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || M * row_segments(M, N) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int segs = row_segments(M, N);
  const unsigned blocks = static_cast<unsigned>(M * segs);
  switch (out_dtype) {
    case DTYPE_F32:
      dequantize_kernel<float><<<blocks, QTHREADS, 0, s>>>(
          q, scales, static_cast<float*>(out), N, segs);
      break;
    case DTYPE_BF16:
      dequantize_kernel<__nv_bfloat16><<<blocks, QTHREADS, 0, s>>>(
          q, scales, static_cast<__nv_bfloat16*>(out), N, segs);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
