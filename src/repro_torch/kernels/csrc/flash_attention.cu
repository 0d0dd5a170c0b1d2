// K5: blocked (flash) attention with an online softmax, GQA, causal masking
// and a sliding window.  q (B,H,Sq,D); k, v (B,KV,Skv,D) -> o (B,H,Sq,D).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), the Pallas TPU kernel whose grid (B*H, Sq/bq, Skv/bk)
// carries m, l and acc in VMEM scratch across the sequential KV dimension.
//
// What bounds it on the H100: at the ViT shapes it serves (D=32, Sq=Skv of
// 5 to 197 tokens) the work is tiny and the launch and the per-block loads
// dominate; at long sequences it is the 4*Sq*Skv*D flops of the two
// products, which this fp32 kernel runs on the FMA pipes, not the tensor
// cores.
//
// What the design does about it: one block per (b*h, 32-query tile); the
// KV loop runs inside the block (blocks share nothing), staging BKV keys and
// values at a time in shared memory as fp32.  LANES threads own one query
// row, each with 1/LANES of its head dimension in registers (q and the
// fp32 accumulator), and combine their partial q.k with log2(LANES) warp
// shuffles, so a row's m and l stay in registers with no block-wide
// reduction.  D in {16, 32, 64, 128} takes 4 lanes and 32-key tiles.
// D = 256 (RecurrentGemma-2B's local attention) takes 8 lanes, so that a
// thread still holds 32 floats of q and 32 of the accumulator, and 16-key
// tiles: two [16][256] fp32 tiles are 32 KB, inside the 48 KB of static
// shared memory, where [32][256] would be 64 KB.  Every block walks all
// the KV tiles, masked ones included (skipping them is later work).  The
// mask value is the finite NEG_INF = -1e30 of the TPU kernel, and l is
// clamped at 1e-30: a fully masked tile then adds weight that the first
// unmasked tile's rescale (alpha = 0) wipes out, where -inf would give NaN.
// Keys past Skv (the ragged last tile) get no weight at all, so Sq and Skv
// need not be multiples of the tile.  Head h reads KV head h / (H / KV).
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 32;     // query rows per block

// LANES threads per query row, BKV keys per shared-memory tile.
template <typename T, int D, int LANES, int BKV>
__global__ void __launch_bounds__(BQ * LANES)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int KV,
             int Sq, int Skv, float scale, int causal, int window) {
  constexpr int DP = D / LANES;
  constexpr int THREADS = BQ * LANES;
  __shared__ float ks[BKV][D];
  __shared__ float vs[BKV][D];
  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KV);
  const int qpos = blockIdx.x * BQ + row;
  const size_t q_off = ((size_t)bh * Sq + qpos) * D;
  const size_t kv_base = ((size_t)b * KV + kvh) * Skv * D;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = qpos < Sq ? to_f32(q[q_off + lane + LANES * i]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;

  for (int k0 = 0; k0 < Skv; k0 += BKV) {
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < Skv;
      const size_t g = kv_base + (size_t)(k0 + r) * D + c;
      ks[r][c] = ok ? to_f32(k[g]) : 0.0f;
      vs[r][c] = ok ? to_f32(v[g]) : 0.0f;
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
    for (int i = 0; i < DP; ++i) o[q_off + lane + LANES * i] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int D, int LANES = 4, int BKV = 32>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int H, int KV, int Sq, int Skv, float scale, int causal,
            int window, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T, D, LANES, BKV><<<grid, BQ * LANES, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Skv, scale,
      causal, window);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int Sq, int Skv, int D, float scale, int causal,
             int window, cudaStream_t s) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, scale, causal, window, s); break;
    case 32: launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, scale, causal, window, s); break;
    case 64: launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, scale, causal, window, s); break;
    case 128: launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, scale, causal, window, s); break;
    case 256: launch<T, 256, 8, 16>(q, k, v, o, B, H, KV, Sq, Skv, scale, causal, window, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,Sq,D), k and v (B,KV,Skv,D), o (B,H,Sq,D), all contiguous of
// dtype (fp32 or bf16); D in {16, 32, 64, 128, 256}; H a multiple of KV.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KV, int Sq, int Skv,
                               int D, float scale, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch<float>(q, k, v, o, B, H, KV, Sq, Skv, D, scale, causal, window, s);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, D, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
