// Tensor-core operands shared by the kernels: the splits that carry fp32
// values through 10-bit (TF32) and 8-bit (bf16) mantissas as hi + lo pairs
// (systolic_matmul.cu's wgmma, ssd.cu's mma.sync), the warp-level mma.sync
// products ssd.cu runs, and the ldmatrix loads of A and B fragments stored
// k-row by k-row.
//
// Fragments of mma.sync (PTX ISA, "warp-level matrix fragments"), lane l,
// g = l / 4, t = l % 4:
//   m16n8k16 bf16: A reg r holds (row g + 8 (r % 2), k 2t + 8 (r / 2) and
//                  the next k); B reg r holds (k 2t + 8 r and the next, n g)
//   m16n8k8 tf32:  A reg r holds (row g + 8 (r % 2), k t + 4 (r / 2));
//                  B reg r holds (k t + 4 r, n g)
//   both:          C reg r holds (row g + 8 (r / 2), n 2t + r % 2)
// The lower k of a bf16 pair sits in the low 16 bits.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

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

// (v0, v1) as two bf16 pairs, hi rounded to nearest and lo = v - hi rounded
// again: 16 bits of mantissa together, ~2^-17 of each value.
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d (16 x 8, fp32) += a (16 x 16) . b (16 x 8), bf16 operands.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8, fp32) += a (16 x 8) . b (8 x 8), TF32 operands.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 A fragment (16 rows x k 16) of a tile stored k-row by k-row:
// `addr` is this lane's k row, k0 + lane % 8 + 8 (lane / 16), at column
// r0 + 8 ((lane / 8) % 2) (16-byte aligned).
__device__ __forceinline__ void ldsm_a_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// The bf16 B fragment (k 16 x n 8) of a tile stored k-row by k-row: `addr`
// is this lane's row, k0 + lane % 16, at column n0 (16-byte aligned).
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&b)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}
