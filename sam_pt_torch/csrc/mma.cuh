// Warp-level tensor-core primitives shared by the port's attention kernels
// (both K3 kernels in cross_attention.cu, the window body in
// relpos_kernels.cu): inline PTX for ldmatrix and mma.sync m16n8k16 (bf16
// in, f32 accumulate), and the softmax helpers that work in log2 units.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = row g, cols 2t, 2t + 1; a1 = row g + 8,
//     the same cols; a2, a3 = the same rows, cols 2t + 8, 2t + 9.
//   B (16 x 8, column-major): b0 = rows 2t, 2t + 1 of col g; b1 = rows
//     2t + 8, 2t + 9.
//   C (16 x 8): c0, c1 = row g, cols 2t, 2t + 1; c2, c3 = row g + 8.
// So the accumulators of two m16n8 products over 16 keys, packed to bf16
// pairs, are the A fragment of the next m16k16 product over those keys.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace sampt {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d = a (16 x 16, row-major) . b (16 x 8, column-major) + d, f32 sums.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Round two floats to bfloat16 precision with one packed conversion
// (cvt.rn.bf16x2.f32): half the conversions of two round_bf16 calls.
__device__ __forceinline__ void round_bf16_pair(float& lo, float& hi) {
  const uint32_t u = pack_bf16(lo, hi);
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// Merge the running (max, sum) (m2, l2) into (m, l), maxima in log2
// units; a side that saw no key carries (-inf, 0).
__device__ __forceinline__ void merge_stats(float& m, float& l, float m2,
                                            float l2) {
  const float m_new = fmaxf(m, m2);
  if (m_new == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * fast_exp2(m - m_new)) +
      (m2 == -INFINITY ? 0.f : l2 * fast_exp2(m2 - m_new));
  m = m_new;
}

}  // namespace sampt
