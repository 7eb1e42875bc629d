// Shared helpers for the port's attention kernels (bfloat16 inputs, float32
// arithmetic). Conversions go through the CUDA intrinsics only;
// __float2bfloat16 rounds to nearest even, as XLA and PyTorch do when they
// cast to bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace sampt {

// Dynamic shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSharedBytes = 232448;

// Round a float to bfloat16 precision and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// 16-byte asynchronous copy global -> shared (sm_80+); `valid` false
// writes 16 zero bytes instead (src-size 0: nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace sampt
