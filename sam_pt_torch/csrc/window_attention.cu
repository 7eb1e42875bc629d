// K1: windowed rel-pos attention of the SAM ViT encoder, read straight
// from the fused qkv projection (bfloat16).
//
// Replaces: sam_pt_tpu/ops/flash_attention.py:542 fused_qkv_window_attention
// (Pallas kernels _qkv_window_kernel_batched :493 and _qkv_window_kernel
// :447).
//
// Computes, per window w and head h (N = win*win tokens, D = head dim):
//   qs     = round_bf16(q * scale)                 (scale already in bf16)
//   logit  = qs . k  (f32)  + (bias[q, h, y_k] + bias[q, h, win + x_k])
//   p      = round_bf16(softmax_f32(logit))        (normalised, then rounded)
//   out    = round_bf16(p . v)                     (f32 accumulation)
// with qkv [BW, N, 3*H*D] laid out (3, H, D) along its last axis and the
// decomposed rel-pos bias [BW, N, H, 2*win] precomputed by two einsums
// outside the kernel (rounded to bf16 there, as the JAX package does). The
// TPU kernel added that bias through a one-hot matmul, a lane trick; here
// each logit adds its two bias values directly.
//
// What bounds it on the H100: at ViT-H (N = 196, D = 80, H = 16, 100
// windows per 4-frame chunk) it is about 20 GFLOP per layer on 60 MB of
// qkv: compute-bound on the FP32 pipes, close to the memory traffic of
// reading qkv once when the products run on the tensor cores; and, as
// measured, bound by load latency when tiles are loaded element by
// element. Design: one block per (head, window) keeps that head's q, k and
// v (zero-padded 196 -> 208 rows, 110 KB) in dynamic shared memory, loaded
// by 16-byte cp.async copies that are all in flight at once, so logits
// never reach device memory. Each of the 4 warps takes 16-row tiles of
// queries in turn: the 16 x 208 logits block comes from warp-level
// 16x16x16 bf16 WMMA tiles (mma.sync) into a per-warp f32 slab, two lanes
// per row add the bias and run the exact softmax over the whole row (so p
// is normalised before it is rounded, like the TPU kernel's), and P . V
// comes from WMMA tiles again. About 190 KB of shared memory: one block
// per SM. Later: wgmma, several windows per block.

#include <mma.h>

#include "common.cuh"

namespace sampt {

constexpr int K1_WARPS = 4;

struct WindowLayout {
  int np, ldh, lds, ldp;
  size_t tile, warp, s, p, total;
  __host__ __device__ WindowLayout(int n, int d) {
    np = (n + 15) / 16 * 16;
    ldh = d + 8;   // bf16 q/k/v row stride (multiple of 8)
    lds = np + 4;  // f32 logits / output row stride (multiple of 4)
    ldp = np + 8;  // bf16 P row stride (multiple of 8)
    tile = align16(sizeof(__nv_bfloat16) * np * ldh);
    warp = 3 * tile;
    s = align16(sizeof(float) * 16 * (lds > d + 4 ? lds : d + 4));
    p = align16(sizeof(__nv_bfloat16) * 16 * ldp);
    total = warp + K1_WARPS * (s + p);
  }
};

__global__ void __launch_bounds__(K1_WARPS * 32)
window_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int n, int win,
                        int heads, int d, float scale) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int w = blockIdx.y;
  const WindowLayout L(n, d);
  const int np = L.np, ldh = L.ldh, lds = L.lds, ldp = L.ldp;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.tile);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * L.tile);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sw = reinterpret_cast<float*>(smem + L.warp + warp * (L.s + L.p));
  bf16* pw = reinterpret_cast<bf16*>(smem + L.warp + warp * (L.s + L.p) + L.s);

  const long row = 3L * heads * d;
  const bf16* base = qkv + (long)w * n * row + (long)h * d;
  const bf16 zero = __float2bfloat16(0.f);
  // q, k and v rows by 16-byte asynchronous copies (zeros past n), then
  // each thread scales and rounds the q chunks it copied itself.
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < np * chunks; i += blockDim.x) {
    const int t = i / chunks, c = (i - t * chunks) * 8;
    const bf16* src = base + (long)(t < n ? t : 0) * row + c;
    cp_async16(qs + t * ldh + c, src, t < n);
    cp_async16(ks + t * ldh + c, src + (long)heads * d, t < n);
    cp_async16(vs + t * ldh + c, src + 2L * heads * d, t < n);
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int i = threadIdx.x; i < np * chunks; i += blockDim.x) {
    const int t = i / chunks, c = (i - t * chunks) * 8;
    uint4* chunk = reinterpret_cast<uint4*>(qs + t * ldh + c);
    uint4 raw = *chunk;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    *chunk = raw;
  }
  __syncthreads();

  const int r = lane >> 1;  // two lanes per query row of the 16-row tile
  const int half = lane & 1;
  for (int rt = warp; rt < np / 16; rt += K1_WARPS) {
    for (int j = 0; j < np / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, qs + rt * 16 * ldh + kk, ldh);
        wmma::load_matrix_sync(bm, ks + j * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, lds, wmma::mem_row_major);
    }
    __syncwarp();

    const int q = rt * 16 + r;
    float* srow = sw + r * lds;
    const bf16* bq = bias + (((long)w * n + (q < n ? q : 0)) * heads + h) *
                                2 * win;
    float mx = -INFINITY;
    for (int c = half; c < n; c += 2) {
      const int yk = c / win;
      const float v = srow[c] + (__bfloat162float(bq[yk]) +
                                 __bfloat162float(bq[win + c - yk * win]));
      srow[c] = v;
      mx = fmaxf(mx, v);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float sum = 0.f;
    for (int c = half; c < n; c += 2) {
      const float e = expf(srow[c] - mx);
      srow[c] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    bf16* prow = pw + r * ldp;
    for (int c = half; c < np; c += 2)
      prow[c] = c < n ? __float2bfloat16(srow[c] / sum) : zero;
    __syncwarp();

    for (int t = 0; t < d; t += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < np; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, pw + kk, ldp);
        wmma::load_matrix_sync(bm, vs + kk * ldh + t, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(sw + t, acc, lds, wmma::mem_row_major);
    }
    __syncwarp();
    if (q < n) {
      bf16* o = out + ((long)w * n + q) * heads * d + (long)h * d;
      for (int c = half; c < d; c += 2) o[c] = __float2bfloat16(srow[c]);
    }
    __syncwarp();
  }
}

static int launch_window(const void* qkv, const void* bias, void* out,
                         int bw, int n, int win, int heads, int d,
                         float scale, cudaStream_t stream) {
  const WindowLayout L(n, d);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, bw);
  window_attention_kernel<<<grid, K1_WARPS * 32, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), n, win, heads, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace sampt

// qkv [bw, n, 3*heads*d] (16-byte aligned), bias [bw, n, heads, 2*win],
// out [bw, n, heads*d], all contiguous bfloat16; d a multiple of 16, at
// most 128. Returns a cudaError_t.
extern "C" int sam_window_attention(const void* qkv, const void* bias,
                                    void* out, int bw, int n, int win,
                                    int heads, int d, float scale,
                                    void* stream) {
  if (win * win != n || d % 16 != 0 || d > 128 || !sampt::aligned16(qkv) ||
      sampt::WindowLayout(n, d).total > sampt::kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  return sampt::launch_window(qkv, bias, out, bw, n, win, heads, d, scale,
                              static_cast<cudaStream_t>(stream));
}
