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
// per SM. Later: wgmma, several windows per block. The kernel body is
// `relpos_window_kernel` in relpos_kernels.cu, shared with K4.

#include "relpos_kernels.cuh"

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
  typedef __nv_bfloat16 bf16;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* b = static_cast<const bf16*>(bias);
  const long row = 3L * heads * d, brow = 2L * heads * win;
  sampt::RelposArgs a;
  a.q = q;
  a.k = q + (long)heads * d;
  a.v = q + 2L * heads * d;
  a.x_b = n * row, a.x_h = d, a.x_r = row;
  a.bias_h = b;
  a.bias_w = b + win;
  a.bh_b = a.bw_b = n * brow;
  a.bh_h = a.bw_h = 2 * win;
  a.bh_r = a.bw_r = brow;
  a.out = static_cast<bf16*>(out);
  a.o_b = (long)n * heads * d, a.o_h = d, a.o_r = (long)heads * d;
  a.kh = a.kw = win;
  a.d = d;
  a.scale = scale;
  return sampt::launch_relpos_window(a, heads, bw,
                                     static_cast<cudaStream_t>(stream));
}
