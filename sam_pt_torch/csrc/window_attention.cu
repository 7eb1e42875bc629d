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
// TPU kernel added that bias through a one-hot matmul; so does this one.
//
// What bounds it on the H100: at ViT-H (N = 196, D = 80, H = 16, 100
// windows per 4-frame chunk) it is 19.7 GFLOP on 218 MB (qkv, bias and
// output each moved once): 0.065 ms of memory traffic against 0.020 ms
// of tensor-core work, so bytes bound it, if the latency of the loads
// is hidden and the softmax costs few instructions a logit. Design (the
// window body, `relpos_window_kernel` in relpos_kernels.cu, shared with
// K4): one block of 4 warps per (head, window), 88 KB of shared memory
// at ViT-H (k, v and a one-hot block), two blocks per SM, so that one
// block's loads overlap the other's arithmetic. k arrives by
// 16-byte cp.async in one group and v in a second, so the first logits
// are formed while v is in flight. A warp takes a 16-row query tile
// against all keys on mma.sync m16n8k16 (ldmatrix from shared memory):
// its A fragments are q (scaled and rounded in registers) and the tile's
// bias rows, read straight from device memory a tile ahead; its B
// fragments are k and the one-hot block, which selects bias_h[y] and
// bias_w[x] for each key and sends keys past N to -3.4e38. So the bias
// costs 2 more k-steps on the tensor cores and no instruction per logit.
// The 16 x 208 logits stay in registers, the row max and sum close over
// the lane quad, and p = rnd(e * (1 / sum)) (normalised, then rounded, as
// in the TPU kernel) packs straight into the A fragments of P . V, whose
// output is rounded once at the store. Exponentials are ex2.approx in log2
// units; p is rounded to bf16 right after, which hides the difference. The
// logits take 104 registers a thread: blocks of 5 to 8 warps get at most
// 128 registers at two blocks per SM and spill, so a block has 4 warps,
// which may use up to 255. Not wgmma: its 64-row tiles would pad 196 rows
// to 256 and its shared-memory layouts do not suit 80-wide rows, while
// mma.sync already keeps the tensor work under the byte bound.

#include "relpos_kernels.cuh"

// qkv [bw, n, 3*heads*d] (16-byte aligned), bias [bw, n, heads, 2*win],
// out [bw, n, heads*d], all contiguous bfloat16; n at most 208; d a
// multiple of 16, at most 128. Returns a cudaError_t.
extern "C" int sam_window_attention(const void* qkv, const void* bias,
                                    void* out, int bw, int n, int win,
                                    int heads, int d, float scale,
                                    void* stream) {
  if (win * win != n || n > sampt::kWindowMaxN || d % 16 != 0 || d > 128 ||
      !sampt::aligned16(qkv))
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

// Blocks of the window body resident on one SM for problems of kh x kw
// tokens at head dim d, or minus a cudaError_t.
extern "C" int sam_window_blocks_per_sm(int kh, int kw, int d) {
  return sampt::relpos_window_blocks_per_sm(kh, kw, d);
}
