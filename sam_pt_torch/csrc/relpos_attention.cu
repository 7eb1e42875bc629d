// K4: rel-pos attention on split q, k, v with the factored bias given as
// two per-row tables (bfloat16).
//
// Replaces: sam_pt_tpu/ops/flash_attention.py:87 fused_relpos_attention
// (Pallas kernels _attention_kernel :35 for N >= 1024 and
// _grouped_attention_kernel :56 below).
//
// Computes, per problem b (B = batch * heads; N = kh * kw tokens, D = head
// dim; key j at (y_j, x_j) = (j / kw, j % kw)):
//   logit[i, j] = round_bf16(q_i * scale) . k_j  (f32)
//                 + (bias_h[b, i, y_j] + bias_w[b, i, x_j])
//   p[i, j]     = round_bf16(softmax_j(logit[i, :]))  (normalised first)
//   out[i]      = round_bf16(p[i, :] . v)   (f32 accumulation)
// with q, k, v [B, N, D] and bias_h [B, N, kh], bias_w [B, N, kw] already
// rounded to bf16 (two einsums outside the kernel, as the JAX package
// computes them). The TPU kernel padded D to 128 lanes and added the bias
// through a one-hot augmentation of q and k (one matmul of width
// D + kh + kw); here the native D is read (any multiple of 16 up to 128)
// and each logit adds its two bias values directly.
//
// What bounds it on the H100: at ViT-H global width (B = 4 frames x 16
// heads = 64, N = 4096, D = 80) the two products are 344 GFLOP per call,
// 0.347 ms at the dense bf16 rate, with [B, N, N] f32 logits (4.3 GB) if
// they were materialised; the exact softmax (p normalised before it is
// rounded) adds a second pass of q.k^T (515 GFLOP in all) and an ex2 per
// logit a pass (2.15e9). Over ViT-H windows (B = 1600, N = 196) it is 19.7
// GFLOP on 218 MB, bound by the bytes. Design: the two regimes of the TPU
// function, on the two bodies K1 and K2 use (relpos_kernels.cu), over
// strided operands:
//   - N <= 208 and kh + kw < 32: the window body (see window_attention.cu),
//     one block per problem with its logits, probabilities and output in
//     registers. 208 keys (13 x 8 f32 a thread) is what a warp's 16-row
//     tile of logits can hold in registers, and 31 columns what the bias
//     block of its logits product carries beside the mask column; the TPU
//     function's boundary was N = 1024.
//   - otherwise: the flash body (see global_attention.cu): wgmma on
//     64-key tiles that TMA brings from k and v (each mapped as a 4D
//     tensor with one head), two passes over the keys for the exact
//     softmax, the bias rows staged in shared memory (at kw = 64 bias_w in
//     registers).
// Both regimes normalise p before rounding it to bf16, as the TPU kernels
// do.
// Ragged q- and k-tiles are masked in the kernel (the TPU function asserts
// N % q_tile == 0); the TPU's choice of windows per grid step is a VMEM
// size choice with no counterpart here.

#include "relpos_kernels.cuh"

// q, k, v, out [b, n, d]; bias_h [b, n, kh]; bias_w [b, n, kw]; all
// contiguous bfloat16, q/k/v 16-byte aligned; n == kh * kw; d a multiple of
// 16, at most 128; b at most 65535 (one grid dimension). Returns a
// cudaError_t.
extern "C" int sam_relpos_attention(const void* q, const void* k,
                                    const void* v, const void* bias_h,
                                    const void* bias_w, void* out, int b,
                                    int kh, int kw, int d, float scale,
                                    void* stream) {
  const int n = kh * kw;
  if (n < 1 || b < 1 || b > 65535 || d % 16 != 0 || d > 128 ||
      !sampt::aligned16(q) || !sampt::aligned16(k) || !sampt::aligned16(v))
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf16;
  sampt::RelposArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.x_b = (long)n * d, a.x_h = 0, a.x_r = d;
  a.bias_h = static_cast<const bf16*>(bias_h);
  a.bias_w = static_cast<const bf16*>(bias_w);
  a.bh_b = (long)n * kh, a.bh_h = 0, a.bh_r = kh;
  a.bw_b = (long)n * kw, a.bw_h = 0, a.bw_r = kw;
  a.out = static_cast<bf16*>(out);
  a.o_b = (long)n * d, a.o_h = 0, a.o_r = d;
  a.kh = kh, a.kw = kw, a.d = d;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= sampt::kWindowMaxN && kh + kw < sampt::kWindowBiasCols)
    return sampt::launch_relpos_window(a, 1, b, s);
  if (sampt::FlashLayout(d, kh + kw).stages < 2)
    return (int)cudaErrorInvalidValue;
  const long nd = (long)n * d;
  const sampt::FlashOperand kv[2] = {{k, 1, 0, d, d, nd},
                                     {v, 1, 0, d, d, nd}};
  return sampt::launch_relpos_flash(a, kv, 1, b, s);
}
