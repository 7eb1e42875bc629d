// K2: global rel-pos attention of the SAM ViT encoder over the whole
// kh x kw token grid, read straight from the fused qkv projection
// (bfloat16).
//
// Replaces: sam_pt_tpu/ops/flash_attention.py:219 fused_qkv_relpos_attention
// (Pallas kernel _qkv_relpos_kernel :186).
//
// Computes, per frame b and head h (N = kh*kw tokens, D = head dim):
//   logit[q, k] = round_bf16(q * scale) . k
//                 + (bias[q, h, y_k] + bias[q, h, kh + x_k])
//   p[q, k]     = round_bf16(softmax_k(logit[q, :]))  (normalised first)
//   out[q]      = round_bf16(p[q, :] . v)   (f32 accumulation)
// with qkv [B, N, 3*H*D] laid out (3, H, D) along its last axis and the
// factored bias [B, N, H, kh + kw] precomputed by two einsums outside the
// kernel and rounded to bf16. The head dim stays native (80 at ViT-H): the
// JAX package padded it to 128 for the TPU's lanes; nothing here needs it.
//
// What bounds it on the H100: at ViT-H (N = 4096, D = 80, H = 16, 4 frames
// per chunk) the two products are 344 GFLOP, 0.347 ms at the dense bf16
// rate, against 0.23 GB moved (0.07 ms): operations bound it, and
// only wgmma reaches the tensor cores' full rate. The naive composition
// would also write and read [B, H, 4096, 4096] f32 logits (4.3 GB) through
// device memory. The exact softmax costs more than that bound: p is
// normalised before it is rounded to bf16, as in the TPU kernel, so the
// row's max and sum must be known before any p . v, which takes a second
// pass over the keys: q.k^T twice is 1.5x the tensor work (515 GFLOP,
// 0.52 ms), and an exponential per logit in each pass is 2.15e9 ex2 on the
// SFU (16 a clock per SM, about 0.55 ms); at best the two overlap. Design
// (the flash body, `relpos_flash_kernel` in relpos_kernels.cu, shared with
// K4): one block per (192 query rows, head, frame), 1 per SM: a producer
// warpgroup streams 64-key tiles of k (pass 1), then of k and v (pass 2),
// by TMA straight from the fused qkv (a 4D map (D, 3H, N, B); no copy of
// k or v is made) into a ring of 8 stages, while three consumer
// warpgroups of 64 rows each run wgmma on the tiles that have arrived,
// with Q, S, P and O in registers: q.k^T (5 k-steps at D = 80) and p.v
// both take their A operand from registers, so only k and v are read from
// shared memory, and p = rnd(2^(z - m - log2 l)) is formed where S is.
// Above D = 80 three warpgroups' registers do not hold that without
// spills, so a block has two (128 rows). At N = 64 x 64 a tile is one
// grid row, so the bias is one bias_w register and one bias_h value per
// row and tile; other grids gather both from the block's staged bias
// rows. The warpgroups' products and softmax overlap one another, in
// part. What bounds it as built (measured, PERF.md): the TMA copies (each
// block streams k twice and v once), then the two products, then the
// softmax.

#include "relpos_kernels.cuh"

// qkv [b, kh*kw, 3*heads*d] (16-byte aligned), bias [b, kh*kw, heads,
// kh+kw], out [b, kh*kw, heads*d], all contiguous bfloat16; d a multiple
// of 16, at most 128; b and heads at most 65535 (grid dimensions). Returns
// a cudaError_t.
extern "C" int sam_global_attention(const void* qkv, const void* bias,
                                    void* out, int b, int kh, int kw,
                                    int heads, int d, float scale,
                                    void* stream) {
  if (d % 16 != 0 || d > 128 || kw < 2 || b > 65535 || heads > 65535 ||
      !sampt::aligned16(qkv) ||
      sampt::FlashLayout(d, kh + kw).stages < 2)
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf16;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bs = static_cast<const bf16*>(bias);
  const long n = (long)kh * kw, row = 3L * heads * d;
  const long brow = (long)heads * (kh + kw);
  sampt::RelposArgs a = {};  // k and v are read through TMA maps
  a.q = q;
  a.x_b = n * row, a.x_h = d, a.x_r = row;
  a.bias_h = bs;
  a.bias_w = bs + kh;
  a.bh_b = a.bw_b = n * brow;
  a.bh_h = a.bw_h = kh + kw;
  a.bh_r = a.bw_r = brow;
  a.out = static_cast<bf16*>(out);
  a.o_b = n * heads * d, a.o_h = d, a.o_r = (long)heads * d;
  a.kh = kh, a.kw = kw, a.d = d;
  a.scale = scale;
  // k and v of head h are heads heads + h and 2 heads + h of the (3
  // heads) axis of qkv.
  const sampt::FlashOperand kv[2] = {
      {qkv, 3 * heads, heads, d, row, n * row},
      {qkv, 3 * heads, 2 * heads, d, row, n * row}};
  return sampt::launch_relpos_flash(a, kv, heads, b,
                                    static_cast<cudaStream_t>(stream));
}

// Blocks of the flash body resident on one SM for a kh x kw grid at head
// dim d, or minus a cudaError_t.
extern "C" int sam_flash_blocks_per_sm(int kh, int kw, int d) {
  return sampt::relpos_flash_blocks_per_sm(kh, kw, d);
}
