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
//   out[q]      = softmax_k(logit[q, :]) . v
// with qkv [B, N, 3*H*D] laid out (3, H, D) along its last axis and the
// factored bias [B, N, H, kh + kw] precomputed by two einsums outside the
// kernel and rounded to bf16. The head dim stays native (80 at ViT-H): the
// JAX package padded it to 128 for the TPU's lanes; nothing here needs it.
//
// What bounds it on the H100: at ViT-H (N = 4096, D = 80, H = 16, 4 frames
// per chunk) it is about 340 GFLOP per layer, compute-bound unless both
// products run on the tensor cores; the naive composition would also write
// and read [B, H, 4096, 4096] f32 logits (4.3 GB) through device memory.
// Measured: with element-by-element tile loads it was bound by load
// latency instead. Design: flash-style, one block per (64-row q-tile,
// head, frame). The block keeps its q rows and their bias rows in shared
// memory and walks the keys in tiles of 64, double-buffered: the next
// tile's k and v stream in by 16-byte cp.async copies while the current
// one is used. Per tile each of the 4 warps computes its 16 x 64 logits
// block with warp-level 16x16x16 bf16 WMMA tiles (mma.sync underneath),
// two lanes per row add the bias and run the online softmax (running max,
// running sum; p rounded to bf16 into a P tile that reuses the logits'
// memory, the row's f32 output accumulator rescaled in shared memory), and
// P . V is accumulated onto that output tile on the tensor cores. The
// accumulator lives in shared memory rather than in fragments because the
// per-row rescale needs each element's row. Rounding: p is rounded to bf16
// before p . v, as in the TPU kernel, but before the division by the row
// sum (which is only known at the end); the difference is within one bf16
// rounding of p. About 110 KB of shared memory: two blocks per SM. Logits
// never leave the SM. Later: wgmma with TMA-fed tiles and the accumulator
// in registers. The kernel body is `relpos_flash_kernel` in
// relpos_kernels.cu, shared with K4.

#include "relpos_kernels.cuh"

// qkv [b, kh*kw, 3*heads*d] (16-byte aligned), bias [b, kh*kw, heads,
// kh+kw], out [b, kh*kw, heads*d], all contiguous bfloat16; d a multiple
// of 16, at most 128. Returns a cudaError_t.
extern "C" int sam_global_attention(const void* qkv, const void* bias,
                                    void* out, int b, int kh, int kw,
                                    int heads, int d, float scale,
                                    void* stream) {
  if (d % 16 != 0 || d > 128 || kw < 2 || !sampt::aligned16(qkv) ||
      sampt::FlashLayout(d, kh + kw).total > sampt::kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf16;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bs = static_cast<const bf16*>(bias);
  const long n = (long)kh * kw, row = 3L * heads * d;
  const long brow = (long)heads * (kh + kw);
  sampt::RelposArgs a;
  a.q = q;
  a.k = q + (long)heads * d;
  a.v = q + 2L * heads * d;
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
  return sampt::launch_relpos_flash(a, heads, b,
                                    static_cast<cudaStream_t>(stream));
}
