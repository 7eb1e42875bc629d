// The two rel-pos attention kernels shared by K1, K2 and K4, over strided
// bfloat16 operands: their arguments, shared-memory layouts and launchers.
// The kernels are in relpos_kernels.cu; see window_attention.cu,
// global_attention.cu and relpos_attention.cu for what each use replaces,
// what bounds it and why it is shaped so.
//
//   relpos_window_kernel: one block per (head, batch) problem holds the
//     whole q, k and v of a short sequence in shared memory and runs the
//     exact softmax (p normalised, then rounded to bf16). K1, and K4 below
//     1024 tokens.
//   relpos_flash_kernel: one block per (64-row q-tile, head, batch) walks
//     the keys in double-buffered tiles of 64 with an online softmax (p
//     rounded to bf16 before the division by the row sum). K2, and K4 from
//     1024 tokens.
//
// Both compute, per problem (N = kh * kw tokens, D = head dim, key j at
// (y_j, x_j) = (j / kw, j % kw)):
//   logit[i, j] = round_bf16(q_i * scale) . k_j  (f32)
//                 + (bias_h[i, y_j] + bias_w[i, x_j])
//   out[i]      = softmax_j(logit[i, :]) . v   (f32 accumulation, one
//                                               rounding at the output)
// Products run on the tensor cores as warp-level 16x16x16 bf16 WMMA tiles
// (mma.sync); tiles are loaded by 16-byte cp.async copies; ragged q- and
// k-tiles are zero-filled and masked.
#pragma once

#include "common.cuh"

namespace sampt {

// Row r of problem (b, h) of an operand starts at
//   base + b * batch + h * head + r * row      (elements).
// q, k and v share one set of strides; so does the output with its own.
struct RelposArgs {
  const __nv_bfloat16 *q, *k, *v;
  long x_b, x_h, x_r;
  const __nv_bfloat16 *bias_h, *bias_w;  // [.., kh] and [.., kw] per row
  long bh_b, bh_h, bh_r, bw_b, bw_h, bw_r;
  __nv_bfloat16* out;
  long o_b, o_h, o_r;
  int kh, kw, d;
  float scale;  // already rounded to bf16 by the caller
};

constexpr int kRelposWarps = 4;  // warps per block of both kernels

// ---------------------------------------------------------------------------
// Whole sequence per block
// ---------------------------------------------------------------------------

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
    total = warp + kRelposWarps * (s + p);
  }
};

// ---------------------------------------------------------------------------
// Flash: key tiles with an online softmax
// ---------------------------------------------------------------------------

constexpr int kFlashTQ = 16 * kRelposWarps;  // query rows per block
constexpr int kFlashTK = 64;                 // keys per tile
constexpr int kFlashLDS = kFlashTK + 4;      // f32 logits row stride
constexpr int kFlashLDP = kFlashTK + 8;      // bf16 P row stride (aliases logits)
static_assert(kFlashTQ == kFlashTK, "q and k/v tiles share one buffer size");

struct FlashLayout {
  int ldh, ldo;
  size_t q, kv, bias, warp, s, o, total;
  __host__ __device__ FlashLayout(int d, int nb) {
    ldh = d + 8;  // bf16 q/k/v row stride (a multiple of 8, 16-byte rows)
    ldo = d + 4;  // f32 output row stride
    q = 0;
    kv = align16(sizeof(__nv_bfloat16) * kFlashTQ * ldh);  // one k or v tile
    bias = q + kv + 4 * kv;  // q, then k0 v0 k1 v1
    warp = bias + align16(sizeof(__nv_bfloat16) * kFlashTQ * nb);
    s = align16(sizeof(float) * 16 * kFlashLDS);
    o = align16(sizeof(float) * 16 * ldo);
    total = warp + kRelposWarps * (s + o);
  }
};

// Launchers: set the dynamic shared-memory limit, launch on `stream`,
// return the launch's cudaError_t. Callers check shapes and alignment.
// Whole problem per block: grid (heads, batch), WindowLayout(n, d).total
// bytes of dynamic shared memory.
int launch_relpos_window(const RelposArgs& a, int heads, int batch,
                         cudaStream_t stream);
// Flash: grid (ceil(n / kFlashTQ), heads, batch), FlashLayout(d, kh +
// kw).total bytes of dynamic shared memory.
int launch_relpos_flash(const RelposArgs& a, int heads, int batch,
                        cudaStream_t stream);

}  // namespace sampt
