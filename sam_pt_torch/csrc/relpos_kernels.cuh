// The two rel-pos attention kernels shared by K1, K2 and K4, over strided
// bfloat16 operands: their arguments, shared-memory layouts and launchers.
// The kernels are in relpos_kernels.cu; see window_attention.cu,
// global_attention.cu and relpos_attention.cu for what each use replaces,
// what bounds it and why it is shaped so.
//
//   relpos_window_kernel (the window body): one block of 4 warps per
//     (head, batch) problem of at most 208 tokens holds its k and v in
//     shared memory; each warp keeps a 16-row query tile's logits,
//     probabilities and output in registers (mma.sync m16n8k16, the bias
//     added by the same product through a one-hot block) and runs the
//     exact softmax (p normalised, then rounded to bf16). Two blocks share
//     an SM. K1, and K4 up to 208 tokens with kh + kw < 32.
//   relpos_flash_kernel (the flash body): one block per (64-row q-tile,
//     head, batch) walks the keys in double-buffered tiles of 64 with an
//     online softmax (p rounded to bf16 before the division by the row
//     sum), on warp-level 16x16x16 WMMA tiles through per-warp f32 slabs.
//     K2, and K4 otherwise.
//
// Both compute, per problem (N = kh * kw tokens, D = head dim, key j at
// (y_j, x_j) = (j / kw, j % kw)):
//   logit[i, j] = round_bf16(q_i * scale) . k_j  (f32)
//                 + (bias_h[i, y_j] + bias_w[i, x_j])
//   out[i]      = softmax_j(logit[i, :]) . v   (f32 accumulation, one
//                                               rounding at the output)
// Both products run on the tensor cores (bf16 in, f32 sums); k and v
// arrive by 16-byte cp.async copies; rows past N are masked.
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

// ---------------------------------------------------------------------------
// Window body: the whole problem per block
// ---------------------------------------------------------------------------

constexpr int kWindowWarps = 4;  // each takes 16-row query tiles in turn
constexpr int kWindowTiles = 13;                // 16-key tiles a warp holds
constexpr int kWindowMaxN = 16 * kWindowTiles;  // tokens per problem
// Columns of the bias block the logits product carries: bias_h and bias_w
// (kh + kw < 32 of them), zeros, and the mask column last.
constexpr int kWindowBiasCols = 32;

// v (n rows), k (208 rows, zeros past n) and the one-hot block (208 rows
// of kWindowBiasCols): rows d + 8 and kWindowBiasCols + 8 bf16 apart, 16
// bytes on distinct bank quads for ldmatrix.
struct WindowLayout {
  size_t k, onehot, total;
  __host__ __device__ WindowLayout(int n, int d) {
    const size_t row = sizeof(__nv_bfloat16) * (d + 8);
    k = align16(row * n);
    onehot = k + row * kWindowMaxN;
    total = onehot +
            sizeof(__nv_bfloat16) * kWindowMaxN * (kWindowBiasCols + 8);
  }
};

// ---------------------------------------------------------------------------
// Flash body: key tiles with an online softmax
// ---------------------------------------------------------------------------

constexpr int kRelposWarps = 4;  // warps per block of the flash body

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
// Window body: grid (heads, batch), n = kh * kw <= kWindowMaxN,
// kh + kw < kWindowBiasCols, WindowLayout(n, d).total bytes of dynamic
// shared memory.
int launch_relpos_window(const RelposArgs& a, int heads, int batch,
                         cudaStream_t stream);
// Blocks of the window body resident on one SM at (kh, kw, d), as the
// occupancy calculator gives them with the launcher's attributes set, or
// minus a cudaError_t.
int relpos_window_blocks_per_sm(int kh, int kw, int d);
// Flash: grid (ceil(n / kFlashTQ), heads, batch), FlashLayout(d, kh +
// kw).total bytes of dynamic shared memory.
int launch_relpos_flash(const RelposArgs& a, int heads, int batch,
                        cudaStream_t stream);

}  // namespace sampt
