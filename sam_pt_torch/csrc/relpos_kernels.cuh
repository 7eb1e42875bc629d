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
//   relpos_flash_kernel (the flash body): one block per (192 query rows,
//     head, batch; 128 above d = 80): three (two) consumer warpgroups of
//     64 rows and a producer
//     warpgroup whose one thread keeps TMA copies of 64-key k/v tiles in
//     flight through a ring of up to 8 stages (full/empty mbarriers). Two
//     passes over the keys give the exact softmax: pass 1 streams k and
//     keeps each row's max and sum, pass 2 streams k and v and forms p
//     normalised, then rounded to bf16, in registers as the A operand of
//     P . V. Both
//     products are wgmma with the A operand in registers (q.k^T m64n64k16,
//     p.v m64nDk16); Q, S, P and O stay in registers. K2, and K4
//     otherwise.
//
// Both compute, per problem (N = kh * kw tokens, D = head dim, key j at
// (y_j, x_j) = (j / kw, j % kw)):
//   logit[i, j] = round_bf16(q_i * scale) . k_j  (f32)
//                 + (bias_h[i, y_j] + bias_w[i, x_j])
//   p[i, j]     = round_bf16(softmax_j(logit[i, :]))  (normalised, then
//                                                      rounded)
//   out[i]      = round_bf16(p[i, :] . v)   (f32 accumulation)
// Both products run on the tensor cores (bf16 in, f32 sums); rows past N
// are masked.
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
// Flash body: two passes over TMA-fed key tiles, wgmma
// ---------------------------------------------------------------------------

constexpr int kFlashKeys = 64;    // keys a tile
constexpr int kFlashMaxStages = 8;  // k/v tiles in flight, at most
constexpr int kFlashProducerRegs = 24;  // registers a producer thread

// Consumer warpgroups of 64 query rows a block at head dim d: three while
// their share of the SM's registers (160 a thread) holds q, S, P and O
// without spills; two above (240).
__host__ __device__ constexpr int flash_consumers(int d) {
  return d <= 80 ? 3 : 2;
}
__host__ __device__ constexpr int flash_rows(int d) {  // query rows a block
  return 64 * flash_consumers(d);
}
__host__ __device__ constexpr int flash_threads(int d) {  // + the producer
  return 128 * (flash_consumers(d) + 1);
}

// Where k or v lies, for its TMA map: a 4D tensor of bf16 (d, heads,
// rows, batch), innermost first; strides in elements; the block of head h
// reads head `head0 + h`.
struct FlashOperand {
  const void* base;
  int heads, head0;
  long head, row, batch;
};

// Shared memory, from a 1024-byte aligned base: the ring of stages (a k
// tile, then a v tile, of 64 rows each; a tile is boxes of 64 columns by
// 64 rows, 8 KB each, 128-byte swizzled, up to the last multiple of 64
// columns, then boxes of 16 columns, 2 KB each, 32-byte swizzled), the
// block's bias rows [flash_rows(d), kh + kw], the barriers. As many stages
// as fit, up to 8 (8 at ViT-H's 64 x 64 x 80); fewer than 2 do not run.
struct FlashLayout {
  int stages;
  size_t bias, bars, total;
  __host__ __device__ FlashLayout(int d, int nb) {
    const size_t tile = sizeof(__nv_bfloat16) * kFlashKeys * d;
    const size_t rows =
        align16(sizeof(__nv_bfloat16) * flash_rows(d) * nb);
    const size_t fixed =
        rows + sizeof(unsigned long long) * 2 * kFlashMaxStages + 1024;
    const size_t room =
        kMaxSharedBytes > fixed ? (kMaxSharedBytes - fixed) / (2 * tile) : 0;
    stages = room < kFlashMaxStages ? (int)room : kFlashMaxStages;
    bias = 2 * tile * stages;
    bars = bias + rows;
    total = bars + sizeof(unsigned long long) * 2 * stages +
            1024;  // room to align the base
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
// Flash: grid (ceil(n / flash_rows(d)), heads, batch), FlashLayout(d, kh +
// kw).total bytes of dynamic shared memory; q is read through
// RelposArgs' q and strides, k and v through TMA maps of `kv` (built
// here, on every call). Returns cudaErrorInvalidValue if a map cannot be
// built.
int launch_relpos_flash(const RelposArgs& a, const FlashOperand (&kv)[2],
                        int heads, int batch, cudaStream_t stream);
// Blocks of the flash body resident on one SM at (kh, kw, d), as for the
// window body.
int relpos_flash_blocks_per_sm(int kh, int kw, int d);

}  // namespace sampt
