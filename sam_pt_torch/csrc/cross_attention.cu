// K3: multi-head cross-attention of the SAM mask decoder between the prompt
// tokens and the 64 x 64 image tokens, on pre-projected q/k/v with the heads
// kept merged (bfloat16, head dim 16).
//
// Replaces: sam_pt_tpu/ops/flash_attention.py:381 fused_cross_attention
// (Pallas kernel _cross_attention_kernel :335).
//
// Computes, per pair b, head h and query row (head dim 16, as in SAM):
//   lg[j] = rnd(rnd(q . k_j) / divisor)              (f32 dot, rnd = bf16)
//   lg[j] = rnd(-1e9)  where kv_valid[b, j] == 0     (masked keys)
//   p[j]  = rnd(exp(lg[j] - max) / sum)              (softmax in f32)
//   out   = rnd(sum_j p[j] v_j)                      (f32 accumulation)
// which is the rounding sequence of the TPU kernel, step for step. A
// masked logit is finite, so a row whose keys are all masked gets a
// uniform p over its nk keys, as in the TPU kernel.
//
// What bounds it on the H100, at the main path's 48 pairs x 8 heads x
// 4096 image tokens x ~60 prompt and output tokens (94e6 logits a call):
//  - Bytes: q and the output dominate the ~102 MB a call moves, 0.0305 ms
//    of device memory. Nothing of size Nq x Nk is ever stored: the naive
//    composition writes the [B, H, Nq, Nk] probabilities (~380 MB in f32),
//    five times per decoder pass.
//  - Operations: 6 GFLOP, 0.006 ms of tensor-core time, once both
//    products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//    out; the head dim 16 is one k-step).
//  - What is left is per logit: one exp2 on the SFU (16 a clock per SM,
//    about 0.025 ms a call); two bf16 conversions, the logit's rounding
//    and p's packing (the same rate, about 0.05 ms one at a time); and
//    some ten plain instructions (the key mask, the max, the exponent's
//    fma, the sum, the normalising multiply), which at four warp
//    instructions a clock per SM take the largest share.
// What the design does about each: the probabilities stay in registers;
// logits are in log2 units, so exp(lg - max) is one ex2 (an fma inside
// it in image -> token); two values share one cvt.rn.bf16x2.f32 when p is
// packed, and in image -> token also when the logit is rounded, while
// the SAM divisor 4, a power of two, makes the second rounding exact
// (POW2); image -> token has no branch between its loads and its stores.
// The shape picks the layout:
//  - image -> token (4096 queries x ~60 keys, with the key mask): a block
//    per pair and run of 64-row tiles stages the pair's keys once for all
//    heads, and each warp walks on its own over items of 16 rows and one
//    head; all keys fit one 64-key tile, so each row's softmax is exact in
//    one pass with S and P in registers (below).
//  - token -> image (~60 queries x 4096 keys), and any call with more than
//    64 keys: a block per 64 query rows and head, two passes over the keys
//    in chunks of 128: the statistics first, then p.v (below).

#include "mma.cuh"

namespace sampt {

constexpr int K3_DH = 16;  // head dim

// ---------------------------------------------------------------------------
// Token -> image on the tensor cores
// ---------------------------------------------------------------------------
//
// Grid (ceil(nq / 64), heads, b); 8 warps a block: warp w owns the 16 query
// rows of row tile w % 4 and half w / 4 of every key chunk. The block
// streams the head's keys (and, in the second pass, values) through shared
// memory in chunks of 128 by 16-byte cp.async, double-buffered, so one
// staged chunk serves all 64 rows. Per 16 keys a warp runs two
// m16n8k16 products for S = Q K^T (q as the A fragment, loaded once; k by
// ldmatrix) and, in the second pass, packs the rounded p straight from the
// S accumulators into the A fragment of two more for P V (v by
// ldmatrix.trans): the accumulator layout of an m16n8 pair is the A layout
// of m16k16, so S and P never leave the registers. A lane holds rows g and
// g + 8 (g = lane / 4) and keys 2t, 2t + 1, 2t + 8, 2t + 9 (t = lane % 4)
// of each 16-key tile. Pass 1 keeps a per-lane (max, sum) per row,
// rescaled once per chunk; lanes, then the two key halves, merge them
// through shuffles and shared memory. The two halves' output tiles are
// summed through shared memory at the end. Rows past nq compute on zero q
// and are not written; keys past nk are -inf. With both matrix products
// on the tensor cores, what is left is per logit and pass: a rounding
// (the conversion pipe), a multiply, the max or the normalising multiply,
// and one exp2 (the SFU), in log2 units; the SAM divisor 4 makes the
// second rounding exact (POW2 below), which saves a conversion a logit.
constexpr int K3T_WARPS = 8;
constexpr int K3T_ROWS = 64;            // query rows per block
constexpr int K3T_KC = 128;             // keys per chunk, 64 per key half
constexpr int K3T_LD = 24;              // bf16 per staged row: 48 bytes, so
                                        // 8 rows hit 8 distinct bank quads

// S = Q K^T for the 16 keys from `krow0` (staged rows, K3T_LD apart): s0
// holds keys 2t, 2t + 1 and s1 keys 8 + 2t, 9 + 2t, each of rows g (0, 1)
// and g + 8 (2, 3).
__device__ __forceinline__ void qk_tile(const __nv_bfloat16* krow0,
                                        const uint32_t qa[4], int lane,
                                        float s0[4], float s1[4]) {
  // Matrices: keys 0-7 x dims 0-7, 0-7 x 8-15, 8-15 x 0-7, 8-15 x 8-15.
  uint32_t kb[4];
  ldmatrix_x4(kb, krow0 + ((lane & 7) + ((lane >> 4) << 3)) * K3T_LD +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) s0[i] = s1[i] = 0.f;
  mma_16816(s0, qa, kb[0], kb[1]);
  mma_16816(s1, qa, kb[2], kb[3]);
}

// POW2: `scale` is 1 / divisor and the divisor a power of two, so the
// multiply rounds as the division does, and a bf16 value times `scale` is
// a bf16 value: the second rounding is exact and skipped (below 2^-126,
// in bf16's subnormals, the two differ by less than 2^-133, which no
// softmax in f32 can see). Otherwise `scale` is the divisor.
// At most 85 registers a thread, so that 3 blocks share an SM and the main
// path's 384 blocks (48 pairs x 8 heads) run in one wave on 132 SMs.
template <bool MASKED, bool POW2>
__global__ void __launch_bounds__(K3T_WARPS * 32, 3)
cross_attention_t2i_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const unsigned char* __restrict__ kv_valid,
                           __nv_bfloat16* __restrict__ out, int nq, int nk,
                           int heads, float scale) {
  typedef __nv_bfloat16 bf16;
  __shared__ __align__(16) bf16 ks[2][K3T_KC * K3T_LD];
  __shared__ __align__(16) bf16 vs[2][K3T_KC * K3T_LD];
  __shared__ unsigned char valid[2][K3T_KC];
  __shared__ float stat_m[2][K3T_ROWS], stat_l[2][K3T_ROWS];
  __shared__ float osum[K3T_ROWS][K3_DH + 1];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rt = warp & 3;     // row tile
  const int half = warp >> 2;  // key half of every chunk
  const int g = lane >> 2, t = lane & 3;
  const int ch = heads * K3_DH;
  const int row_lo = blockIdx.x * K3T_ROWS + rt * 16 + g;  // and row_lo + 8
  // In log2 units: the masked logit, and 1 / divisor (a power of two
  // times log2 e: the product rounds as the two multiplies would).
  const float masked_log2 = round_bf16(-1e9f) * kLog2e;
  const float scale_log2 = scale * kLog2e;

  // q as the A fragment: rows g, g + 8; columns 2t, 2t + 1 (+ 8).
  uint32_t qa[4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + ((long)b * nq + row_lo) * ch + h * K3_DH);
    const uint32_t* q1 = q0 + 4 * ch;  // eight rows on, in 32-bit words
    const bool ok0 = row_lo < nq, ok1 = row_lo + 8 < nq;
    qa[0] = ok0 ? q0[t] : 0u;
    qa[1] = ok1 ? q1[t] : 0u;
    qa[2] = ok0 ? q0[t + 4] : 0u;
    qa[3] = ok1 ? q1[t + 4] : 0u;
  }

  const int nchunks = (nk + K3T_KC - 1) / K3T_KC;
  // Chunk `c` into buffer `buf`: a thread per (key, 16-byte half row),
  // zeros past nk.
  auto load_chunk = [&](int c, int buf, bool with_v) {
    const int r = threadIdx.x >> 1, part = (threadIdx.x & 1) * 8;
    const int key = c * K3T_KC + r;
    const bool ok = key < nk;
    const long src = ((long)b * nk + (ok ? key : 0)) * ch + h * K3_DH + part;
    cp_async16(ks[buf] + r * K3T_LD + part, k + src, ok);
    if (with_v) cp_async16(vs[buf] + r * K3T_LD + part, v + src, ok);
    cp_async_commit();
    if (MASKED && threadIdx.x < K3T_KC) {
      const int j = c * K3T_KC + threadIdx.x;
      valid[buf][threadIdx.x] = j < nk ? kv_valid[(long)b * nk + j] : 0;
    }
  };
  // The rounded, scaled logit of local key `j` of chunk `c`, in log2 units
  // (so that exp(lg - max) = exp2(x - max2) and equal logits stay equal).
  auto logit2 = [&](float s, int c, int buf, int j) {
    float x = POW2 ? round_bf16(s) * scale_log2
                   : round_bf16(__fdiv_rn(round_bf16(s), scale)) * kLog2e;
    if (MASKED && !valid[buf][j]) x = masked_log2;
    return c * K3T_KC + j < nk ? x : -INFINITY;
  };
  // Wait for chunk c (issuing chunk c + 1 first), then a block barrier.
  auto next_chunk = [&](int c, bool with_v) {
    if (c + 1 < nchunks) {
      load_chunk(c + 1, (c + 1) & 1, with_v);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  // Pass 1: per-lane running (max, sum) of rows g, g + 8 over its keys.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  load_chunk(0, 0, false);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    next_chunk(c, false);
    float lg[2][16];
#pragma unroll
    for (int tile = 0; tile < 4; ++tile) {
      const int kl = half * 64 + tile * 16;
      const int j = kl + 2 * t;
      float s0[4], s1[4];
      qk_tile(ks[buf] + kl * K3T_LD, qa, lane, s0, s1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lg[r][4 * tile + 0] = logit2(s0[2 * r], c, buf, j);
        lg[r][4 * tile + 1] = logit2(s0[2 * r + 1], c, buf, j + 1);
        lg[r][4 * tile + 2] = logit2(s1[2 * r], c, buf, j + 8);
        lg[r][4 * tile + 3] = logit2(s1[2 * r + 1], c, buf, j + 9);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cmax = lg[r][0];
#pragma unroll
      for (int i = 1; i < 16; ++i) cmax = fmaxf(cmax, lg[r][i]);
      const float m_new = fmaxf(m[r], cmax);
      if (m_new != -INFINITY) {  // -inf: only keys past nk so far
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += fast_exp2(lg[r][i] - m_new);
        l[r] = l[r] * fast_exp2(m[r] - m_new) + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();  // buffer `buf` is reloaded at the next iteration
  }

  // Merge the four lanes of each row, then the two key halves.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      merge_stats(m[r], l[r], m2, l2);
    }
    if (t == 0) {
      stat_m[half][rt * 16 + g + 8 * r] = m[r];
      stat_l[half][rt * 16 + g + 8 * r] = l[r];
    }
  }
  load_chunk(0, 0, true);  // pass 2's first chunk, under the merge
  __syncthreads();
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rt * 16 + g + 8 * r;
    m[r] = stat_m[0][row];
    l[r] = stat_l[0][row];
    merge_stats(m[r], l[r], stat_m[1][row], stat_l[1][row]);
    inv_l[r] = 1.f / l[r];
  }

  // Pass 2: p = rnd(exp(lg - max) / sum) as the A fragment of P V.
  float o0[4] = {0.f, 0.f, 0.f, 0.f};  // dims 2t, 2t + 1 (rows g, g + 8)
  float o1[4] = {0.f, 0.f, 0.f, 0.f};  // dims 8 + 2t, 9 + 2t
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    next_chunk(c, true);
#pragma unroll
    for (int tile = 0; tile < 4; ++tile) {
      const int kl = half * 64 + tile * 16;
      const int j = kl + 2 * t;
      float s0[4], s1[4];
      qk_tile(ks[buf] + kl * K3T_LD, qa, lane, s0, s1);
      auto p = [&](float s, int r, int jj) {
        return fast_exp2(logit2(s, c, buf, jj) - m[r]) * inv_l[r];
      };
      uint32_t pa[4];
      pa[0] = pack_bf16(p(s0[0], 0, j), p(s0[1], 0, j + 1));
      pa[1] = pack_bf16(p(s0[2], 1, j), p(s0[3], 1, j + 1));
      pa[2] = pack_bf16(p(s1[0], 0, j + 8), p(s1[1], 0, j + 9));
      pa[3] = pack_bf16(p(s1[2], 1, j + 8), p(s1[3], 1, j + 9));
      // Matrices: keys 0-7 x dims 0-7, 8-15 x 0-7, 0-7 x 8-15, 8-15 x 8-15.
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs[buf] +
                                (kl + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                    K3T_LD +
                                ((lane >> 4) << 3));
      mma_16816(o0, pa, vb[0], vb[1]);
      mma_16816(o1, pa, vb[2], vb[3]);
    }
    __syncthreads();
  }

  // Sum the two key halves' tiles; half 0 rounds and stores.
  const int r0 = rt * 16 + g;
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      osum[r0 + 8 * r][2 * t] = o0[2 * r];
      osum[r0 + 8 * r][2 * t + 1] = o0[2 * r + 1];
      osum[r0 + 8 * r][8 + 2 * t] = o1[2 * r];
      osum[r0 + 8 * r][9 + 2 * t] = o1[2 * r + 1];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row >= nq) continue;
      const float* os = osum[r0 + 8 * r];
      uint32_t* o = reinterpret_cast<uint32_t*>(
          out + ((long)b * nq + row) * ch + h * K3_DH);
      o[t] = pack_bf16(o0[2 * r] + os[2 * t], o0[2 * r + 1] + os[2 * t + 1]);
      o[t + 4] = pack_bf16(o1[2 * r] + os[8 + 2 * t],
                           o1[2 * r + 1] + os[9 + 2 * t]);
    }
  }
}

// ---------------------------------------------------------------------------
// Image -> token on the tensor cores
// ---------------------------------------------------------------------------
//
// Grid (ceil(q_tiles / tiles_per_block), b), with q tiles of 64 image rows;
// 8 warps a block. A block stages its pair's keys and values once for all
// heads, by 16-byte cp.async into rows padded by 16 bytes (so that 8 rows
// read by ldmatrix hit 8 distinct bank quads): 34 KB at 8 heads. Then
// each warp walks on its own, with no barrier, over the work items of the
// block's `tiles_per_block` q tiles (chosen by the host so that the grid
// fills the card in one wave): an item is one head of 16 query rows, and
// warp w takes items w, w + 8, ... (head w of every 16 rows at 8 heads).
// Per item, q comes from device memory straight into the A fragment (the
// next item's while this one is computed), and S = Q K^T over the 64
// staged keys is 8 m16n8k16 products (k by ldmatrix, as in qk_tile), 32
// f32 registers a lane: a lane holds rows g and g + 8 (g = lane / 4) and
// keys 8j + 2t, 8j + 2t + 1 (t = lane % 4) of n8 tile j. The row's max and
// sum come from the lane's 16 values (pairwise) and two shuffles over the
// row's 4 lanes; p = rnd(2^(x - m) * (1 / l)) is packed straight into the
// A fragments of P V (4 k-steps x 2 n8 tiles, v by ldmatrix.trans), and
// the rounded output goes from the accumulators to device memory. The
// code between the loads and the stores has no branch, so the compiler
// can overlap one k-step's products with the next one's conversions.
// Keys are kept or dropped (-inf) by a bit mask of the staged keys: a
// masked key's exp underflows to 0 as exp(rnd(-1e9) - max) does, and a
// pair with no valid key, whose masked logits are all one finite value,
// gets zero q instead, so that every key it has gets the same p. The
// logits stay rounded but unscaled (the scale is positive, so the max is
// the same key's): x - m is one fma inside the exp2. Rows past nq read zero
// q and are not stored; keys past nk are zero rows, dropped. It takes at
// most 64 keys (the main path has ~60); the entry sends more to the token
// -> image kernel, whose two passes take any nk.
constexpr int K3I_WARPS = 8;
constexpr int K3I_ROWS = 64;  // query rows per q tile, the grid's unit
constexpr int K3I_KEYS = 64;  // the most keys it takes, all staged
constexpr int K3I_BLOCKS_PER_SM = 4;

// Staged row stride in bf16 for `ch` channels: an odd number of 16-byte
// quads (ch is a multiple of 16).
__host__ __device__ __forceinline__ int k3i_ld(int ch) { return ch + 8; }

// The staged k and v.
inline size_t k3i_shared_bytes(int heads) {
  return size_t(2 * K3I_KEYS) * k3i_ld(heads * K3_DH) * sizeof(__nv_bfloat16);
}

// POW2 and `scale` as for the token -> image kernel. At most 64 registers
// a thread, so that 4 blocks share an SM.
template <bool MASKED, bool POW2>
__global__ void __launch_bounds__(K3I_WARPS * 32, K3I_BLOCKS_PER_SM)
cross_attention_i2t_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const unsigned char* __restrict__ kv_valid,
                           __nv_bfloat16* __restrict__ out, int nq, int nk,
                           int heads, float scale, int tiles_per_block) {
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(16) unsigned char k3i_smem[];
  const int ch = heads * K3_DH;
  const int ld = k3i_ld(ch);
  bf16* const ks = reinterpret_cast<bf16*>(k3i_smem);
  bf16* const vs = ks + K3I_KEYS * ld;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // The block's items: every head of each 16-row group from row0 on.
  const int row0 = blockIdx.x * tiles_per_block * K3I_ROWS;
  const int groups = (min(nq - row0, tiles_per_block * K3I_ROWS) + 15) / 16;
  // A logit x (log2 units) is r * unit, r its rounded, unscaled value.
  const float unit = POW2 ? scale * kLog2e : kLog2e;

  // The pair's k and v, zeros past nk.
  auto stage_keys = [&]() {
    const int quads = ch / 8;  // 16-byte pieces of a row
    for (int i = threadIdx.x; i < K3I_KEYS * quads; i += K3I_WARPS * 32) {
      const int r = i / quads, c = (i - r * quads) * 8;
      const bool ok = r < nk;
      const long src = ((long)b * nk + (ok ? r : 0)) * ch + c;
      cp_async16(ks + r * ld + c, k + src, ok);
      cp_async16(vs + r * ld + c, v + src, ok);
    }
    cp_async_commit();
  };
  // Whether pair b has no valid key.
  auto no_valid_key = [&]() {
    bool any = !MASKED;
    for (int key = lane; key < nk && !any; key += 32)
      any = kv_valid[(long)b * nk + key];
    return !__any_sync(0xffffffffu, any);
  };
  // Per lane, the keys to keep (those that exist and are valid, or, with
  // `none_valid`, that exist), shifted so that bit 8j + c of word j / 4 is
  // key 8j + 2t + c.
  auto key_bits = [&](bool none_valid, uint32_t keep[2]) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int key = 32 * w + lane;
      bool ok = key < nk;
      if (MASKED && !none_valid) ok = ok && kv_valid[(long)b * nk + key];
      keep[w] = __ballot_sync(0xffffffffu, ok) >> (2 * t);
    }
  };
  // Group `grp`'s q of head h as the A fragment: rows g, g + 8; columns
  // 2t, 2t + 1 (+ 8); zeros past nq and, with `none_valid`, everywhere.
  auto load_q = [&](int grp, int h, bool none_valid, uint32_t qa[4]) {
    const int row = row0 + grp * 16 + g;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + ((long)b * nq + row) * ch + h * K3_DH);
    const uint32_t* q1 = q0 + 4 * ch;  // eight rows on, in 32-bit words
    const bool ok0 = row < nq && !none_valid;
    const bool ok1 = row + 8 < nq && !none_valid;
    qa[0] = ok0 ? q0[t] : 0u;
    qa[1] = ok1 ? q1[t] : 0u;
    qa[2] = ok0 ? q0[t + 4] : 0u;
    qa[3] = ok1 ? q1[t + 4] : 0u;
  };
  // S = Q K^T against the staged keys, then the rounded logits r
  // (x = r * unit), -inf at the keys not kept.
  auto logits = [&](const uint32_t qa[4], int h, const uint32_t keep[2],
                    float s[8][4]) {
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      // Matrices: keys 0-7 x dims 0-7, 0-7 x 8-15, 8-15 x 0-7, 8-15 x 8-15.
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                          h * K3_DH + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[2 * kt][i] = s[2 * kt + 1][i] = 0.f;
      mma_16816(s[2 * kt], qa, kb[0], kb[1]);
      mma_16816(s[2 * kt + 1], qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& a = s[j][2 * r];
        float& c = s[j][2 * r + 1];
        round_bf16_pair(a, c);
        if (!POW2) {
          a = __fdiv_rn(a, scale);
          c = __fdiv_rn(c, scale);
          round_bf16_pair(a, c);
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool kept = (keep[j >> 2] >> (8 * (j & 3) + c)) & 1;
        s[j][c] = kept ? s[j][c] : -INFINITY;
        s[j][2 + c] = kept ? s[j][2 + c] : -INFINITY;
      }
    }
  };
  // The max of row r's 16 values in a lane, pairwise.
  auto row_max = [&](const float s[8][4], int r) {
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) a[j] = fmaxf(a[j], a[j + w]);
    return a[0];
  };
  // o += P V over the staged keys; p by k-step in pa[kt] (rows g,
  // g + 8 x keys 2t, 2t + 1, 8 + 2t, 9 + 2t).
  auto pv = [&](const uint32_t pa[4][4], int h, float o[2][4]) {
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      // Matrices: keys 0-7 x dims 0-7, 8-15 x 0-7, 0-7 x 8-15, 8-15 x 8-15.
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + (kt * 16 + (lane & 7) +
                                  (((lane >> 3) & 1) << 3)) * ld +
                                h * K3_DH + ((lane >> 4) << 3));
      mma_16816(o[0], pa[kt], vb[0], vb[1]);
      mma_16816(o[1], pa[kt], vb[2], vb[3]);
    }
  };
  // The rounded output of group `grp`, head h (o[0]: dims 2t, 2t + 1;
  // o[1]: 8 + 2t, 9 + 2t; rows g, g + 8).
  auto store_out = [&](int grp, int h, const float o[2][4]) {
    const int row = row0 + grp * 16 + g;
    uint32_t* o0 = reinterpret_cast<uint32_t*>(
        out + ((long)b * nq + row) * ch + h * K3_DH);
    uint32_t* o1 = o0 + 4 * ch;
    if (row < nq) {
      o0[t] = pack_bf16(o[0][0], o[0][1]);
      o0[t + 4] = pack_bf16(o[1][0], o[1][1]);
    }
    if (row + 8 < nq) {
      o1[t] = pack_bf16(o[0][2], o[0][3]);
      o1[t + 4] = pack_bf16(o[1][2], o[1][3]);
    }
  };

  const bool none_valid = MASKED && no_valid_key();
  stage_keys();
  uint32_t keep[2];
  key_bits(none_valid, keep);
  int grp = warp / heads, h = warp - grp * heads;  // the warp's first item
  uint32_t qn[4];
  if (grp < groups) load_q(grp, h, none_valid, qn);
  cp_async_wait<0>();
  __syncthreads();
  while (grp < groups) {
    const uint32_t qa[4] = {qn[0], qn[1], qn[2], qn[3]};
    const int cur_grp = grp, cur_h = h;
    for (h += K3I_WARPS; h >= heads; h -= heads) ++grp;  // 8 items on
    if (grp < groups) load_q(grp, h, none_valid, qn);
    float s[8][4];
    logits(qa, cur_h, keep, s);
    float m[2], inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = row_max(s, r);
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      m[r] *= unit;
    }
    // One exp2 a logit: e stays in s and is normalised as it is packed.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[j][i] = fast_exp2(fmaf(s[j][i], unit, -m[i >> 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = s[j][2 * r] + s[j][2 * r + 1];
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) a[j] += a[j + w];
      float l = a[0] + __shfl_xor_sync(0xffffffffu, a[0], 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv_l[r] = __fdividef(1.f, l);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* e = s[2 * kt + half];
        pa[kt][2 * half] = pack_bf16(e[0] * inv_l[0], e[1] * inv_l[0]);
        pa[kt][2 * half + 1] = pack_bf16(e[2] * inv_l[1], e[3] * inv_l[1]);
      }
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    pv(pa, cur_h, o);
    store_out(cur_grp, cur_h, o);
  }
}

typedef void (*I2tKernel)(const __nv_bfloat16*, const __nv_bfloat16*,
                          const __nv_bfloat16*, const unsigned char*,
                          __nv_bfloat16*, int, int, int, float, int);

static I2tKernel i2t_kernel(bool masked, bool pow2) {
  if (masked)
    return pow2 ? cross_attention_i2t_kernel<true, true>
                : cross_attention_i2t_kernel<true, false>;
  return pow2 ? cross_attention_i2t_kernel<false, true>
              : cross_attention_i2t_kernel<false, false>;
}

// Above 48 KB (from 12 heads) a block's shared memory must be asked for;
// the carveout leaves the SM's memory to shared memory. Set once for each
// instance and the largest size asked so far, not on every launch.
static int i2t_attributes(bool masked, bool pow2, size_t bytes) {
  static size_t set[4] = {0, 0, 0, 0};  // bytes allowed, per instance
  size_t& allowed = set[2 * masked + pow2];
  if (bytes <= allowed) return 0;
  if (bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const I2tKernel kernel = i2t_kernel(masked, pow2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) allowed = bytes;
  return (int)err;
}

int launch_i2t(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const unsigned char* kv_valid,
               __nv_bfloat16* out, int b, int nq, int nk, int heads,
               bool pow2, float scale, cudaStream_t s) {
  static int sms = 0;  // the card's SM count, asked once
  if (!sms) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return (int)err;
  }
  const I2tKernel kernel = i2t_kernel(kv_valid != nullptr, pow2);
  const size_t bytes = k3i_shared_bytes(heads);
  const int err = i2t_attributes(kv_valid != nullptr, pow2, bytes);
  if (err) return err;
  // As many q tiles a block as fill the card's blocks in one wave.
  const long q_tiles = (nq + K3I_ROWS - 1) / K3I_ROWS;
  const long slots = (long)sms * K3I_BLOCKS_PER_SM;
  const int per_block = (int)max(1L, (q_tiles * b + slots - 1) / slots);
  const dim3 grid((unsigned)((q_tiles + per_block - 1) / per_block), b);
  kernel<<<grid, K3I_WARPS * 32, bytes, s>>>(q, k, v, kv_valid, out, nq, nk,
                                             heads, scale, per_block);
  return (int)cudaGetLastError();
}

template <bool MASKED, bool POW2>
void launch_t2i(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const unsigned char* kv_valid,
                __nv_bfloat16* out, int b, int nq, int nk, int heads,
                float scale, cudaStream_t s) {
  const dim3 grid((nq + K3T_ROWS - 1) / K3T_ROWS, heads, b);
  cross_attention_t2i_kernel<MASKED, POW2><<<grid, K3T_WARPS * 32, 0, s>>>(
      q, k, v, kv_valid, out, nq, nk, heads, scale);
}

}  // namespace sampt

// q [b, nq, heads*16], k and v [b, nk, heads*16] (16-byte aligned),
// kv_valid [b, nk] uint8 or null, out [b, nq, heads*16], all contiguous
// bfloat16. Returns a cudaError_t.
extern "C" int sam_cross_attention(const void* q, const void* k,
                                   const void* v, const void* kv_valid,
                                   void* out, int b, int nq, int nk,
                                   int heads, float divisor, void* stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const unsigned char*>(kv_valid);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sampt::aligned16(q) || !sampt::aligned16(k) || !sampt::aligned16(v))
    return (int)cudaErrorInvalidValue;
  int exponent;
  const bool pow2 = frexpf(divisor, &exponent) == 0.5f;
  const float scale = pow2 ? 1.f / divisor : divisor;
  if (nk > nq || nk > sampt::K3I_KEYS) {  // a block per 64 query rows
    if (mp && pow2)
      sampt::launch_t2i<true, true>(qp, kp, vp, mp, op, b, nq, nk, heads,
                                    scale, s);
    else if (mp)
      sampt::launch_t2i<true, false>(qp, kp, vp, mp, op, b, nq, nk, heads,
                                     scale, s);
    else if (pow2)
      sampt::launch_t2i<false, true>(qp, kp, vp, mp, op, b, nq, nk, heads,
                                     scale, s);
    else
      sampt::launch_t2i<false, false>(qp, kp, vp, mp, op, b, nq, nk, heads,
                                      scale, s);
  } else {  // image -> token: the pair's keys staged once a block
    if (!sampt::aligned16(out)) return (int)cudaErrorInvalidValue;
    return sampt::launch_i2t(qp, kp, vp, mp, op, b, nq, nk, heads, pow2,
                             scale, s);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the image -> token kernel at `heads` heads of
// 16 (occupancy calculator), for the key-mask and power-of-two-divisor
// instance asked for; a negative cudaError_t if it cannot run.
extern "C" int sam_cross_i2t_blocks_per_sm(int heads, int masked, int pow2) {
  const sampt::I2tKernel kernel = sampt::i2t_kernel(masked, pow2);
  const size_t bytes = sampt::k3i_shared_bytes(heads);
  int err = sampt::i2t_attributes(masked, pow2, bytes);
  int blocks = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, sampt::K3I_WARPS * 32, bytes);
  return err ? -err : blocks;
}
