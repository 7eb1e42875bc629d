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
// which is the rounding sequence of the TPU kernel, step for step.
//
// What bounds it on the H100: the products are small (about 6 GFLOP per
// call at 48 pairs x 8 heads x ~60 tokens x 4096 image tokens, 0.006 ms of
// tensor-core time) and the operands about 100 MB (0.03 ms of device
// memory); what the naive composition pays is the [B, H, Nq, Nk]
// probability tensor in device memory (about 380 MB in f32 at those
// sizes), five times per decoder pass. Both kernels make two passes over
// the keys: the first finds each row's max and sum, the second forms the
// normalised, rounded p and accumulates p.v, so the rounding of p happens
// after normalisation exactly as in the TPU kernel, and nothing of size
// Nq x Nk is ever stored. What remains is per-logit work in each pass:
// the roundings, the division and an exp. The shape picks the layout:
//  - image -> token (4096 queries x ~60 keys, with the key mask): a thread
//    per query row on the FP32 pipes, q in registers and the keys streamed
//    through shared memory in chunks of 64 (small enough for many blocks
//    per SM).
//  - token -> image (~60 queries x 4096 keys): the products on the tensor
//    cores (mma.sync m16n8k16, bf16 in, f32 out; the head dim 16 is one
//    k-step), a block per 64 query rows sharing every key chunk it stages
//    (below).

#include "mma.cuh"

namespace sampt {

constexpr int K3_THREADS = 128;
constexpr int K3_DH = 16;  // head dim
constexpr int K3_KC = 64;  // keys per shared-memory chunk (the token count)

__global__ void __launch_bounds__(K3_THREADS)
cross_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const unsigned char* __restrict__ kv_valid,
                       __nv_bfloat16* __restrict__ out, int nq, int nk,
                       int heads, float divisor) {
  __shared__ float ks[K3_KC][K3_DH + 1];
  __shared__ float vs[K3_KC][K3_DH + 1];
  __shared__ unsigned char valid[K3_KC];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * K3_THREADS + threadIdx.x;
  const bool active = row < nq;
  const int ch = heads * K3_DH;

  float qr[K3_DH];
#pragma unroll
  for (int c = 0; c < K3_DH; ++c)
    qr[c] = active ? __bfloat162float(q[((long)b * nq + row) * ch +
                                        h * K3_DH + c])
                   : 0.f;
  const float masked = round_bf16(-1e9f);

  float m = -INFINITY, l = 0.f;
  float acc[K3_DH];
#pragma unroll
  for (int c = 0; c < K3_DH; ++c) acc[c] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < nk; j0 += K3_KC) {
      const int kc = min(K3_KC, nk - j0);
      __syncthreads();
      for (int i = threadIdx.x; i < kc * K3_DH; i += K3_THREADS) {
        const int j = i / K3_DH, c = i % K3_DH;
        const long off = ((long)b * nk + j0 + j) * ch + h * K3_DH + c;
        ks[j][c] = __bfloat162float(k[off]);
        if (pass == 1) vs[j][c] = __bfloat162float(v[off]);
      }
      for (int j = threadIdx.x; j < kc; j += K3_THREADS)
        valid[j] = kv_valid ? kv_valid[(long)b * nk + j0 + j] : 1;
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < kc; ++j) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < K3_DH; ++c) a = fmaf(qr[c], ks[j][c], a);
        const float lg = valid[j] ? round_bf16(round_bf16(a) / divisor)
                                  : masked;
        if (pass == 0) {
          const float m_new = fmaxf(m, lg);
          l = l * expf(m - m_new) + expf(lg - m_new);
          m = m_new;
        } else {
          const float p = round_bf16(expf(lg - m) / l);
#pragma unroll
          for (int c = 0; c < K3_DH; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
        }
      }
    }
  }
  if (active) {
    __nv_bfloat16* o = out + ((long)b * nq + row) * ch + h * K3_DH;
#pragma unroll
    for (int c = 0; c < K3_DH; ++c) o[c] = __float2bfloat16(acc[c]);
  }
}

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
  if (nk > nq) {  // token -> image: a block per 64 query rows
    int exponent;
    const bool pow2 = frexpf(divisor, &exponent) == 0.5f;
    const float scale = pow2 ? 1.f / divisor : divisor;
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
  } else {  // image -> token: a thread per query row
    dim3 grid((nq + sampt::K3_THREADS - 1) / sampt::K3_THREADS, heads, b);
    sampt::cross_attention_kernel<<<grid, sampt::K3_THREADS, 0, s>>>(
        qp, kp, vp, mp, op, nq, nk, heads, divisor);
  }
  return (int)cudaGetLastError();
}
