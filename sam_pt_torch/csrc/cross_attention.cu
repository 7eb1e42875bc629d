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
// call at 48 pairs x 8 heads x ~60 tokens x 4096 image tokens); what the
// naive composition pays is the [B, H, Nq, Nk] probability tensor in
// device memory (about 380 MB in f32 at those sizes), five times per
// decoder pass. Design: two passes over the keys per query row: the first
// finds the row max and sum (online), the second forms the normalised,
// rounded p and accumulates p.v, so the rounding of p happens after
// normalisation exactly as in the TPU kernel, and nothing of size Nq x Nk
// is ever stored. The q.k products are computed twice and every p costs
// an exp and a division, so the kernel is bound by the FP32 and SFU pipes
// once each key is read from device memory only a few times. The shape
// picks the parallel layout: image -> token (4096 queries x ~60 keys, with
// the key mask) gives each thread a query row, with q in registers and the
// keys streamed through shared memory in chunks of 64 (small enough for
// many blocks per SM); token -> image (~60 queries x 4096 keys) gives each
// block 32 query rows that share every key chunk it stages in shared
// memory (below). Later: tensor-core tiles for the 16-wide products.

#include "common.cuh"

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

// Token -> image (a few dozen queries, 4096 keys): one block per (pair,
// head, group of 32 query rows), 8 warps of 4 rows each. The block streams
// the head's keys (and, in the second pass, values) through shared memory
// in chunks of 256, one key row per thread, so each key is read from device
// memory once per block and pass instead of once per query row; within a
// chunk the lanes of a warp split the keys, every key row read from shared
// memory serves the warp's 4 query rows, and the per-lane (max, sum) pairs
// and output sums are combined by shuffles at the end.
constexpr int K3R_WARPS = 8;
constexpr int K3R_RPW = 4;                       // query rows per warp
constexpr int K3R_ROWS = K3R_WARPS * K3R_RPW;    // query rows per block
constexpr int K3R_KC = K3R_WARPS * 32;           // keys per chunk
constexpr int K3R_LD = K3_DH + 1;                // odd stride: no bank clash

// One 16-wide bf16 row (32 bytes, 16-byte aligned) as floats.
__device__ __forceinline__ void load_row16(const __nv_bfloat16* src,
                                           float* dst) {
  uint4 raw[2];
  raw[0] = reinterpret_cast<const uint4*>(src)[0];
  raw[1] = reinterpret_cast<const uint4*>(src)[1];
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(raw);
#pragma unroll
  for (int c = 0; c < K3_DH; ++c) dst[c] = __bfloat162float(e[c]);
}

__global__ void __launch_bounds__(K3R_WARPS * 32)
cross_attention_rows_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const unsigned char* __restrict__ kv_valid,
                            __nv_bfloat16* __restrict__ out, int nq, int nk,
                            int heads, float divisor) {
  __shared__ float ks[K3R_KC * K3R_LD];
  __shared__ float vs[K3R_KC * K3R_LD];
  __shared__ unsigned char valid[K3R_KC];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * K3R_ROWS + (threadIdx.x >> 5) * K3R_RPW;
  const int ch = heads * K3_DH;
  const __nv_bfloat16* kb = k + (long)b * nk * ch + h * K3_DH;
  const __nv_bfloat16* vb = v + (long)b * nk * ch + h * K3_DH;
  const unsigned char* vm = kv_valid ? kv_valid + (long)b * nk : nullptr;
  const float masked = round_bf16(-1e9f);

  // Rows past nq compute on zeros and are not written: every warp must
  // reach the block's barriers.
  float qf[K3R_RPW][K3_DH];
#pragma unroll
  for (int r = 0; r < K3R_RPW; ++r) {
    if (row0 + r < nq) {
      load_row16(q + ((long)b * nq + row0 + r) * ch + h * K3_DH, qf[r]);
    } else {
#pragma unroll
      for (int c = 0; c < K3_DH; ++c) qf[r][c] = 0.f;
    }
  }

  // Chunk of keys [j0, j0 + K3R_KC) (and values) into shared memory.
  auto load_chunk = [&](int j0, bool with_v) {
    const int kc = min(K3R_KC, nk - j0);
    __syncthreads();  // the previous chunk has been read by every warp
    const int j = threadIdx.x;
    if (j < kc) {
      load_row16(kb + (long)(j0 + j) * ch, ks + j * K3R_LD);
      if (with_v) load_row16(vb + (long)(j0 + j) * ch, vs + j * K3R_LD);
      valid[j] = vm ? vm[j0 + j] : 1;
    }
    __syncthreads();
    return kc;
  };
  auto logit = [&](const float* kr, const float* qr, bool ok) {
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < K3_DH; ++c) a = fmaf(qr[c], kr[c], a);
    return ok ? round_bf16(round_bf16(a) / divisor) : masked;
  };

  // Pass 1: per-lane running (max, sum) of each row over the lane's keys.
  float m[K3R_RPW], l[K3R_RPW];
#pragma unroll
  for (int r = 0; r < K3R_RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int j0 = 0; j0 < nk; j0 += K3R_KC) {
    const int kc = load_chunk(j0, false);
    for (int j = lane; j < kc; j += 32) {
      float kr[K3_DH];
#pragma unroll
      for (int c = 0; c < K3_DH; ++c) kr[c] = ks[j * K3R_LD + c];
      const bool ok = valid[j] != 0;
#pragma unroll
      for (int r = 0; r < K3R_RPW; ++r) {
        const float lg = logit(kr, qf[r], ok);
        const float m_new = fmaxf(m[r], lg);
        l[r] = l[r] * expf(m[r] - m_new) + expf(lg - m_new);
        m[r] = m_new;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < K3R_RPW; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_new = fmaxf(m[r], m2);
      if (m_new != -INFINITY) {  // lanes that saw no key carry (-inf, 0)
        l[r] = (m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - m_new)) +
               (m2 == -INFINITY ? 0.f : l2 * expf(m2 - m_new));
        m[r] = m_new;
      }
    }
  }

  // Pass 2: normalised, rounded p and its sum over the values.
  float acc[K3R_RPW][K3_DH];
#pragma unroll
  for (int r = 0; r < K3R_RPW; ++r) {
#pragma unroll
    for (int c = 0; c < K3_DH; ++c) acc[r][c] = 0.f;
  }
  for (int j0 = 0; j0 < nk; j0 += K3R_KC) {
    const int kc = load_chunk(j0, true);
    for (int j = lane; j < kc; j += 32) {
      float kr[K3_DH], vr[K3_DH];
#pragma unroll
      for (int c = 0; c < K3_DH; ++c) {
        kr[c] = ks[j * K3R_LD + c];
        vr[c] = vs[j * K3R_LD + c];
      }
      const bool ok = valid[j] != 0;
#pragma unroll
      for (int r = 0; r < K3R_RPW; ++r) {
        const float p = round_bf16(expf(logit(kr, qf[r], ok) - m[r]) / l[r]);
#pragma unroll
        for (int c = 0; c < K3_DH; ++c) acc[r][c] = fmaf(p, vr[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < K3R_RPW; ++r) {
#pragma unroll
    for (int c = 0; c < K3_DH; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
    }
    if (lane < K3_DH && row0 + r < nq) {
      float mine = 0.f;
#pragma unroll
      for (int c = 0; c < K3_DH; ++c)
        if (c == lane) mine = acc[r][c];
      out[((long)b * nq + row0 + r) * ch + h * K3_DH + lane] =
          __float2bfloat16(mine);
    }
  }
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
  if (nk > nq) {  // token -> image: a block per 32 query rows
    dim3 grid((nq + sampt::K3R_ROWS - 1) / sampt::K3R_ROWS, heads, b);
    sampt::cross_attention_rows_kernel<<<grid, sampt::K3R_WARPS * 32, 0, s>>>(
        qp, kp, vp, mp, op, nq, nk, heads, divisor);
  } else {  // image -> token: a thread per query row
    dim3 grid((nq + sampt::K3_THREADS - 1) / sampt::K3_THREADS, heads, b);
    sampt::cross_attention_kernel<<<grid, sampt::K3_THREADS, 0, s>>>(
        qp, kp, vp, mp, op, nq, nk, heads, divisor);
  }
  return (int)cudaGetLastError();
}
