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
// in registers.

#include <mma.h>

#include "common.cuh"

namespace sampt {

constexpr int K2_WARPS = 4;
constexpr int K2_TQ = 16 * K2_WARPS;  // query rows per block
constexpr int K2_TK = 64;             // keys per tile
constexpr int K2_LDS = K2_TK + 4;     // f32 logits row stride
constexpr int K2_LDP = K2_TK + 8;     // bf16 P row stride (aliases logits)
static_assert(K2_TQ == K2_TK, "q and k/v tiles share one buffer size");

struct GlobalLayout {
  int ldh, ldo;
  size_t q, kv, bias, warp, s, o, total;
  __host__ __device__ GlobalLayout(int d, int nb) {
    ldh = d + 8;  // bf16 q/k/v row stride (a multiple of 8, 16-byte rows)
    ldo = d + 4;  // f32 output row stride
    q = 0;
    kv = align16(sizeof(__nv_bfloat16) * K2_TQ * ldh);  // one k or v tile
    bias = q + kv + 4 * kv;  // q, then k0 v0 k1 v1
    warp = bias + align16(sizeof(__nv_bfloat16) * K2_TQ * nb);
    s = align16(sizeof(float) * 16 * K2_LDS);
    o = align16(sizeof(float) * 16 * ldo);
    total = warp + K2_WARPS * (s + o);
  }
};

__global__ void __launch_bounds__(K2_WARPS * 32)
global_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int kh, int kw,
                        int heads, int d, float scale) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = kh * kw;
  const int nb = kh + kw;
  const int q0 = blockIdx.x * K2_TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const GlobalLayout L(d, nb);
  const int ldh = L.ldh, ldo = L.ldo;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* bsm = reinterpret_cast<bf16*>(smem + L.bias);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = smem + L.warp + warp * (L.s + L.o);
  float* sw = reinterpret_cast<float*>(wbase);
  bf16* pw = reinterpret_cast<bf16*>(wbase);  // P reuses the logits slab
  float* ow = reinterpret_cast<float*>(wbase + L.s);

  const long row = 3L * heads * d;
  const bf16* base = qkv + (long)b * n * row + (long)h * d;
  const int chunks = d / 8;  // 16-byte chunks per head row

  // k/v tile `t` into buffer `buf` (zero rows past n), asynchronously.
  auto load_kv = [&](int t, int buf) {
    bf16* ks = reinterpret_cast<bf16*>(smem + L.kv * (1 + 2 * buf));
    bf16* vs = reinterpret_cast<bf16*>(smem + L.kv * (2 + 2 * buf));
    for (int i = threadIdx.x; i < K2_TK * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const int k = t * K2_TK + r;
      const bf16* src = base + (long)(k < n ? k : 0) * row + c;
      cp_async16(ks + r * ldh + c, src + (long)heads * d, k < n);
      cp_async16(vs + r * ldh + c, src + 2L * heads * d, k < n);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  for (int i = threadIdx.x; i < K2_TQ * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int q = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q < n) raw = *reinterpret_cast<const uint4*>(base + (long)q * row + c);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    *reinterpret_cast<uint4*>(qs + r * ldh + c) = raw;
  }
  for (int i = threadIdx.x; i < K2_TQ * nb; i += blockDim.x) {
    const int t = i / nb;
    const int q = q0 + t;
    bsm[i] = q < n ? bias[(((long)b * n + q) * heads + h) * nb + i - t * nb]
                   : __float2bfloat16(0.f);
  }
  // Two lanes per query row: lane owns row r of the warp's 16 and the
  // tile's even (half 0) or odd (half 1) columns.
  const int r = lane >> 1;
  const int half = lane & 1;
  const bf16* br = bsm + (warp * 16 + r) * nb;
  for (int c = half; c < d; c += 2) ow[r * ldo + c] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int ntiles = (n + K2_TK - 1) / K2_TK;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks =
        reinterpret_cast<const bf16*>(smem + L.kv * (1 + 2 * (it & 1)));
    const bf16* vs =
        reinterpret_cast<const bf16*>(smem + L.kv * (2 + 2 * (it & 1)));

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    for (int j = 0; j < K2_TK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, qs + warp * 16 * ldh + kk, ldh);
        wmma::load_matrix_sync(bm, ks + j * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, K2_LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on the row's columns half, 2c + half.
    const int k_first = it * K2_TK + half;
    int yk = k_first / kw, xk = k_first - yk * kw;
    float sv[K2_TK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < K2_TK / 2; ++c) {
      const int k = k_first + 2 * c;
      float v = -INFINITY;
      if (k < n)
        v = sw[r * K2_LDS + 2 * c + half] +
            (__bfloat162float(br[yk]) + __bfloat162float(br[kh + xk]));
      sv[c] = v;
      tmax = fmaxf(tmax, v);
      xk += 2;
      while (xk >= kw) {
        xk -= kw;
        ++yk;
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    __syncwarp();  // every lane has read its logits: P may overwrite them
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < K2_TK / 2; ++c) {
      const float p = expf(sv[c] - m_new);  // 0 for keys past n
      psum += p;
      pw[r * K2_LDP + 2 * c + half] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    for (int c = half; c < d; c += 2) ow[r * ldo + c] *= alpha;
    __syncwarp();

    // O += P V on the tensor cores, accumulating onto the rescaled tile.
    for (int t = 0; t < d; t += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, ow + t, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < K2_TK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, pw + kk, K2_LDP);
        wmma::load_matrix_sync(bm, vs + kk * ldh + t, ldh);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(ow + t, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();  // the buffer is reloaded two tiles from now
  }

  const int q = q0 + warp * 16 + r;
  if (q < n) {
    bf16* o = out + ((long)b * n + q) * heads * d + (long)h * d;
    for (int c = half; c < d; c += 2)
      o[c] = __float2bfloat16(ow[r * ldo + c] / l);
  }
}

static int launch_global(const void* qkv, const void* bias, void* out,
                         int b, int kh, int kw, int heads, int d,
                         float scale, cudaStream_t stream) {
  const GlobalLayout L(d, kh + kw);
  cudaError_t err = cudaFuncSetAttribute(
      global_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int n = kh * kw;
  dim3 grid((n + K2_TQ - 1) / K2_TQ, heads, b);
  global_attention_kernel<<<grid, K2_WARPS * 32, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), kh, kw, heads, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace sampt

// qkv [b, kh*kw, 3*heads*d] (16-byte aligned), bias [b, kh*kw, heads,
// kh+kw], out [b, kh*kw, heads*d], all contiguous bfloat16; d a multiple
// of 16, at most 128. Returns a cudaError_t.
extern "C" int sam_global_attention(const void* qkv, const void* bias,
                                    void* out, int b, int kh, int kw,
                                    int heads, int d, float scale,
                                    void* stream) {
  if (d % 16 != 0 || d > 128 || kw < 2 || !sampt::aligned16(qkv) ||
      sampt::GlobalLayout(d, kh + kw).total > sampt::kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  return sampt::launch_global(qkv, bias, out, b, kh, kw, heads, d, scale,
                              static_cast<cudaStream_t>(stream));
}
