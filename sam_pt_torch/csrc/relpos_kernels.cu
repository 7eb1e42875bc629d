// The two rel-pos attention kernels shared by K1, K2 and K4 and their
// launchers; what they compute, their arguments and shared-memory layouts
// are in relpos_kernels.cuh.

#include <mma.h>

#include "relpos_kernels.cuh"

namespace sampt {

// ---------------------------------------------------------------------------
// Whole sequence per block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRelposWarps * 32)
relpos_window_kernel(const RelposArgs a) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kw = a.kw, d = a.d;
  const int n = a.kh * kw;
  const WindowLayout L(n, d);
  const int np = L.np, ldh = L.ldh, lds = L.lds, ldp = L.ldp;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.tile);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * L.tile);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sw = reinterpret_cast<float*>(smem + L.warp + warp * (L.s + L.p));
  bf16* pw = reinterpret_cast<bf16*>(smem + L.warp + warp * (L.s + L.p) + L.s);

  const long off = b * a.x_b + h * a.x_h;
  const bf16 zero = __float2bfloat16(0.f);
  // q, k and v rows by 16-byte asynchronous copies (zeros past n), then
  // each thread scales and rounds the q chunks it copied itself.
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < np * chunks; i += blockDim.x) {
    const int t = i / chunks, c = (i - t * chunks) * 8;
    const long src = off + (long)(t < n ? t : 0) * a.x_r + c;
    cp_async16(qs + t * ldh + c, a.q + src, t < n);
    cp_async16(ks + t * ldh + c, a.k + src, t < n);
    cp_async16(vs + t * ldh + c, a.v + src, t < n);
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int i = threadIdx.x; i < np * chunks; i += blockDim.x) {
    const int t = i / chunks, c = (i - t * chunks) * 8;
    uint4* chunk = reinterpret_cast<uint4*>(qs + t * ldh + c);
    uint4 raw = *chunk;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * a.scale);
    *chunk = raw;
  }
  __syncthreads();

  const int r = lane >> 1;  // two lanes per query row of the 16-row tile
  const int half = lane & 1;
  for (int rt = warp; rt < np / 16; rt += kRelposWarps) {
    for (int j = 0; j < np / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(qa, qs + rt * 16 * ldh + kk, ldh);
        wmma::load_matrix_sync(kb, ks + j * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, qa, kb, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, lds, wmma::mem_row_major);
    }
    __syncwarp();

    const int q = rt * 16 + r;
    const int qc = q < n ? q : 0;
    float* srow = sw + r * lds;
    const bf16* bqh = a.bias_h + b * a.bh_b + h * a.bh_h + qc * a.bh_r;
    const bf16* bqw = a.bias_w + b * a.bw_b + h * a.bw_h + qc * a.bw_r;
    float mx = -INFINITY;
    for (int c = half; c < n; c += 2) {
      const int yk = c / kw;
      const float v = srow[c] + (__bfloat162float(bqh[yk]) +
                                 __bfloat162float(bqw[c - yk * kw]));
      srow[c] = v;
      mx = fmaxf(mx, v);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float sum = 0.f;
    for (int c = half; c < n; c += 2) {
      const float e = expf(srow[c] - mx);
      srow[c] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    bf16* prow = pw + r * ldp;
    for (int c = half; c < np; c += 2)
      prow[c] = c < n ? __float2bfloat16(srow[c] / sum) : zero;
    __syncwarp();

    for (int t = 0; t < d; t += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < np; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, pw + kk, ldp);
        wmma::load_matrix_sync(vb, vs + kk * ldh + t, ldh);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(sw + t, acc, lds, wmma::mem_row_major);
    }
    __syncwarp();
    if (q < n) {
      bf16* o = a.out + b * a.o_b + h * a.o_h + q * a.o_r;
      for (int c = half; c < d; c += 2) o[c] = __float2bfloat16(srow[c]);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Flash: key tiles with an online softmax
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRelposWarps * 32)
relpos_flash_kernel(const RelposArgs a) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kh = a.kh, kw = a.kw, d = a.d;
  const int n = kh * kw;
  const int nb = kh + kw;
  const int q0 = blockIdx.x * kFlashTQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const FlashLayout L(d, nb);
  const int ldh = L.ldh, ldo = L.ldo;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* bsm = reinterpret_cast<bf16*>(smem + L.bias);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* wbase = smem + L.warp + warp * (L.s + L.o);
  float* sw = reinterpret_cast<float*>(wbase);
  bf16* pw = reinterpret_cast<bf16*>(wbase);  // P reuses the logits slab
  float* ow = reinterpret_cast<float*>(wbase + L.s);

  const long off = b * a.x_b + h * a.x_h;
  const int chunks = d / 8;  // 16-byte chunks per head row

  // k/v tile `t` into buffer `buf` (zero rows past n), asynchronously.
  auto load_kv = [&](int t, int buf) {
    bf16* ks = reinterpret_cast<bf16*>(smem + L.kv * (1 + 2 * buf));
    bf16* vs = reinterpret_cast<bf16*>(smem + L.kv * (2 + 2 * buf));
    for (int i = threadIdx.x; i < kFlashTK * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      const int k = t * kFlashTK + r;
      const long src = off + (long)(k < n ? k : 0) * a.x_r + c;
      cp_async16(ks + r * ldh + c, a.k + src, k < n);
      cp_async16(vs + r * ldh + c, a.v + src, k < n);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  for (int i = threadIdx.x; i < kFlashTQ * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int q = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q < n)
      raw = *reinterpret_cast<const uint4*>(a.q + off + (long)q * a.x_r + c);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * a.scale);
    *reinterpret_cast<uint4*>(qs + r * ldh + c) = raw;
  }
  // Bias rows of the q-tile: [bias_h row | bias_w row] per query.
  const bf16* bh = a.bias_h + b * a.bh_b + h * a.bh_h;
  const bf16* bw = a.bias_w + b * a.bw_b + h * a.bw_h;
  for (int i = threadIdx.x; i < kFlashTQ * nb; i += blockDim.x) {
    const int t = i / nb, j = i - t * nb;
    const int q = q0 + t;
    bf16 v = __float2bfloat16(0.f);
    if (q < n) v = j < kh ? bh[q * a.bh_r + j] : bw[q * a.bw_r + j - kh];
    bsm[i] = v;
  }
  // Two lanes per query row: lane owns row r of the warp's 16 and the
  // tile's even (half 0) or odd (half 1) columns.
  const int r = lane >> 1;
  const int half = lane & 1;
  const bf16* br = bsm + (warp * 16 + r) * nb;
  for (int c = half; c < d; c += 2) ow[r * ldo + c] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int ntiles = (n + kFlashTK - 1) / kFlashTK;
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
    for (int j = 0; j < kFlashTK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(qa, qs + warp * 16 * ldh + kk, ldh);
        wmma::load_matrix_sync(kb, ks + j * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, qa, kb, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, kFlashLDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on the row's columns half, 2c + half.
    const int k_first = it * kFlashTK + half;
    int yk = k_first / kw, xk = k_first - yk * kw;
    float sv[kFlashTK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kFlashTK / 2; ++c) {
      const int k = k_first + 2 * c;
      float v = -INFINITY;
      if (k < n)
        v = sw[r * kFlashLDS + 2 * c + half] +
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
    for (int c = 0; c < kFlashTK / 2; ++c) {
      const float p = expf(sv[c] - m_new);  // 0 for keys past n
      psum += p;
      pw[r * kFlashLDP + 2 * c + half] = __float2bfloat16(p);
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
      for (int kk = 0; kk < kFlashTK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, pw + kk, kFlashLDP);
        wmma::load_matrix_sync(vb, vs + kk * ldh + t, ldh);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(ow + t, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();  // the buffer is reloaded two tiles from now
  }

  const int q = q0 + warp * 16 + r;
  if (q < n) {
    bf16* o = a.out + b * a.o_b + h * a.o_h + (long)q * a.o_r;
    for (int c = half; c < d; c += 2)
      o[c] = __float2bfloat16(ow[r * ldo + c] / l);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

int launch_relpos_window(const RelposArgs& a, int heads, int batch,
                         cudaStream_t stream) {
  const WindowLayout L(a.kh * a.kw, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  relpos_window_kernel<<<dim3(heads, batch), kRelposWarps * 32, L.total,
                         stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_relpos_flash(const RelposArgs& a, int heads, int batch,
                        cudaStream_t stream) {
  const FlashLayout L(a.d, a.kh + a.kw);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int n = a.kh * a.kw;
  relpos_flash_kernel<<<dim3((n + kFlashTQ - 1) / kFlashTQ, heads, batch),
                        kRelposWarps * 32, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace sampt
