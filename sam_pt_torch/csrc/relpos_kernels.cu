// The two rel-pos attention kernels shared by K1, K2 and K4 and their
// launchers; what they compute, their arguments and shared-memory layouts
// are in relpos_kernels.cuh.

#include <mma.h>

#include "mma.cuh"
#include "relpos_kernels.cuh"

namespace sampt {

// ---------------------------------------------------------------------------
// Window body: the whole problem per block
// ---------------------------------------------------------------------------
//
// Grid (heads, batch), 4 warps, one instance per head dim D (a multiple of
// 16 up to 128), so that every ldmatrix address is a base register plus an
// immediate. The bias rides the logits product as the TPU kernel's does:
// each query's A fragment is [round_bf16(q * scale) | bias_h row | bias_w
// row | 0 ... | -big] (D + 32 columns) and each key's B column is
// [k | one-hot(y) | one-hot(kh + x) | 0 ... | past n], so one m16n8k16
// chain gives q.k + bias_h[y] + bias_w[x] in f32, and keys past n get a
// logit near -3.4e38, whose exponential is 0. The one-hot block [208 keys,
// 32] is built in shared memory once per block; the A fragments of q and
// of the bias rows come straight from device memory, a row tile ahead.
//
// The block copies its problem's k (one cp.async group), then v (a
// second), so that each warp's first logits are formed while v is in
// flight. Warp w takes the 16-row query tiles w, w + 4, w + 8, ... of
// the ceil(n / 16). For a tile it holds S against all 13 key tiles in
// registers: s[j][0..3] are keys 2t, 2t + 1 and s[j][4..7] keys 2t + 8,
// 2t + 9 of key tile j, rows g (elements 0, 1, 4, 5) and g + 8 (2, 3, 6,
// 7), g = lane / 4, t = lane % 4. The row max and sum close over the lane
// quad, and p = rnd(e * (1 / sum)) packs straight into the A fragments of
// P V; O is D / 2 f32 a thread, rounded once at the store. All 13 key
// tiles are computed whatever n is: k holds 208 rows, zeros past n, and v
// rows past n read k's, so every operand is finite and p is 0 past n. q
// rows past n read row n - 1 and are not stored.

constexpr int kWindowThreads = 32 * kWindowWarps;

// round_bf16(x * scale) for both halves of a bf16 pair.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// Two blocks share an SM; 4 warps a block leave each thread up to 255
// registers (blocks of 5 to 8 warps would get 128).
template <int D>
__global__ void __launch_bounds__(kWindowThreads, 2)
relpos_window_kernel(const RelposArgs a) {
  typedef __nv_bfloat16 bf16;
  constexpr int LDH = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  constexpr int KQ = D / 16;     // k-steps of q.k
  constexpr int KB = kWindowBiasCols / 16;  // k-steps of the bias
  constexpr int LDB = kWindowBiasCols + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = a.kh, kw = a.kw;
  const int n = kh * kw, nb = kh + kw;
  const int nt = (n + 15) >> 4;  // 16-row query tiles
  const WindowLayout L(n, D);
  bf16* vs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* oh = reinterpret_cast<bf16*>(smem + L.onehot);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // k (zeros from row n to 207), then v, in 16-byte chunks.
  const long off = b * a.x_b + h * a.x_h;
  for (int i = threadIdx.x; i < kWindowMaxN * CHUNKS; i += kWindowThreads) {
    const int r = i / CHUNKS, c = (i - r * CHUNKS) * 8;
    cp_async16(ks + r * LDH + c, a.k + off + (long)min(r, n - 1) * a.x_r + c,
               r < n);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < n * CHUNKS; i += kWindowThreads) {
    const int r = i / CHUNKS, c = (i - r * CHUNKS) * 8;
    cp_async16(vs + r * LDH + c, a.v + off + (long)r * a.x_r + c);
  }
  cp_async_commit();

  // The one-hot block, 8 columns a thread at a time: key j < n has ones at
  // y_j and kh + x_j, key j >= n one in the last column.
  for (int i = threadIdx.x; i < kWindowMaxN * (kWindowBiasCols / 8);
       i += kWindowThreads) {
    const int j = i / (kWindowBiasCols / 8);
    const int c0 = (i - j * (kWindowBiasCols / 8)) * 8;
    const int y = j / kw, x = kh + j - y * kw;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      const bool lo = j < n ? (c == y || c == x) : c == kWindowBiasCols - 1;
      const bool hi =
          j < n ? (c + 1 == y || c + 1 == x) : c + 1 == kWindowBiasCols - 1;
      w[e] = (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);  // bf16 1.0
    }
    *reinterpret_cast<uint4*>(oh + j * LDB + c0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }

  // A fragments of row tile rt from device memory: q rows g, g + 8 (raw
  // bf16 pairs; scaled where they are used) and their bias rows. Column
  // pairs come by 4-byte loads where no pair straddles bias_h and bias_w
  // (kh even, or one contiguous row as in K1) and the rows are 4-byte
  // aligned, else column by column.
  const bf16* bh = a.bias_h + b * a.bh_b + h * a.bh_h;
  const bf16* bw = a.bias_w + b * a.bw_b + h * a.bw_h - kh;
  const bool pairs =
      (kh % 2 == 0 || (bw == bh && a.bw_r == a.bh_r)) && nb % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(bh) | reinterpret_cast<uintptr_t>(bw) |
        (uintptr_t)(a.bh_r | a.bw_r) * sizeof(bf16)) & 3) == 0;
  const uint32_t kBig = 0xFF7Fu;  // bf16 -3.39e38, finite
  auto load_frags = [&](int rt, uint32_t (&qf)[KQ][4],
                        uint32_t (&bf)[KB][4]) {
    const int r0 = min(rt * 16 + g, n - 1), r1 = min(rt * 16 + g + 8, n - 1);
    const uint32_t* q0 =
        reinterpret_cast<const uint32_t*>(a.q + off + (long)r0 * a.x_r) + t;
    const uint32_t* q1 =
        reinterpret_cast<const uint32_t*>(a.q + off + (long)r1 * a.x_r) + t;
#pragma unroll
    for (int s = 0; s < KQ; ++s) {
      qf[s][0] = __ldg(q0 + 8 * s);
      qf[s][1] = __ldg(q1 + 8 * s);
      qf[s][2] = __ldg(q0 + 8 * s + 4);
      qf[s][3] = __ldg(q1 + 8 * s + 4);
    }
    const bf16* h0 = bh + r0 * a.bh_r;
    const bf16* h1 = bh + r1 * a.bh_r;
    const bf16* w0 = bw + r0 * a.bw_r;
    const bf16* w1 = bw + r1 * a.bw_r;
    // Columns c, c + 1 (c even) of row g (r = 0) or g + 8 as a bf16 pair.
    auto pair = [&](int r, int c) -> uint32_t {
      const uint32_t mask = c + 1 == kWindowBiasCols - 1 ? kBig : 0u;
      if (pairs)
        return c < nb ? __ldg(reinterpret_cast<const uint32_t*>(
                            (c < kh ? (r ? h1 : h0) : (r ? w1 : w0)) + c))
                      : mask << 16;
      const bf16* lo = (c < kh ? (r ? h1 : h0) : (r ? w1 : w0)) + c;
      const bf16* hi = (c + 1 < kh ? (r ? h1 : h0) : (r ? w1 : w0)) + c + 1;
      const uint32_t vl =
          c < nb ? __ldg(reinterpret_cast<const unsigned short*>(lo)) : 0u;
      const uint32_t vh =
          c + 1 < nb ? __ldg(reinterpret_cast<const unsigned short*>(hi))
                     : mask;
      return vl | vh << 16;
    };
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      const int c = 16 * s + 2 * t;
      bf[s][0] = pair(0, c);
      bf[s][1] = pair(1, c);
      bf[s][2] = pair(0, c + 8);
      bf[s][3] = pair(1, c + 8);
    }
  };

  uint32_t pf[kWindowTiles][4];  // P of the warp's current row tile

  // Logits and softmax of a row tile from its A fragments, into pf.
  auto scores = [&](const uint32_t (&qf)[KQ][4],
                    const uint32_t (&bf)[KB][4]) {
    float s[kWindowTiles][8];
#pragma unroll
    for (int j = 0; j < kWindowTiles; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[j][e] = 0.f;
    // ldmatrix rows: keys lane % 8 + (lane / 16) * 8 of a tile at column
    // bit 3 of lane (keys 0-7 x cols 0-7, 0-7 x 8-15, 8-15 x 0-7, 8-15 x
    // 8-15: the B fragments of two m16n8 products).
    const int krow = (lane & 7) + ((lane >> 4) << 3);
    const int kcol = ((lane >> 3) & 1) << 3;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t qa[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[e] = scale_bf16x2(qf[kk][e], a.scale);
#pragma unroll
      for (int j = 0; j < kWindowTiles; ++j) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (16 * j + krow) * LDH + 16 * kk + kcol);
        mma_16816(&s[j][0], qa, kb[0], kb[1]);
        mma_16816(&s[j][4], qa, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
      for (int j = 0; j < kWindowTiles; ++j) {
        uint32_t kb[4];
        ldmatrix_x4(kb, oh + (16 * j + krow) * LDB + 16 * kk + kcol);
        mma_16816(&s[j][0], bf[kk], kb[0], kb[1]);
        mma_16816(&s[j][4], bf[kk], kb[2], kb[3]);
      }
    }

    // e = exp(logit - max) as exp2(logit log2 e - max log2 e).
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kWindowTiles; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e & 2)
          m1 = fmaxf(m1, s[j][e]);
        else
          m0 = fmaxf(m0, s[j][e]);
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    const float c0 = -m0 * kLog2e, c1 = -m1 * kLog2e;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < kWindowTiles; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool second = e & 2;  // row g + 8
        const float x = fast_exp2(fmaf(s[j][e], kLog2e, second ? c1 : c0));
        s[j][e] = x;
        if (second)
          l1 += x;
        else
          l0 += x;
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
    for (int j = 0; j < kWindowTiles; ++j) {
      pf[j][0] = pack_bf16(s[j][0] * r0, s[j][1] * r0);
      pf[j][1] = pack_bf16(s[j][2] * r1, s[j][3] * r1);
      pf[j][2] = pack_bf16(s[j][4] * r0, s[j][5] * r0);
      pf[j][3] = pack_bf16(s[j][6] * r1, s[j][7] * r1);
    }
  };

  // O = P V for row tile rt: acc[2c] holds dims 16c + 2t, 16c + 2t + 1 and
  // acc[2c + 1] dims 16c + 8 + 2t, 16c + 9 + 2t of rows g (0, 1) and g + 8
  // (2, 3); rounded once at the store.
  auto output = [&](int rt) {
    // ldmatrix.trans rows: keys lane % 8 + bit 3 of lane * 8 at dims
    // (lane / 16) * 8 (keys 0-7 / 8-15 x dims 0-7, then x dims 8-15: the
    // B fragments of dims 0-7 and of dims 8-15).
    const bf16* vrow = vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDH +
                       ((lane >> 4) << 3);
    float acc[D / 8][4];
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kWindowTiles; ++j)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + j * 16 * LDH + 16 * c);
        mma_16816(acc[2 * c], pf[j], vb[0], vb[1]);
        mma_16816(acc[2 * c + 1], pf[j], vb[2], vb[3]);
      }
    const int row0 = rt * 16 + g;
    bf16* o0 = a.out + b * a.o_b + h * a.o_h + (long)row0 * a.o_r + 2 * t;
    bf16* o1 = o0 + 8 * a.o_r;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (row0 < n)
        *reinterpret_cast<uint32_t*>(o0 + 8 * c) =
            pack_bf16(acc[c][0], acc[c][1]);
      if (row0 + 8 < n)
        *reinterpret_cast<uint32_t*>(o1 + 8 * c) =
            pack_bf16(acc[c][2], acc[c][3]);
    }
  };

  // Every warp runs the same number of rounds, so that all reach the
  // barrier for v in the first, with or without a tile of their own.
  uint32_t qf[KQ][4], bf[KB][4];
  if (warp < nt) load_frags(warp, qf, bf);
  const int rounds = (nt + kWindowWarps - 1) / kWindowWarps;
  cp_async_wait<1>();
  __syncthreads();  // k and the one-hot block are in
  for (int it = 0; it < rounds; ++it) {
    const int rt = warp + it * kWindowWarps;
    if (rt < nt) {
      scores(qf, bf);
      if (rt + kWindowWarps < nt) load_frags(rt + kWindowWarps, qf, bf);
    }
    if (it == 0) {
      cp_async_wait<0>();
      __syncthreads();  // v is in
    }
    if (rt < nt) output(rt);
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

// The window body's instance for head dim d, or null.
typedef void (*WindowKernel)(const RelposArgs);
static WindowKernel window_kernel(int d) {
  switch (d) {
    case 16: return relpos_window_kernel<16>;
    case 32: return relpos_window_kernel<32>;
    case 48: return relpos_window_kernel<48>;
    case 64: return relpos_window_kernel<64>;
    case 80: return relpos_window_kernel<80>;
    case 96: return relpos_window_kernel<96>;
    case 112: return relpos_window_kernel<112>;
    case 128: return relpos_window_kernel<128>;
  }
  return nullptr;
}

// Its shared-memory limit, and the carveout at its maximum: without it an
// SM may be set up with too little shared memory for two blocks.
static int window_attributes(WindowKernel kernel, size_t bytes) {
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

int launch_relpos_window(const RelposArgs& a, int heads, int batch,
                         cudaStream_t stream) {
  const WindowLayout L(a.kh * a.kw, a.d);
  const WindowKernel kernel = window_kernel(a.d);
  const int err = window_attributes(kernel, L.total);
  if (err) return err;
  kernel<<<dim3(heads, batch), kWindowThreads, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

int relpos_window_blocks_per_sm(int kh, int kw, int d) {
  const WindowLayout L(kh * kw, d);
  const WindowKernel kernel = window_kernel(d);
  int err = window_attributes(kernel, L.total);
  int blocks = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kWindowThreads, L.total);
  return err ? -err : blocks;
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
