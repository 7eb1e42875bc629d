// The two rel-pos attention kernels shared by K1, K2 and K4 and their
// launchers; what they compute, their arguments and shared-memory layouts
// are in relpos_kernels.cuh.

#include "hopper.cuh"
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
// Flash body: two passes over TMA-fed key tiles, wgmma
// ---------------------------------------------------------------------------
//
// Grid (ceil(n / 192), heads, batch), 512 threads (up to D = 80; above,
// two consumer warpgroups: 128 rows, 384 threads): warpgroups 0-2 take
// query rows 0-63, 64-127 and 128-191 of the block, warpgroup 3 is the
// producer, whose first thread issues every TMA copy and which gives its
// registers to the consumers (setmaxnreg: 24 against 160; 240 with two
// consumers). One template
// instance per head dim D and route: kRowTile (kw == 64, the ViT-H grid)
// makes each 64-key tile one grid row y, so the thread keeps its 16
// columns' bias_w values in registers and adds one bias_h value per row
// and tile; otherwise each logit gathers its two bias values from the
// staged rows, and keys past n are masked to -inf.
//
// The producer copies k of every tile (pass 1), then k and v of every
// tile (pass 2), each tile into the next stage of the ring (8 stages at
// ViT-H's shapes) once every consumer warp has released it (empty
// barrier, 4 warp arrivals a consumer warpgroup). A tile is 64-column
// boxes (128-byte rows) up to the last multiple of 64 columns, then
// 16-column boxes (32-byte rows): TMA's time goes by rows, so narrow
// boxes cost it several times their bytes. TMA fills rows past n with
// zeros.
//
// A consumer warpgroup stages its 64 bias rows and loads its q rows as
// wgmma A fragments (round_bf16(q * scale), D / 4 registers a thread,
// held up to D = 96 and loaded again per tile above), then per tile:
// pass 1 issues S = q k^T (wgmma m64n64k16, q from registers, k from
// shared memory, D / 16 k-steps) into 32 f32 registers a thread (rows g,
// g + 8 of its warp's 16, columns 8j + 2t, + 1), waits for it and turns
// it into log2-unit logits in place, keeping each thread's running max
// and sum over its own columns (merged over the lane quad at the end into
// the row's m and l); pass 2 issues tile t - 1's P . V (m64nDk16, v
// MN-major with the transpose bit, O in D / 2 registers) together with
// tile t's S, then forms p = rnd(2^(z - m - log2 l)), the softmax
// normalised before it is rounded, packed straight into the A fragments
// of the next P . V. O is rounded once at the store. Each warpgroup waits
// for its own products; the three warpgroups' products and softmax
// overlap. Measured and dropped: two consumer warpgroups (15% slower);
// four (160 registers become 120: spills); the next tile's S issued
// before the softmax; the warpgroups taking turns to issue (named
// barriers); clusters of two CTAs sharing k/v copies by TMA multicast.
// None was faster.

// Bytes of one 64-row box: 64 columns (128-byte swizzle) or 16 (32-byte).
constexpr uint32_t kWideBox = kFlashKeys * 128;
constexpr uint32_t kNarrowBox = kFlashKeys * 32;

struct FlashHeads {
  int k, v;  // head coordinate of head 0 in each TMA map
};

// TMA maps of k and v: boxes of 64 columns, and of 16 (the columns past
// the last multiple of 64).
struct FlashMaps {
  CUtensorMap k_wide, k_narrow, v_wide, v_narrow;
};

template <int D, bool kRowTile>
__global__ void __launch_bounds__(flash_threads(D), 1)
relpos_flash_kernel(const __grid_constant__ FlashMaps m, const RelposArgs a,
                    const FlashHeads c) {
  typedef __nv_bfloat16 bf16;
  constexpr int C = flash_consumers(D);
  // The consumers' share of the registers the producer leaves them.
  constexpr int kConsumerRegs = (65536 / 128 - kFlashProducerRegs) / C / 8 * 8;
  constexpr int KS = D / 16;      // k-steps of q.k
  constexpr int W = D / 64 * 64;  // columns in 64-column boxes
  constexpr int R = D - W;        // columns in 16-column boxes after them
  constexpr uint32_t kTile = 128 * D;  // one k or v tile (64 rows)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int kh = a.kh, kw = a.kw;
  const int n = kh * kw, nb = kh + kw;
  const FlashLayout L(D, nb);
  bf16* bsm = reinterpret_cast<bf16*>(ring + L.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L.bars);
  const int stages = L.stages;
  uint64_t* empty = full + stages;
  const int q0 = blockIdx.x * flash_rows(D);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = (n + kFlashKeys - 1) / kFlashKeys;
  // Warp-uniform, so that the compiler sees whole warpgroups take each
  // branch below.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * C);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == C) {
    setmaxnreg_dec<kFlashProducerRegs>();
    if (threadIdx.x == 128 * C) {
      int stage = 0, phase = 0;
      for (int i = 0; i < 2 * ntiles; ++i) {
        const bool with_v = i >= ntiles;
        const int row = (with_v ? i - ntiles : i) * kFlashKeys;
        unsigned char* ks = ring + stage * 2 * kTile;
        mbar_wait(empty + stage, phase ^ 1);
        mbar_expect_tx(full + stage, with_v ? 2 * kTile : kTile);
        for (int x = 0; x < W / 64; ++x) {
          tma_load_4d(ks + x * kWideBox, &m.k_wide, full + stage, 64 * x,
                      c.k + h, row, b);
          if (with_v)
            tma_load_4d(ks + kTile + x * kWideBox, &m.v_wide, full + stage,
                        64 * x, c.v + h, row, b);
        }
        for (int x = 0; x < R / 16; ++x) {
          tma_load_4d(ks + 128 * W + x * kNarrowBox, &m.k_narrow,
                      full + stage, W + 16 * x, c.k + h, row, b);
          if (with_v)
            tma_load_4d(ks + kTile + 128 * W + x * kNarrowBox, &m.v_narrow,
                        full + stage, W + 16 * x, c.v + h, row, b);
        }
        if (++stage == stages) stage = 0, phase ^= 1;
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ltid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = wg * 64 + (ltid >> 5) * 16 + g;  // rows r0, r0 + 8

    // The warpgroup's 64 bias rows [bias_h | bias_w], zeros past n: by
    // 16-byte cp.async where rows and tables are 16-byte aligned (the ViT
    // grids), else element by element, 16 loads in flight a thread.
    const bf16* bh = a.bias_h + b * a.bh_b + h * a.bh_h;
    const bf16* bw = a.bias_w + b * a.bw_b + h * a.bw_h;
    bf16* mine = bsm + wg * 64 * nb;
    if (((kh | kw | a.bh_r | a.bw_r) & 7) == 0 &&
        ((reinterpret_cast<uintptr_t>(bh) | reinterpret_cast<uintptr_t>(bw)) &
         15) == 0) {
      const int chunks = nb / 8;
      for (int i = ltid; i < 64 * chunks; i += 128) {
        const int r = i / chunks, col = (i - r * chunks) * 8;
        const int q = q0 + wg * 64 + r;
        const long qc = q < n ? q : n - 1;
        cp_async16(mine + r * nb + col,
                   col < kh ? bh + qc * a.bh_r + col
                            : bw + qc * a.bw_r + col - kh,
                   q < n);
      }
      cp_async_commit();
    } else {
      for (int i0 = ltid; i0 < 64 * nb; i0 += 128 * 16) {
        bf16 v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int i = i0 + 128 * u;
          const int r = i / nb, j = i - r * nb;
          const int q = q0 + wg * 64 + r;
          v[u] = __float2bfloat16(0.f);
          if (i < 64 * nb && q < n)
            v[u] = j < kh ? bh[(long)q * a.bh_r + j]
                          : bw[(long)q * a.bw_r + j - kh];
        }
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (i0 + 128 * u < 64 * nb) mine[i0 + 128 * u] = v[u];
      }
    }
    // A fragments of the thread's q rows (zeros past n), scaled and
    // rounded: k-step kk holds columns 16kk + 2t, + 1 (0: row r0, 1: row
    // r0 + 8) and 16kk + 8 + 2t, + 1 (2, 3). Up to D = 96 they are loaded
    // once and held; above, the registers are short and each tile's q k^T
    // loads them again (from L1), as the row route does its bias_w values
    // (from shared memory).
    constexpr bool kHold = D <= 96;
    const bf16* qb = a.q + b * a.x_b + h * a.x_h + 2 * t4;
    const int qa = q0 + r0;
    auto load_q = [&](uint32_t (&qf)[KS][4]) {
      const uint32_t* x0 =
          reinterpret_cast<const uint32_t*>(qb + (long)qa * a.x_r);
      const uint32_t* x1 =
          reinterpret_cast<const uint32_t*>(qb + (long)(qa + 8) * a.x_r);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qf[kk][0] = qa < n ? scale_bf16x2(__ldg(x0 + 8 * kk), a.scale) : 0u;
        qf[kk][1] =
            qa + 8 < n ? scale_bf16x2(__ldg(x1 + 8 * kk), a.scale) : 0u;
        qf[kk][2] =
            qa < n ? scale_bf16x2(__ldg(x0 + 8 * kk + 4), a.scale) : 0u;
        qf[kk][3] =
            qa + 8 < n ? scale_bf16x2(__ldg(x1 + 8 * kk + 4), a.scale) : 0u;
      }
    };
    uint32_t qf[KS][4];
    if constexpr (kHold) load_q(qf);
    cp_async_wait<0>();
    named_barrier(1 + wg, 128);  // the warpgroup's bias rows are in

    const bf16* b0 = bsm + r0 * nb;
    const bf16* b1 = b0 + 8 * nb;
    // kRowTile: bias_w * log2 e at the thread's columns, held as q is.
    float bw0[16], bw1[16];
    auto load_bias_w = [&]() {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int x = kh + 8 * (j >> 1) + 2 * t4 + (j & 1);
        bw0[j] = __bfloat162float(b0[x]) * kLog2e;
        bw1[j] = __bfloat162float(b1[x]) * kLog2e;
      }
    };
    if constexpr (kRowTile && kHold) load_bias_w();
    const uint32_t raddr = smem_addr(ring);

    // s = q k^T of the k tile in `stage` for the warpgroup's 64 rows
    // (issued, not waited for).
    float s[32];
    auto issue_scores = [&](int stage) {
      if constexpr (!kHold) load_q(qf);
      const uint32_t k = raddr + stage * 2 * kTile;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        WgmmaRS<64, 0>::run(
            s, qf[kk],
            kk < W / 16
                ? wgmma_desc(k + kk / 4 * kWideBox + kk % 4 * 32, 16, 1024,
                             kSwizzle128)
                : wgmma_desc(k + 128 * W + (kk - W / 16) * kNarrowBox, 16,
                             256, kSwizzle32),
            kk);
    };
    // s -> (s + bias) log2 e of key tile t, in place, but for a per-row
    // term returned in c0, c1 (kRowTile: bias_h of grid row t; else 0,
    // with keys past n at -inf).
    auto logits = [&](int t, float& c0, float& c1) {
      if constexpr (kRowTile) {
        if constexpr (!kHold) load_bias_w();
        c0 = __bfloat162float(b0[t]) * kLog2e;
        c1 = __bfloat162float(b1[t]) * kLog2e;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int e = 4 * (j >> 1) + (j & 1);
          s[e] = fmaf(s[e], kLog2e, bw0[j]);
          s[e + 2] = fmaf(s[e + 2], kLog2e, bw1[j]);
        }
      } else {
        c0 = c1 = 0.f;
        // Keys key, key + 1 of pair j at grid (y, x) and after; pair j + 1
        // is 8 keys on.
        int key = t * kFlashKeys + 2 * t4;
        int y = key / kw, x = key - y * kw;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j > 0) {
            key += 8, x += 8;
            while (x >= kw) x -= kw, ++y;
          }
          const bool wrap = x + 1 == kw;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ye = e && wrap ? y + 1 : y;
            const int xe = kh + (e ? (wrap ? 0 : x + 1) : x);
            float z0 = -INFINITY, z1 = -INFINITY;
            if (key + e < n) {
              z0 = fmaf(s[4 * j + e], kLog2e,
                        (__bfloat162float(b0[ye]) + __bfloat162float(b0[xe])) *
                            kLog2e);
              z1 = fmaf(s[4 * j + 2 + e], kLog2e,
                        (__bfloat162float(b1[ye]) + __bfloat162float(b1[xe])) *
                            kLog2e);
            }
            s[4 * j + e] = z0;
            s[4 * j + 2 + e] = z1;
          }
        }
      }
    };
    // Close the group of products just issued and wait for it.
    auto finish = [&]() {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    };

    // Pass 1: each thread's max and sum over its columns, rows r0 and
    // r0 + 8, in log2 units.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    int stage = 0, phase = 0;
    for (int t = 0; t < ntiles; ++t) {
      mbar_wait(full + stage, phase);
      wgmma_fence();
      issue_scores(stage);
      finish();
      if (lane == 0) mbar_arrive(empty + stage);
      float c0, c1;
      logits(t, c0, c1);
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (e & 2)
          x1 = fmaxf(x1, s[e]);
        else
          x0 = fmaxf(x0, s[e]);
      }
      const float n0 = fmaxf(m0, x0 + c0), n1 = fmaxf(m1, x1 + c1);
      // A thread that has seen only masked keys keeps (-inf, 0).
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float o0 = u0 - c0, o1 = u1 - c1;
      float e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (e & 2)
          e1 += fast_exp2(s[e] - o1);
        else
          e0 += fast_exp2(s[e] - o0);
      }
      l0 = l0 * fast_exp2(m0 - u0) + e0;
      l1 = l1 * fast_exp2(m1 - u1) + e1;
      m0 = n0, m1 = n1;
      if (++stage == stages) stage = 0, phase ^= 1;
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo0 = __shfl_xor_sync(0xffffffffu, m0, o);
      const float lo0 = __shfl_xor_sync(0xffffffffu, l0, o);
      const float mo1 = __shfl_xor_sync(0xffffffffu, m1, o);
      const float lo1 = __shfl_xor_sync(0xffffffffu, l1, o);
      merge_stats(m0, l0, mo0, lo0);
      merge_stats(m1, l1, mo1, lo1);
    }
    // p = 2^(z - m) / l = 2^(z - (m + log2 l)).
    const float g0 = m0 + __log2f(l0), g1 = m1 + __log2f(l1);

    // Pass 2: O = P V. Step t issues tile t - 1's P V, then tile t's
    // scores, and forms tile t's P.
    float ow[W ? W / 2 : 1], onr[R ? R / 2 : 1];  // O: the two column sets
    uint32_t pa[4][4];  // A fragments of k-steps over keys 16kk..16kk+15
    int prev = 0;       // stage of tile t - 1
    for (int t = 0; t <= ntiles; ++t) {
      if (t < ntiles) mbar_wait(full + stage, phase);
      wgmma_fence();
      if (t > 0) {
        const uint32_t v = raddr + prev * 2 * kTile + kTile;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (W > 0)
            WgmmaRS<W, 1>::run(
                ow, pa[kk],
                wgmma_desc(v + kk * 16 * 128, kWideBox, 1024, kSwizzle128),
                t > 1 || kk > 0);
          if constexpr (R > 0)
            WgmmaRS<R, 1>::run(onr, pa[kk],
                               wgmma_desc(v + 128 * W + kk * 16 * 32,
                                          kNarrowBox, 256, kSwizzle32),
                               t > 1 || kk > 0);
        }
      }
      if (t < ntiles) issue_scores(stage);
      finish();
      fence_regs(ow);
      fence_regs(onr);
      if (t > 0 && lane == 0) mbar_arrive(empty + prev);
      if (t == ntiles) break;
      float c0, c1;
      logits(t, c0, c1);
      c0 -= g0, c1 -= g1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* x = s + 8 * kk;
        pa[kk][0] = pack_bf16(fast_exp2(x[0] + c0), fast_exp2(x[1] + c0));
        pa[kk][1] = pack_bf16(fast_exp2(x[2] + c1), fast_exp2(x[3] + c1));
        pa[kk][2] = pack_bf16(fast_exp2(x[4] + c0), fast_exp2(x[5] + c0));
        pa[kk][3] = pack_bf16(fast_exp2(x[6] + c1), fast_exp2(x[7] + c1));
      }
      prev = stage;
      if (++stage == stages) stage = 0, phase ^= 1;
    }

    bf16* out = a.out + b * a.o_b + h * a.o_h + 2 * t4;
    // Columns col, col + 1 of rows qa and qa + 8.
    auto put = [&](int col, float x0, float x1, float y0, float y1) {
      if (qa < n)
        *reinterpret_cast<uint32_t*>(out + (long)qa * a.o_r + col) =
            pack_bf16(x0, x1);
      if (qa + 8 < n)
        *reinterpret_cast<uint32_t*>(out + (long)(qa + 8) * a.o_r + col) =
            pack_bf16(y0, y1);
    };
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      put(8 * j, ow[4 * j], ow[4 * j + 1], ow[4 * j + 2], ow[4 * j + 3]);
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
      put(W + 8 * j, onr[4 * j], onr[4 * j + 1], onr[4 * j + 2],
          onr[4 * j + 3]);
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

// cuTensorMapEncodeTiled from the driver, through the runtime: the
// library is not linked against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of one operand: boxes of `cols` columns x 1 head x 64 rows x 1,
// swizzled to match (64: 128 bytes; 16: 32), zeros outside the tensor.
static bool flash_map(CUtensorMap* map, const FlashOperand& x, int d, int n,
                      int batch, int cols) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)x.heads,
                              (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {2 * (cuuint64_t)x.head,
                                 2 * (cuuint64_t)x.row,
                                 2 * (cuuint64_t)x.batch};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)kFlashKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x.base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef void (*FlashKernel)(const FlashMaps, const RelposArgs,
                            const FlashHeads);

// The flash body's instance for head dim d and route, or null.
static FlashKernel flash_kernel(int d, bool row_tile) {
#define SAMPT_FLASH_CASE(D)                                   \
  case D:                                                     \
    return row_tile ? relpos_flash_kernel<D, true>            \
                    : relpos_flash_kernel<D, false>;
  switch (d) {
    SAMPT_FLASH_CASE(16)
    SAMPT_FLASH_CASE(32)
    SAMPT_FLASH_CASE(48)
    SAMPT_FLASH_CASE(64)
    SAMPT_FLASH_CASE(80)
    SAMPT_FLASH_CASE(96)
    SAMPT_FLASH_CASE(112)
    SAMPT_FLASH_CASE(128)
  }
#undef SAMPT_FLASH_CASE
  return nullptr;
}

// Its shared-memory limit.
static int flash_attributes(FlashKernel kernel, size_t bytes) {
  if (!kernel) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch_relpos_flash(const RelposArgs& a, const FlashOperand (&kv)[2],
                        int heads, int batch, cudaStream_t stream) {
  const int n = a.kh * a.kw;
  const FlashLayout L(a.d, a.kh + a.kw);
  const FlashKernel kernel = flash_kernel(a.d, a.kw == kFlashKeys);
  const int err = flash_attributes(kernel, L.total);
  if (err) return err;
  // The maps a head dim needs: 64-column boxes up to its last multiple
  // of 64, 16-column boxes past it.
  const int wide = a.d / 64 * 64;
  FlashMaps m = {};
  if ((wide > 0 && (!flash_map(&m.k_wide, kv[0], a.d, n, batch, 64) ||
                    !flash_map(&m.v_wide, kv[1], a.d, n, batch, 64))) ||
      (a.d > wide && (!flash_map(&m.k_narrow, kv[0], a.d, n, batch, 16) ||
                      !flash_map(&m.v_narrow, kv[1], a.d, n, batch, 16))))
    return (int)cudaErrorInvalidValue;
  const FlashHeads c = {kv[0].head0, kv[1].head0};
  const int rows = flash_rows(a.d);
  kernel<<<dim3((n + rows - 1) / rows, heads, batch), flash_threads(a.d),
           L.total, stream>>>(m, a, c);
  return (int)cudaGetLastError();
}

int relpos_flash_blocks_per_sm(int kh, int kw, int d) {
  const FlashLayout L(d, kh + kw);
  const FlashKernel kernel = flash_kernel(d, kw == kFlashKeys);
  int err = flash_attributes(kernel, L.total);
  int blocks = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, flash_threads(d), L.total);
  return err ? -err : blocks;
}

}  // namespace sampt
