// K5: LayerNorm over the last axis of narrow rows (C <= 256 channels), with
// an optional exact GELU after it, for bfloat16 or float32.
//
// Replaces no TPU kernel. The JAX package's `ops/fast_ln.py` computes its
// statistics on the TPU's matrix unit, a trick for that machine that the
// port does not carry over; the port ran these norms through PyTorch's
// LayerNorm kernel, which gives each row a thread block of its own. SAM's
// decode chain normalises many narrow rows a pass (48 pairs x 128 x 128 rows
// of 64 after the upscaling's first conv, 48 x 256 x 256 of 64 in HQ-SAM's
// `embedding_maskfeature`, 48 x 4096 of 256 in `norm4`, rows of 4 and 16 in
// the prompt encoder's mask path), where most of such a block's threads
// idle and the time is a fixed cost a row.
//
// Computes, per row x[0:C] (the same rounding points as PyTorch's
// `F.gelu(F.layer_norm(x))` on the card):
//   mean = sum(x) / C,   var = sum((x - mean)^2) / C    (float32)
//   y    = gamma * (rsqrt(var + eps) * (x - mean)) + beta   (float32)
//   out  = T(y), or with `gelu`: z = float(T(y)),
//          out = T(z/2 (1 + erf(z/sqrt2)))
// with gamma and beta already in the input's type T.
//
// What bounds it on the H100: bytes. It reads the rows once and writes
// them once, 2 x rows x C x sizeof(T) (0.8 GB at 48 x 256 x 256 x 64 in
// bf16, 0.24 ms at 3.35 TB/s). The arithmetic, about 30 float32
// operations a value with the GELU's erf, comes close to that on the CUDA
// cores: measured, 69% of the bound with the GELU, 80-85% without
// (PERF.md). Design: a row gets the C / 8 lanes of a warp that hold it as one
// 16-byte vector each (bf16; 4 values a lane for float32, an 8-byte vector
// for bf16 rows of 4), so a warp holds 32 / (lanes a row) rows at once:
// 4 rows of 64, 1 of 256, 16 of 16, 32 of 4. The warp's rows are
// neighbours, so each load instruction reads one contiguous run. The row's
// sums are xor-shuffles inside its lanes (the mean first, then the centred
// sum of squares over the same registers): no shared memory and no
// barrier. gamma and beta stay in registers for the whole launch. Each
// warp walks a grid-stride loop over tiles of rows and loads several rows
// a lane before it reduces any, so that enough bytes are in flight to
// cover the memory's latency; the grid is one wave of resident blocks.
// A strided input (the NHWC view of an NCHW convolution output, as the
// mask path's convs give), or a row width that is not a power of two, is
// read through its strides, a value at a time; the output is contiguous.

#include "common.cuh"

namespace sampt {

constexpr int LN_MAX_C = 256;
constexpr int LN_WARPS = 8;  // a block of 256 threads
// At most 64 registers a thread, so that 4 blocks (32 warps) share an SM:
// more rows in flight than 3 blocks of 80 registers gave (measured,
// PERF.md).
constexpr int LN_MIN_BLOCKS = 4;

// Row r of the leading grid [n, h, w] starts at n*s_n + h*s_h + w*s_w
// elements from x; its channel c is c*s_c further.
struct LnArgs {
  const void* x;
  const void* gamma;
  const void* beta;
  void* out;
  int rows, c, h, w;
  long long s_n, s_h, s_w, s_c;
  float eps;
  int gelu;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Lanes a row of up to CMAX values takes: one 16-byte vector a lane, at
// least one lane and at most a warp.
template <typename T, int CMAX>
struct LnShape {
  static constexpr int G = (CMAX * (int)sizeof(T) / 16 < 1) ? 1
                           : (CMAX * (int)sizeof(T) / 16 > 32)
                               ? 32
                               : CMAX * (int)sizeof(T) / 16;
  static constexpr int V = CMAX / G;                  // values a lane
  static constexpr int R = 32 / G;                    // rows a warp
  static constexpr int VB = (V * (int)sizeof(T) < 16) ? V * (int)sizeof(T)
                                                      : 16;  // vector bytes
  static constexpr int E = VB / (int)sizeof(T);       // values a vector
  static constexpr int NV = V / E;                    // vectors a lane
  // Rows a lane loads before it reduces: 64 bytes a lane in flight.
  static constexpr int U = (64 / (V * (int)sizeof(T)) < 1)
                               ? 1
                               : 64 / (V * (int)sizeof(T));
};

template <int BYTES>
struct VecOf;
template <>
struct VecOf<8> {
  typedef uint2 type;
};
template <>
struct VecOf<16> {
  typedef uint4 type;
};

__device__ __forceinline__ float gelu_erf(float z) {
  return z * 0.5f * (1.0f + erff(z * 0.70710678118654752440f));
}

// FAST: C == CMAX and the rows are channel-contiguous and aligned to a
// lane's vector: vector loads and stores, no value masked, C known at
// compile time. Otherwise a value at a time through the strides, the
// channels past C masked.
template <typename T, int CMAX, bool FAST>
__global__ void __launch_bounds__(LN_WARPS * 32, LN_MIN_BLOCKS)
    layer_norm_kernel(const LnArgs a) {
  typedef LnShape<T, CMAX> S;
  typedef typename VecOf<S::VB>::type Vec;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int lane = threadIdx.x & 31;
  const int c0 = (lane % S::G) * S::V;  // this lane's first channel
  const int slot = lane / S::G;         // its row within the warp's R
  const int cols = FAST ? CMAX : a.c;
  const float inv_c = 1.0f / (float)cols;

  float g[S::V], b[S::V];
#pragma unroll
  for (int j = 0; j < S::V; ++j) {
    const int c = c0 + j;
    g[j] = c < cols ? to_float(static_cast<const T*>(a.gamma)[c]) : 0.f;
    b[j] = c < cols ? to_float(static_cast<const T*>(a.beta)[c]) : 0.f;
  }

  const int tile_rows = S::R * S::U;
  const int tiles = (a.rows + tile_rows - 1) / tile_rows;
  const int warps = gridDim.x * LN_WARPS;
  for (int t = blockIdx.x * LN_WARPS + threadIdx.x / 32; t < tiles;
       t += warps) {
    float v[S::U][S::V];
    int row[S::U];
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      // The warp's R slots take neighbouring rows.
      row[u] = t * tile_rows + u * S::R + slot;
      const bool live = row[u] < a.rows;
      long long off = 0;
      if (a.w >= a.rows) {  // one run of rows
        off = (long long)row[u] * a.s_w;
      } else {
        const int wi = row[u] % a.w, hn = row[u] / a.w;
        off = (long long)(hn / a.h) * a.s_n + (long long)(hn % a.h) * a.s_h +
              (long long)wi * a.s_w;
      }
      if (FAST) {
#pragma unroll
        for (int k = 0; k < S::NV; ++k) {
          Vec raw = {};
          if (live)
            raw = *reinterpret_cast<const Vec*>(x + off + c0 + k * S::E);
          const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < S::E; ++e)
            v[u][k * S::E + e] = to_float(vals[e]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < S::V; ++j) {
          const int c = c0 + j;
          v[u][j] = (live && c < cols) ? to_float(x[off + c * a.s_c]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < S::V; ++j) s += v[u][j];
#pragma unroll
      for (int o = S::G / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mean = s * inv_c;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < S::V; ++j) {
        const float d = (c0 + j < cols) ? v[u][j] - mean : 0.f;
        v[u][j] = d;
        q += d * d;
      }
#pragma unroll
      for (int o = S::G / 2; o > 0; o >>= 1)
        q += __shfl_xor_sync(0xffffffffu, q, o);
      const float rstd = rsqrtf(q * inv_c + a.eps);
      if (row[u] >= a.rows) continue;
      Vec packed[S::NV];  // the lane's outputs, aligned for vector stores
      T* y = reinterpret_cast<T*>(packed);
#pragma unroll
      for (int j = 0; j < S::V; ++j) {
        float z = g[j] * (rstd * v[u][j]) + b[j];
        if (a.gelu) z = gelu_erf(to_float(from_float<T>(z)));
        y[j] = from_float<T>(z);
      }
      T* dst = out + (long long)row[u] * cols + c0;
      if (FAST) {
#pragma unroll
        for (int k = 0; k < S::NV; ++k)
          *reinterpret_cast<Vec*>(dst + k * S::E) = packed[k];
      } else {
#pragma unroll
        for (int j = 0; j < S::V; ++j)
          if (c0 + j < cols) dst[j] = y[j];
      }
    }
  }
}

template <typename T, int CMAX>
int launch_layer_norm(const LnArgs& a, cudaStream_t stream) {
  typedef LnShape<T, CMAX> S;
  static_assert(S::VB == 8 || S::VB == 16, "a lane's vector is 8 or 16 bytes");
  static_assert(S::G * S::V == CMAX && S::NV * S::E == S::V, "lane layout");
  const bool fast =
      a.c == CMAX && a.s_c == 1 && a.s_n % S::E == 0 && a.s_h % S::E == 0 &&
      a.s_w % S::E == 0 &&
      (reinterpret_cast<unsigned long long>(a.x) % S::VB) == 0 &&
      (reinterpret_cast<unsigned long long>(a.out) % S::VB) == 0;
  void (*kernel)(LnArgs) = fast ? &layer_norm_kernel<T, CMAX, true>
                                : &layer_norm_kernel<T, CMAX, false>;
  // One wave of resident blocks, asked once an instance.
  static int slots[2] = {0, 0};
  int& resident = slots[fast];
  if (!resident) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, LN_WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles =
      ((long long)a.rows + S::R * S::U - 1) / (S::R * S::U);
  const long long blocks = (tiles + LN_WARPS - 1) / LN_WARPS;
  const int grid = (int)(blocks < resident ? blocks : resident);
  kernel<<<grid, LN_WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_layer_norm(const LnArgs& a, cudaStream_t s) {
  if (a.c <= 4) return launch_layer_norm<T, 4>(a, s);
  if (a.c <= 8) return launch_layer_norm<T, 8>(a, s);
  if (a.c <= 16) return launch_layer_norm<T, 16>(a, s);
  if (a.c <= 32) return launch_layer_norm<T, 32>(a, s);
  if (a.c <= 64) return launch_layer_norm<T, 64>(a, s);
  if (a.c <= 128) return launch_layer_norm<T, 128>(a, s);
  return launch_layer_norm<T, 256>(a, s);
}

}  // namespace sampt

// x: `rows` rows (at most 2^30) of c values (1 <= c <= 256) of type
// `dtype` (0 float32, 1 bfloat16), row r = (n, i, j) of the leading grid
// [rows / (h w), h, w] at n*s_n + i*s_h + j*s_w elements and channel k at
// k*s_c more; gamma and beta [c] contiguous, of the same type; out
// [rows, c] contiguous. `gelu` nonzero applies the exact GELU after the
// norm's rounding. Returns a cudaError_t.
extern "C" int sam_layer_norm(const void* x, const void* gamma,
                              const void* beta, void* out, int rows, int c,
                              int h, int w, long long s_n, long long s_h,
                              long long s_w, long long s_c, float eps,
                              int gelu, int dtype, void* stream) {
  if (c < 1 || c > sampt::LN_MAX_C || rows < 1 || rows > (1 << 30) ||
      h < 1 || w < 1 || (long long)rows % ((long long)h * w) != 0)
    return (int)cudaErrorInvalidValue;
  const sampt::LnArgs a = {x, gamma, beta, out, rows, c, h, w,
                           s_n, s_h, s_w, s_c, eps, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return sampt::dispatch_layer_norm<float>(a, s);
  if (dtype == 1) return sampt::dispatch_layer_norm<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
