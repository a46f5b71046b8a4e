// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a): fp32
// statistics per row; x, y, dy and dx in fp32, bf16 or fp16 (dtype codes 0,
// 1, 2 at the entry points).
//
// Forward. Replaces: apex_tpu/ops/layer_norm.py, _ln_fwd_pallas /
// _ln_fwd_kernel (the TPU kernel). For each row x of a [rows, hidden] input:
//   mu = mean(x); var = mean((x - mu)^2); rstd = rsqrt(var + eps)
//   y = (x - mu) * rstd * w + b          (y in x's dtype)
// and mu, rstd are written as [rows, 1] fp32. The variance is the centred
// two-pass form the TPU kernel uses, not E[x^2] - E[x]^2.
//
// What bounds it on the H100: device-memory bytes, one read of x and one
// write of y (about 8 flops per element against 8 bytes in fp32). At the
// serving shapes ([8, 1024] and [64, 1024] fp32) the whole call moves 64 KB
// to 512 KB, so its time is launch latency, not bandwidth.
//
// Design: one block per row, so a row's reductions never leave the SM
// (the TPU kernel held whole row blocks in VMEM; here a row of hidden
// <= 64k fp32 is re-read from L1/L2 for the second and third sweeps, which
// at these sizes costs less than staging it). Each sweep is a strided loop
// over the row (neighbouring threads read neighbouring elements) followed
// by a warp-shuffle then shared-memory block sum in fp32.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// Sum over the block; every thread gets the total.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kThreads / 32) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is reused by the next call
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mu, float* __restrict__ rstd,
                  int hidden, float eps) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  const float h = static_cast<float>(hidden);

  float s = 0.f;
  for (int c = threadIdx.x; c < hidden; c += kThreads) s += to_f32(xr[c]);
  const float mean = block_sum(s, red) / h;

  float v = 0.f;
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    const float d = to_f32(xr[c]) - mean;
    v += d * d;
  }
  const float r = rsqrtf(block_sum(v, red) / h + eps);

  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    store(yr + c, (to_f32(xr[c]) - mean) * r * w[c] + b[c]);
  }
  if (threadIdx.x == 0) {
    mu[row] = mean;
    rstd[row] = r;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller checks
// shapes, dtypes, devices and contiguity; w and b are fp32 [hidden].
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mu,
                                   void* rstd, int rows, int hidden,
                                   float eps, int x_dtype, int device,
                                   void* stream) {
  if (rows == 0) return 0;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* muf = static_cast<float*>(mu);
  float* rf = static_cast<float*>(rstd);
  if (x_dtype == 1) {
    ln_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf,
        static_cast<__nv_bfloat16*>(y), muf, rf, hidden, eps);
  } else if (x_dtype == 2) {
    ln_fwd_kernel<__half><<<rows, kThreads, 0, s>>>(
        static_cast<const __half*>(x), wf, bf, static_cast<__half*>(y), muf,
        rf, hidden, eps);
  } else {
    ln_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), wf, bf, static_cast<float*>(y), muf,
        rf, hidden, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// RMSNorm forward. Replaces: apex_tpu/ops/layer_norm.py, _rms_fwd_pallas /
// _rms_fwd_kernel. For each row x of a [rows, hidden] input:
//   rstd = rsqrt(mean(x^2) + eps);  y = (x * rstd) * w   (y in x's dtype)
// and rstd is written as [rows, 1] fp32 (RMSNorm subtracts no mean).
//
// What bounds it on the H100: bytes, one read of x and one write of y (about
// 4 flops per element). Design: the LayerNorm forward's, one block a row and
// one fewer sweep (no mean): the sum of squares, then y, the row re-read from
// L1/L2 (a row of hidden <= 64k fp32 is 256 KB at most).
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ y, float* __restrict__ rstd, int hidden,
                   float eps) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  float s = 0.f;
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    const float v = to_f32(xr[c]);
    s += v * v;
  }
  const float r =
      rsqrtf(block_sum(s, red) / static_cast<float>(hidden) + eps);
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    store(yr + c, (to_f32(xr[c]) * r) * w[c]);
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). w is fp32 [hidden]
// (ones for the non-affine norm); rstd fp32 [rows].
extern "C" int apex_rms_norm_fwd(const void* x, const void* w, void* y,
                                 void* rstd, int rows, int hidden, float eps,
                                 int x_dtype, int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* rf = static_cast<float*>(rstd);
  if (x_dtype == 1) {
    rms_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf,
        static_cast<__nv_bfloat16*>(y), rf, hidden, eps);
  } else if (x_dtype == 2) {
    rms_fwd_kernel<__half><<<rows, kThreads, 0, s>>>(
        static_cast<const __half*>(x), wf, static_cast<__half*>(y), rf,
        hidden, eps);
  } else {
    rms_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), wf, static_cast<float*>(y), rf, hidden,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward of both norms. Replaces: apex_tpu/ops/layer_norm.py,
// _ln_bwd_pallas / _ln_bwd_kernel and _rms_bwd_pallas / _rms_bwd_kernel.
// For each row, with wdy = w * dy and
//   LayerNorm: xhat = (x - mu) * rstd
//     dx = (wdy - xhat * mean(xhat * wdy) - mean(wdy)) * rstd   (dy's dtype)
//     dgamma = sum over rows of dy * xhat,  dbeta = sum over rows of dy
//   RMSNorm:   xhat = x * rstd
//     dx = (wdy - xhat * mean(xhat * wdy)) * rstd
//     dgamma = sum over rows of dy * xhat
// (fp32 parameter gradients). With x_is_xhat the x operand already is xhat,
// fp32, as the memory-efficient norms rebuild it from their output (the TPU
// kernels' x_is_xhat), and mu is not read.
//
// What bounds it on the H100: bytes — x and dy read, dx written (about 12
// flops per element against 12 bytes in fp32).
//
// Design: the TPU kernel summed dgamma/dbeta into one block revisited by
// every (sequential) grid step. GPU blocks run in no order, so that carry
// becomes two launches with no atomics and a fixed summation order: two
// runs on one card give the same bits. The host plans the first launch
// (apex_tpu_torch/ops/layer_norm.py, norm_bwd_plan) from rows, hidden and
// the card's SM count, and sizes the partial rows it writes:
// (1a) rows up to kTier columns, norm_bwd_team_kernel. A team of 1, 2, 4 or
//      8 warps takes a row; each lane owns NQ quads of 4 columns (quad k at
//      column (k * team lanes + lane) * 4), so the row stays in registers
//      between its two sums and is read from device memory once, a quad
//      as one 16-byte (fp32) or 8-byte (16-bit) load (element by element when
//      hidden % 4 != 0 or a buffer is not 16-byte aligned). A one-warp team
//      reduces with shuffles alone, a wider one with one named barrier a
//      row. A block of 8 warps walks a contiguous range of rows, its teams
//      taking every (8 / warps a row)-th row, and each lane keeps its
//      columns' dgamma/dbeta partials in registers across them; at the end
//      the teams add their partials in team order into the block's one
//      partial row. At the 345M's [8192, 1024] a team is 4 warps of 2
//      quads a lane (77 registers, so 3 blocks an SM: one wave of 391
//      blocks); a warp a row at 8 quads took 225 registers, one block an
//      SM, and ran 30 % slower (H100 80GB HBM3, 700 W).
// (1b) wider rows, norm_bwd_rows_kernel: a block per group of rows, a fused
//      two-value block sum per row (the row walked twice), each thread
//      keeping the partials of the columns it owns (c = tid + k * kThreads)
//      in shared memory while they fit in a block's (hidden up to ~29,000
//      for LayerNorm, ~58,000 for RMSNorm), else in the block's own partial
//      rows in device memory, read and written by their owning thread
//      alone, so any width runs;
// (2)  norm_bwd_cols_kernel: a block per 8 columns, so that even at hidden
//      1024 the pass spreads over 128 SMs; lane l of warp w reads column l %
//      8 of the partial rows 4 w + l / 8, then every 32nd, adding them in
//      turn (32-byte segments); the warp's four row groups are added by two
//      shuffles ((g0 + g1) + (g2 + g3)), then the warps in warp order.
namespace {

constexpr int kTier = 8192;    // widest row of the team kernel
constexpr int kTeamWarps = 8;  // warps of a team-kernel block
constexpr int kColWarps = 8;   // warps of a column-pass block
constexpr int kCols = 8;       // columns of a column-pass block

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const __half* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __half2 a = *reinterpret_cast<const __half2*>(&t.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&t.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<unsigned*>(&a);
  t.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}
__device__ __forceinline__ void store4(__half* p, const float v[4]) {
  __half2 a = __floats2half2_rn(v[0], v[1]);
  __half2 b = __floats2half2_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<unsigned*>(&a);
  t.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// The quad of `row` at column c: one vector load when `vec` (then hidden %
// 4 == 0, so a quad that starts inside the row ends inside it), else element
// by element; columns past the row read 0.
template <typename T>
__device__ __forceinline__ void load_quad(const T* row, int c, int hidden,
                                          bool vec, float v[4]) {
  if (vec) {
    if (c < hidden) {
      load4(row + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = c + e < hidden ? to_f32(row[c + e]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_quad(T* row, int c, int hidden,
                                           bool vec, const float v[4]) {
  if (vec) {
    if (c < hidden) store4(row + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < hidden) store(row + c + e, v[e]);
  }
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// kRms: RMSNorm (no mean, no dbeta). NQ: quads of 4 columns a lane (the
// plan guarantees hidden <= NQ * 128 * wpr, wpr warps a row).
template <typename TD, typename TX, bool kRms, int NQ>
__global__ void __launch_bounds__(kTeamWarps * 32)
    norm_bwd_team_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                         const float* __restrict__ mu,
                         const float* __restrict__ rstd,
                         const float* __restrict__ w, TD* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ db_part, int rows,
                         int rows_per_block, int hidden, int wpr,
                         int x_is_xhat, int vec) {
  // teams > 1: [hidden] dgamma (then [hidden] dbeta) of the block
  extern __shared__ float part[];
  __shared__ float red[2][kTeamWarps][2];  // double-buffered team sums
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int teams = kTeamWarps / wpr;
  const int team = warp / wpr;
  const int span = 32 * wpr;                // lanes of a team
  const int lt = (warp % wpr) * 32 + lane;  // lane within its team
  float wq[NQ][4], pg[NQ][4], pb[NQ][4];
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    load_quad(w, (k * span + lt) * 4, hidden, vec, wq[k]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pg[k][e] = 0.f;
      pb[k][e] = 0.f;
    }
  }
  const float h = static_cast<float>(hidden);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  int buf = 0;
  for (int r = r0 + team; r < r1; r += teams) {
    const long long off = static_cast<long long>(r) * hidden;
    float g[NQ][4], xh[NQ][4];
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int c = (k * span + lt) * 4;
      load_quad(dy + off, c, hidden, vec, g[k]);
      load_quad(x + off, c, hidden, vec, xh[k]);
    }
    const float m = (kRms || x_is_xhat) ? 0.f : mu[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!x_is_xhat) xh[k][e] = (xh[k][e] - m) * rs;
        const float wdy = g[k][e] * wq[k][e];  // 0 past the row
        s1 += xh[k][e] * wdy;
        s2 += wdy;
        pg[k][e] += g[k][e] * xh[k][e];  // columns owned by this lane alone
        if (!kRms) pb[k][e] += g[k][e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (wpr > 1) {  // the team's warps, added in warp order
      if (lane == 0) {
        red[buf][warp][0] = s1;
        red[buf][warp][1] = s2;
      }
      team_sync(1 + team, span);
      s1 = 0.f;
      s2 = 0.f;
      for (int i = 0; i < wpr; ++i) {
        s1 += red[buf][team * wpr + i][0];
        s2 += red[buf][team * wpr + i][1];
      }
      buf ^= 1;  // a warp writes this buffer again only after the next
                 // row's barrier, which its team reaches once all have read
    }
    const float c1 = s1 / h;
    const float c2 = kRms ? 0.f : s2 / h;
    TD* dxr = dx + off;
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = (g[k][e] * wq[k][e] - xh[k][e] * c1 - c2) * rs;
      store_quad(dxr, (k * span + lt) * 4, hidden, vec, o);
    }
  }
  // one partial row a block (a block that owns no row writes zeros)
  float* dwp = dw_part + static_cast<long long>(blockIdx.x) * hidden;
  float* dbp =
      kRms ? nullptr : db_part + static_cast<long long>(blockIdx.x) * hidden;
  if (teams == 1) {
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int c = (k * span + lt) * 4;
      store_quad(dwp, c, hidden, vec, pg[k]);
      if (!kRms) store_quad(dbp, c, hidden, vec, pb[k]);
    }
    return;
  }
  float* sg = part;
  float* sb = part + hidden;
  for (int t = 0; t < teams; ++t) {  // team order
    if (team == t) {
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (k * span + lt) * 4 + e;
          if (c < hidden) {
            sg[c] = t ? sg[c] + pg[k][e] : pg[k][e];
            if (!kRms) sb[c] = t ? sb[c] + pb[k][e] : pb[k][e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < hidden; c += blockDim.x) {
    dwp[c] = sg[c];
    if (!kRms) dbp[c] = sb[c];
  }
}

__device__ void block_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kThreads / 32 + warp] = b;
  }
  __syncthreads();
  a = lane < (kThreads / 32) ? red[lane] : 0.f;
  b = lane < (kThreads / 32) ? red[kThreads / 32 + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();
}

// Rows wider than kTier. kSmem: column partials in shared memory (else in
// the block's rows of dw_part / db_part).
template <typename TD, typename TX, bool kRms, bool kSmem>
__global__ void __launch_bounds__(kThreads)
    norm_bwd_rows_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                         const float* __restrict__ mu,
                         const float* __restrict__ rstd,
                         const float* __restrict__ w, TD* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ db_part, int rows,
                         int rows_per_block, int hidden, int x_is_xhat) {
  extern __shared__ float part[];  // [hidden] dgamma (then [hidden] dbeta)
  __shared__ float red[2 * (kThreads / 32)];
  const long long own = static_cast<long long>(blockIdx.x) * hidden;
  float* pw = kSmem ? part : dw_part + own;
  float* pb = kRms ? nullptr : (kSmem ? part + hidden : db_part + own);
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    pw[c] = 0.f;
    if (!kRms) pb[c] = 0.f;
  }
  const float h = static_cast<float>(hidden);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const TD* dyr = dy + static_cast<long long>(r) * hidden;
    const TX* xr = x + static_cast<long long>(r) * hidden;
    const float m = (kRms || x_is_xhat) ? 0.f : mu[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      const float g = to_f32(dyr[c]);
      const float xh = x_is_xhat ? to_f32(xr[c]) : (to_f32(xr[c]) - m) * rs;
      const float wdy = g * w[c];
      s1 += xh * wdy;
      s2 += wdy;
      pw[c] += g * xh;  // column c is owned by this thread alone
      if (!kRms) pb[c] += g;
    }
    block_sum2(s1, s2, red);
    const float c1 = s1 / h;
    const float c2 = kRms ? 0.f : s2 / h;
    TD* dxr = dx + static_cast<long long>(r) * hidden;
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      const float g = to_f32(dyr[c]);
      const float xh = x_is_xhat ? to_f32(xr[c]) : (to_f32(xr[c]) - m) * rs;
      store(dxr + c, (g * w[c] - xh * c1 - c2) * rs);
    }
  }
  if (kSmem) {
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      dw_part[own + c] = pw[c];
      if (!kRms) db_part[own + c] = pb[c];
    }
  }
}

// db_part / db null: dgamma only (RMSNorm).
__global__ void __launch_bounds__(kColWarps * 32)
    norm_bwd_cols_kernel(const float* __restrict__ dw_part,
                         const float* __restrict__ db_part,
                         float* __restrict__ dw, float* __restrict__ db,
                         int n_part, int hidden) {
  constexpr int kGroups = 32 / kCols;  // row groups of a warp
  __shared__ float red[2][kColWarps][kCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kCols + lane % kCols;
  float sw = 0.f, sb = 0.f;
  if (c < hidden) {
#pragma unroll 4
    for (int k = warp * kGroups + lane / kCols; k < n_part;
         k += kColWarps * kGroups) {
      sw += dw_part[static_cast<long long>(k) * hidden + c];
      if (db_part != nullptr)
        sb += db_part[static_cast<long long>(k) * hidden + c];
    }
  }
#pragma unroll
  for (int o = kCols; o < 32; o <<= 1) {
    sw += __shfl_xor_sync(0xffffffffu, sw, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
  if (lane < kCols) {
    red[0][warp][lane] = sw;
    red[1][warp][lane] = sb;
  }
  __syncthreads();
  if (warp == 0 && lane < kCols && c < hidden) {
    sw = 0.f;
    sb = 0.f;
#pragma unroll
    for (int i = 0; i < kColWarps; ++i) {
      sw += red[0][i][lane];
      sb += red[1][i][lane];
    }
    dw[c] = sw;
    if (db != nullptr) db[c] = sb;
  }
}

struct BwdArgs {
  const void* dy;
  const void* x;
  const float* mu;
  const float* rstd;
  const float* w;
  void* dx;
  float* dw_part;
  float* db_part;
  int rows, hidden, x_is_xhat;
  int n_part, rows_per_block, wpr, quads;  // the host's plan
};

template <typename TD, typename TX, bool kRms, int NQ>
cudaError_t launch_team(const BwdArgs& a, int vec, cudaStream_t s) {
  const int teams = kTeamWarps / a.wpr;
  // teams > 1 only while wpr <= 4, so hidden <= 4096: <= 32 KB
  const size_t smem =
      teams > 1 ? (kRms ? 1 : 2) * static_cast<size_t>(a.hidden) *
                      sizeof(float)
                : 0;
  norm_bwd_team_kernel<TD, TX, kRms, NQ>
      <<<a.n_part, kTeamWarps * 32, smem, s>>>(
          static_cast<const TD*>(a.dy), static_cast<const TX*>(a.x), a.mu,
          a.rstd, a.w, static_cast<TD*>(a.dx), a.dw_part, a.db_part, a.rows,
          a.rows_per_block, a.hidden, a.wpr, a.x_is_xhat, vec);
  return cudaGetLastError();
}

template <typename TD, typename TX, bool kRms, bool kSmem>
cudaError_t launch_rows(const BwdArgs& a, size_t smem, cudaStream_t s) {
  auto kern = norm_bwd_rows_kernel<TD, TX, kRms, kSmem>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<a.n_part, kThreads, smem, s>>>(
      static_cast<const TD*>(a.dy), static_cast<const TX*>(a.x), a.mu,
      a.rstd, a.w, static_cast<TD*>(a.dx), a.dw_part, a.db_part, a.rows,
      a.rows_per_block, a.hidden, a.x_is_xhat);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// The first launch for one dtype pair: the team kernel at its planned
// quads a lane, or (wpr == 0, rows wider than kTier) the rows kernel with
// shared-memory partials when they fit in the block's opt-in shared memory
// beside its static array, else device-memory partials.
template <typename TD, typename TX, bool kRms>
cudaError_t launch_by_plan(const BwdArgs& a, int device, cudaStream_t s) {
  if (a.wpr > 0) {
    const int vec = a.hidden % 4 == 0 && aligned16(a.dy) &&
                    aligned16(a.x) && aligned16(a.dx) && aligned16(a.w) &&
                    aligned16(a.dw_part) &&
                    (kRms || aligned16(a.db_part));
    switch (a.quads) {
      case 1: return launch_team<TD, TX, kRms, 1>(a, vec, s);
      case 2: return launch_team<TD, TX, kRms, 2>(a, vec, s);
      case 4: return launch_team<TD, TX, kRms, 4>(a, vec, s);
      case 8: return launch_team<TD, TX, kRms, 8>(a, vec, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const size_t smem =
      (kRms ? 1 : 2) * static_cast<size_t>(a.hidden) * sizeof(float);
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const size_t static_smem = 2 * (kThreads / 32) * sizeof(float);
  if (smem + static_smem <= static_cast<size_t>(optin))
    return launch_rows<TD, TX, kRms, true>(a, smem, s);
  return launch_rows<TD, TX, kRms, false>(a, 0, s);
}

// The plan covers every row once and fits the kernel it names.
bool plan_ok(const BwdArgs& a) {
  if (a.n_part < 1 || a.rows_per_block < 1 ||
      static_cast<long long>(a.n_part) * a.rows_per_block < a.rows)
    return false;
  if (a.wpr == 0) return a.hidden > kTier;
  const bool pow2 = a.wpr == 1 || a.wpr == 2 || a.wpr == 4 || a.wpr == 8;
  return pow2 && a.hidden <= kTier &&
         a.hidden <= a.quads * 128 * a.wpr;
}

template <bool kRms>
cudaError_t launch_norm_bwd(const BwdArgs& a, float* dw, float* db,
                            int dy_dtype, int x_dtype, int device,
                            cudaStream_t s) {
  if (!plan_ok(a)) return cudaErrorInvalidValue;
  cudaError_t e;
  // dy and x in one dtype, or either in fp32 (x is the fp32 x-hat of a
  // 16-bit dy in the memory-efficient backward); bf16 with fp16 is refused
  if (dy_dtype == 1 && x_dtype == 1) {
    e = launch_by_plan<__nv_bfloat16, __nv_bfloat16, kRms>(a, device, s);
  } else if (dy_dtype == 2 && x_dtype == 2) {
    e = launch_by_plan<__half, __half, kRms>(a, device, s);
  } else if (dy_dtype == 1 && x_dtype == 0) {
    e = launch_by_plan<__nv_bfloat16, float, kRms>(a, device, s);
  } else if (dy_dtype == 2 && x_dtype == 0) {
    e = launch_by_plan<__half, float, kRms>(a, device, s);
  } else if (dy_dtype == 0 && x_dtype == 1) {
    e = launch_by_plan<float, __nv_bfloat16, kRms>(a, device, s);
  } else if (dy_dtype == 0 && x_dtype == 2) {
    e = launch_by_plan<float, __half, kRms>(a, device, s);
  } else if (dy_dtype == 0 && x_dtype == 0) {
    e = launch_by_plan<float, float, kRms>(a, device, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  norm_bwd_cols_kernel<<<(a.hidden + kCols - 1) / kCols, kColWarps * 32, 0,
                         s>>>(
      a.dw_part, a.db_part, dw, db, a.n_part, a.hidden);
  return cudaGetLastError();
}

}  // namespace

// LayerNorm backward. Returns the cudaError_t of the launches (0 on
// success). dy and dx share a dtype (fp32, bf16 or fp16); x is in dy's
// dtype, or either is fp32 (xhat itself when x_is_xhat, then mu is not
// read); mu, rstd [rows] and w [hidden] fp32; dw, db [hidden] fp32; dw_part, db_part [n_part, hidden]
// fp32 scratch. The plan (n_part blocks of rows_per_block rows, warps_per_row
// warps of quads quads of 4 columns a lane; warps_per_row 0 for rows wider
// than 8192) is the host's norm_bwd_plan. Any hidden.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mu, const void* rstd,
                                   const void* w, void* dx, void* dw_part,
                                   void* db_part, void* dw, void* db,
                                   int rows, int hidden, int dy_dtype,
                                   int x_dtype, int x_is_xhat, int n_part,
                                   int rows_per_block, int warps_per_row,
                                   int quads, int device, void* stream) {
  if (rows == 0 || hidden == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BwdArgs a{dy, x, static_cast<const float*>(mu),
                  static_cast<const float*>(rstd),
                  static_cast<const float*>(w), dx,
                  static_cast<float*>(dw_part), static_cast<float*>(db_part),
                  rows, hidden, x_is_xhat, n_part, rows_per_block,
                  warps_per_row, quads};
  return static_cast<int>(launch_norm_bwd<false>(
      a, static_cast<float*>(dw), static_cast<float*>(db), dy_dtype,
      x_dtype, device, static_cast<cudaStream_t>(stream)));
}

// RMSNorm backward, as apex_layer_norm_bwd without mu, db_part and db.
extern "C" int apex_rms_norm_bwd(const void* dy, const void* x,
                                 const void* rstd, const void* w, void* dx,
                                 void* dw_part, void* dw, int rows,
                                 int hidden, int dy_dtype, int x_dtype,
                                 int x_is_xhat, int n_part,
                                 int rows_per_block, int warps_per_row,
                                 int quads, int device, void* stream) {
  if (rows == 0 || hidden == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BwdArgs a{dy, x, nullptr, static_cast<const float*>(rstd),
                  static_cast<const float*>(w), dx,
                  static_cast<float*>(dw_part), nullptr, rows, hidden,
                  x_is_xhat, n_part, rows_per_block, warps_per_row, quads};
  return static_cast<int>(launch_norm_bwd<true>(
      a, static_cast<float*>(dw), nullptr, dy_dtype, x_dtype, device,
      static_cast<cudaStream_t>(stream)));
}
