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
// RMSNorm forward. Replaces: apex_tpu/ops/layer_norm.py, _rms_fwd_pallas /
// _rms_fwd_kernel. For each row:
//   rstd = rsqrt(mean(x^2) + eps);  y = (x * rstd) * w   (y in x's dtype)
// and rstd is written as [rows, 1] fp32 (RMSNorm subtracts no mean).
//
// What bounds both on the H100: device-memory bytes, one read of x and one
// write of y (about 8 flops per element against 4 to 8 bytes). The fp32
// parameters are [hidden], read once per block. At the serving shapes
// ([8, 1024] and [64, 1024] fp32) a call moves 64 KB to 512 KB, so its time
// is launch latency, not bandwidth.
//
// Design (the backward's team template below, without its column pass). The
// host plans the launch (apex_tpu_torch/ops/layer_norm.py, norm_fwd_plan)
// from rows, hidden, the SM count, the element size and the norm:
// (1) rows up to kFwdTier columns: ln_fwd_team_kernel / rms_fwd_team_kernel.
//     A team of 1, 2, 4 or 8 warps takes a row; each lane owns NV vectors of
//     16 bytes (8 columns in bf16 / fp16, 4 in fp32; vector k at column
//     (k * team lanes + lane) * elements), so the row is read from device
//     memory once, 16 bytes a lane a load, and stays in registers between
//     its sums (element by element when hidden is not a whole number of
//     vectors or a pointer is not 16-byte aligned). The block stages w (and
//     b) in shared memory once, while its first rows' loads are in flight,
//     for every row it walks: held in registers beside the row they took
//     191 registers a thread at 32 bf16 columns a lane (one block an SM),
//     in shared memory 127. Sums by shuffles; a team wider than a warp adds
//     its warps' sums in warp order after a named barrier (one a
//     statistic). A block of 8 warps walks a contiguous range of rows, its
//     teams taking every (8 / warps a row)-th row; the grid is one wave, as
//     many blocks an SM as the norm's kernel's registers let stay
//     resident. One lane a team writes mu, rstd. At the 345M's [8192, 1024]
//     a warp takes a row, 32 columns a lane, 2 blocks an SM (RMSNorm 3);
//     issuing the next row's loads before the current row's sums measured
//     no faster and was dropped (H100 80GB HBM3, 700 W).
// (2) wider rows, a block of kWideThreads a row: ln_fwd_wide_kernel /
//     rms_fwd_wide_kernel stage the row in dynamic shared memory (16-byte
//     loads) where it fits in the block's opt-in shared memory (up to
//     ~56,000 fp32 columns, ~112,000 in 16 bits), so x is read from device
//     memory once (at [1024, 32768] 1.4-1.8x faster than the sweeps below,
//     H100 80GB HBM3, 700 W; tools/torch_kernel_ab.py); past that
//     ln_fwd_kernel / rms_fwd_kernel sweep the row two or three times (the
//     later sweeps from L1/L2), so any width runs.
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

// Sum over a block of kT threads; every thread gets the total.
template <int kT = kThreads>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (kT / 32) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is reused by the next call
  return v;
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// 16 bytes of T as floats and back (round to nearest even).
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& r, float v[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float v[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& r, float v[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float v[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};
template <>
struct Vec16<__half> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& r, float v[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float v[8]) {
    uint4 r;
    __half2* h = reinterpret_cast<__half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

// The E columns of `row` from column c as 16 raw bytes: one load when `vec`
// (then hidden % E == 0, so a vector that starts inside the row ends inside
// it), else element by element; columns past the row read 0.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* row, int c, int hidden,
                                          bool vec) {
  constexpr int E = Vec16<T>::E;
  if (vec) {
    return c < hidden ? *reinterpret_cast<const uint4*>(row + c)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (c + i < hidden) e[i] = row[c + i];
  return r;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* row, int c, int hidden, bool vec,
                                          const float v[]) {
  constexpr int E = Vec16<T>::E;
  if (vec) {
    if (c < hidden) *reinterpret_cast<uint4*>(row + c) = Vec16<T>::pack(v);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (c + i < hidden) store(row + c + i, v[i]);
  }
}

// E floats from p, 16-byte aligned, as 16-byte loads.
template <int E>
__device__ __forceinline__ void load_floats(const float* p, float v[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x;
    v[i + 1] = t.y;
    v[i + 2] = t.z;
    v[i + 3] = t.w;
  }
}

constexpr int kFwdTier = 8192;    // widest row of the team kernels
constexpr int kFwdWarps = 8;      // warps of a team-kernel block
constexpr int kLaneCols = 32;     // columns a lane holds at most
constexpr int kWideThreads = 512; // threads of a block-a-row kernel

// A team's sum, in every lane: shuffles, then (wpr > 1) the team's warps in
// warp order through `red`, double-buffered: a warp writes a buffer again
// only after the next barrier, which its team reaches once all have read.
__device__ __forceinline__ float team_sum(float v, float (*red)[kFwdWarps],
                                          int& buf, int wpr, int team) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (wpr > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[buf][warp] = v;
    team_sync(1 + team, 32 * wpr);
    v = 0.f;
    for (int i = 0; i < wpr; ++i) v += red[buf][team * wpr + i];
    buf ^= 1;
  }
  return v;
}

// kRms: RMSNorm (no mean, no b, no mu). NV: vectors of 16 bytes a lane (the
// plan guarantees hidden <= NV * E * 32 * wpr, wpr warps a row).
template <typename T, bool kRms, int NV>
__device__ __forceinline__ void norm_fwd_team(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu,
    float* __restrict__ rstd, int rows, int rows_per_block, int hidden,
    int wpr, float eps, bool vec) {
  constexpr int E = Vec16<T>::E;
  // the block's parameters, [cols] w then [cols] b, zero past the row
  extern __shared__ float4 params[];
  __shared__ float red[2][kFwdWarps];
  const int warp = threadIdx.x >> 5;
  const int teams = kFwdWarps / wpr;
  const int team = warp / wpr;
  const int span = 32 * wpr;                              // lanes of a team
  const int lt = (warp % wpr) * 32 + (threadIdx.x & 31);  // lane in team
  const float h = static_cast<float>(hidden);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  // the first row's loads go out before the parameters are staged
  int r = r0 + team;
  uint4 xr[NV];
  if (r < r1) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      xr[k] = load_vec(x + static_cast<long long>(r) * hidden,
                       (k * span + lt) * E, hidden, vec);
  }
  const int cols = (hidden + E - 1) / E * E;
  float* sw = reinterpret_cast<float*>(params);
  float* sb = sw + cols;
  for (int c = threadIdx.x; c < cols; c += kFwdWarps * 32) {
    sw[c] = c < hidden ? w[c] : 0.f;
    if (!kRms) sb[c] = c < hidden ? b[c] : 0.f;
  }
  __syncthreads();
  int buf = 0;
  for (; r < r1; r += teams) {
    const long long off = static_cast<long long>(r) * hidden;
    if (r != r0 + team) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        xr[k] = load_vec(x + off, (k * span + lt) * E, hidden, vec);
    }
    float m = 0.f;
    if (!kRms) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        float v[E];
        Vec16<T>::unpack(xr[k], v);
#pragma unroll
        for (int e = 0; e < E; ++e) s += v[e];  // 0 past the row
      }
      m = team_sum(s, red, buf, wpr, team) / h;
    }
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * span + lt) * E;
      float v[E];
      Vec16<T>::unpack(xr[k], v);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[e] - m;
        if (kRms || c + e < hidden) q += d * d;
      }
    }
    const float rs = rsqrtf(team_sum(q, red, buf, wpr, team) / h + eps);
    T* yr = y + off;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * span + lt) * E;
      if (c >= hidden) continue;  // the vector lies past the row
      float v[E], wv[E], bv[E];
      Vec16<T>::unpack(xr[k], v);
      load_floats<E>(sw + c, wv);
      if (!kRms) load_floats<E>(sb + c, bv);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = kRms ? (v[e] * rs) * wv[e] : (v[e] - m) * rs * wv[e] + bv[e];
      store_vec(yr, c, hidden, vec, v);
    }
    if (lt == 0) {
      if (!kRms) mu[r] = m;
      rstd[r] = rs;
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kFwdWarps * 32)
    ln_fwd_team_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y,
                       float* __restrict__ mu, float* __restrict__ rstd,
                       int rows, int rows_per_block, int hidden, int wpr,
                       float eps, int vec) {
  norm_fwd_team<T, false, NV>(x, w, b, y, mu, rstd, rows, rows_per_block,
                              hidden, wpr, eps, vec);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kFwdWarps * 32)
    rms_fwd_team_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd,
                        int rows, int rows_per_block, int hidden, int wpr,
                        float eps, int vec) {
  norm_fwd_team<T, true, NV>(x, w, nullptr, y, nullptr, rstd, rows,
                             rows_per_block, hidden, wpr, eps, vec);
}

// A block of kWideThreads a row, the row staged in dynamic shared memory in
// x's dtype: one read of x from device memory, the later sweeps from shared
// memory. Thread i owns vectors i, i + kWideThreads, ... (columns i, ... when
// not `vec`) in every sweep, so a thread reads back only what it staged.
template <typename T, bool kRms>
__device__ __forceinline__ void norm_fwd_wide(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu,
    float* __restrict__ rstd, int hidden, float eps, bool vec) {
  constexpr int E = Vec16<T>::E;
  extern __shared__ uint4 stage[];  // the row
  __shared__ float red[kWideThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  T* st = reinterpret_cast<T*>(stage);
  const int nvec = (hidden + E - 1) / E;
  const float h = static_cast<float>(hidden);
  float s = 0.f;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < nvec; i += kWideThreads) {
      const uint4 r = *reinterpret_cast<const uint4*>(xr + i * E);
      stage[i] = r;
      float v[E];
      Vec16<T>::unpack(r, v);
#pragma unroll
      for (int e = 0; e < E; ++e) s += kRms ? v[e] * v[e] : v[e];
    }
  } else {
    for (int c = threadIdx.x; c < hidden; c += kWideThreads) {
      const T t = xr[c];
      st[c] = t;
      const float v = to_f32(t);
      s += kRms ? v * v : v;
    }
  }
  float m = 0.f, rs;
  if (kRms) {
    rs = rsqrtf(block_sum<kWideThreads>(s, red) / h + eps);
  } else {
    m = block_sum<kWideThreads>(s, red) / h;
    float q = 0.f;
    if (vec) {
      for (int i = threadIdx.x; i < nvec; i += kWideThreads) {
        float v[E];
        Vec16<T>::unpack(stage[i], v);
#pragma unroll
        for (int e = 0; e < E; ++e) q += (v[e] - m) * (v[e] - m);
      }
    } else {
      for (int c = threadIdx.x; c < hidden; c += kWideThreads) {
        const float d = to_f32(st[c]) - m;
        q += d * d;
      }
    }
    rs = rsqrtf(block_sum<kWideThreads>(q, red) / h + eps);
  }
  if (vec) {
    for (int i = threadIdx.x; i < nvec; i += kWideThreads) {
      float v[E], wv[E], bv[E];
      Vec16<T>::unpack(stage[i], v);
      load_floats<E>(w + i * E, wv);
      if (!kRms) load_floats<E>(b + i * E, bv);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = kRms ? (v[e] * rs) * wv[e] : (v[e] - m) * rs * wv[e] + bv[e];
      *reinterpret_cast<uint4*>(yr + i * E) = Vec16<T>::pack(v);
    }
  } else {
    for (int c = threadIdx.x; c < hidden; c += kWideThreads) {
      const float v = to_f32(st[c]);
      store(yr + c, kRms ? (v * rs) * w[c] : (v - m) * rs * w[c] + b[c]);
    }
  }
  if (threadIdx.x == 0) {
    if (!kRms) mu[row] = m;
    rstd[row] = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    ln_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y,
                       float* __restrict__ mu, float* __restrict__ rstd,
                       int hidden, float eps, int vec) {
  norm_fwd_wide<T, false>(x, w, b, y, mu, rstd, hidden, eps, vec);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    rms_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ rstd,
                        int hidden, float eps, int vec) {
  norm_fwd_wide<T, true>(x, w, nullptr, y, nullptr, rstd, hidden, eps, vec);
}

// Rows past the opt-in shared memory: a block of kThreads a row, the row
// swept three times (LayerNorm) or twice (RMSNorm), the later sweeps from
// L1/L2 (a row of hidden <= 64k fp32 is 256 KB at most).
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

struct FwdArgs {
  const void* x;
  const float* w;
  const float* b;  // null: RMSNorm
  void* y;
  float* mu;       // null: RMSNorm
  float* rstd;
  int rows, hidden;
  float eps;
  int blocks, rows_per_block, wpr, vecs;  // the host's plan
};

template <typename T, bool kRms, int NV>
cudaError_t launch_fwd_team(const FwdArgs& a, int vec, cudaStream_t s) {
  if constexpr (NV * Vec16<T>::E > kLaneCols) {
    return cudaErrorInvalidValue;
  } else {
    const T* x = static_cast<const T*>(a.x);
    T* y = static_cast<T*>(a.y);
    constexpr int E = Vec16<T>::E;
    // at most 2 * kFwdTier fp32: 64 KB, past the 48 KB default
    const size_t smem = (kRms ? 1 : 2) *
                        static_cast<size_t>((a.hidden + E - 1) / E * E) *
                        sizeof(float);
    auto kern = kRms ? reinterpret_cast<const void*>(
                           rms_fwd_team_kernel<T, NV>)
                     : reinterpret_cast<const void*>(
                           ln_fwd_team_kernel<T, NV>);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    if (kRms) {
      rms_fwd_team_kernel<T, NV><<<a.blocks, kFwdWarps * 32, smem, s>>>(
          x, a.w, y, a.rstd, a.rows, a.rows_per_block, a.hidden, a.wpr,
          a.eps, vec);
    } else {
      ln_fwd_team_kernel<T, NV><<<a.blocks, kFwdWarps * 32, smem, s>>>(
          x, a.w, a.b, y, a.mu, a.rstd, a.rows, a.rows_per_block, a.hidden,
          a.wpr, a.eps, vec);
    }
    return cudaGetLastError();
  }
}

// One dtype: the team kernel at its planned vectors a lane, or (wpr == 0) a
// block a row, staged in shared memory when the row fits in the block's
// opt-in shared memory beside its static array, else swept from L1/L2.
template <typename T, bool kRms>
cudaError_t launch_fwd_by_plan(const FwdArgs& a, int device, cudaStream_t s) {
  constexpr int E = Vec16<T>::E;
  const int vec = a.hidden % E == 0 && aligned16(a.x) && aligned16(a.y) &&
                  aligned16(a.w) && (kRms || aligned16(a.b));
  if (a.wpr > 0) {
    switch (a.vecs) {
      case 1: return launch_fwd_team<T, kRms, 1>(a, vec, s);
      case 2: return launch_fwd_team<T, kRms, 2>(a, vec, s);
      case 4: return launch_fwd_team<T, kRms, 4>(a, vec, s);
      case 8: return launch_fwd_team<T, kRms, 8>(a, vec, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const size_t smem = static_cast<size_t>((a.hidden + E - 1) / E) * 16;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const size_t static_smem = (kWideThreads / 32) * sizeof(float);
  if (smem + static_smem <= static_cast<size_t>(optin)) {
    auto kern = kRms ? reinterpret_cast<const void*>(rms_fwd_wide_kernel<T>)
                     : reinterpret_cast<const void*>(ln_fwd_wide_kernel<T>);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    if (kRms) {
      rms_fwd_wide_kernel<T><<<a.rows, kWideThreads, smem, s>>>(
          x, a.w, y, a.rstd, a.hidden, a.eps, vec);
    } else {
      ln_fwd_wide_kernel<T><<<a.rows, kWideThreads, smem, s>>>(
          x, a.w, a.b, y, a.mu, a.rstd, a.hidden, a.eps, vec);
    }
  } else if (kRms) {
    rms_fwd_kernel<T><<<a.rows, kThreads, 0, s>>>(x, a.w, y, a.rstd,
                                                 a.hidden, a.eps);
  } else {
    ln_fwd_kernel<T><<<a.rows, kThreads, 0, s>>>(x, a.w, a.b, y, a.mu,
                                                a.rstd, a.hidden, a.eps);
  }
  return cudaGetLastError();
}

// The plan covers every row once and fits the kernel it names: a team's
// lanes cover the row with at most kLaneCols columns each, or (wpr == 0)
// one row a block.
bool fwd_plan_ok(const FwdArgs& a, int elems) {
  if (a.blocks < 1 || a.rows_per_block < 1 ||
      static_cast<long long>(a.blocks) * a.rows_per_block < a.rows)
    return false;
  if (a.wpr == 0) return a.rows_per_block == 1 && a.blocks == a.rows;
  const bool pow2 = a.wpr == 1 || a.wpr == 2 || a.wpr == 4 || a.wpr == 8;
  return pow2 && a.hidden <= kFwdTier && a.vecs * elems <= kLaneCols &&
         a.hidden <= a.vecs * elems * 32 * a.wpr;
}

template <bool kRms>
int launch_norm_fwd(const FwdArgs& a, int x_dtype, int device, void* stream) {
  if (a.rows == 0) return 0;
  if (!fwd_plan_ok(a, x_dtype == 0 ? 4 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) {
    e = launch_fwd_by_plan<__nv_bfloat16, kRms>(a, device, s);
  } else if (x_dtype == 2) {
    e = launch_fwd_by_plan<__half, kRms>(a, device, s);
  } else {
    e = launch_fwd_by_plan<float, kRms>(a, device, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// LayerNorm forward. Returns the cudaError_t of the launch (0 on success).
// The caller checks shapes, dtypes, devices and contiguity; w and b are
// fp32 [hidden], mu and rstd fp32 [rows]. The plan (blocks of rows_per_block
// rows, warps_per_row warps of vecs 16-byte vectors a lane; warps_per_row 0
// for a block a row) is the host's norm_fwd_plan. Any hidden.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* y, void* mu,
                                   void* rstd, int rows, int hidden,
                                   float eps, int x_dtype, int blocks,
                                   int rows_per_block, int warps_per_row,
                                   int vecs, int device, void* stream) {
  const FwdArgs a{x, static_cast<const float*>(w),
                  static_cast<const float*>(b), y, static_cast<float*>(mu),
                  static_cast<float*>(rstd), rows, hidden, eps, blocks,
                  rows_per_block, warps_per_row, vecs};
  return launch_norm_fwd<false>(a, x_dtype, device, stream);
}

// RMSNorm forward, as apex_layer_norm_fwd without b and mu. w is fp32
// [hidden] (ones for the non-affine norm); rstd fp32 [rows].
extern "C" int apex_rms_norm_fwd(const void* x, const void* w, void* y,
                                 void* rstd, int rows, int hidden, float eps,
                                 int x_dtype, int blocks, int rows_per_block,
                                 int warps_per_row, int vecs, int device,
                                 void* stream) {
  const FwdArgs a{x, static_cast<const float*>(w), nullptr, y, nullptr,
                  static_cast<float*>(rstd), rows, hidden, eps, blocks,
                  rows_per_block, warps_per_row, vecs};
  return launch_norm_fwd<true>(a, x_dtype, device, stream);
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
