// Fused transformer-block tails for Hopper (sm_90a): six kernels, each one
// sweep over a [rows, n] activation, rows being every leading index of the
// [s, b, h] layout (row = s_i * b + b_i).
//
// Replaces the TPU kernels of apex_tpu/ops/fused_block.py:
//   bias_gelu_fwd      _bias_gelu_fwd (:193)  y = gelu_tanh(x + b)
//   bias_gelu_bwd      _bias_gelu_bwd (:212)  dx = dy * gelu_tanh'(x + b),
//                                             db = sum_rows dx
//   bdr_fwd            _bdr_fwd (:306)        out = r + drop(x + b)
//   bdr_bwd            _bdr_bwd (:335)        dx = drop(dy), db = sum_rows dx
//   raln_fwd           _raln_fwd (:477)       sum = r + drop(x + b) (rounded
//                                             to r's dtype), y = LN(sum),
//                                             mu, rstd fp32 per row
//   raln_bwd           _raln_bwd (:512)       dsum = LN'(dy) + dsum_out,
//                                             dres = dsum, dx = drop(dsum),
//                                             dw, dlb, db column sums
// where drop(v) = v * keep * 1 / (1 - p), keep = keep_bit(seed, 0, row, col,
// round(p * 2^32)) (hash_dropout.cuh; p = 0 skips the hash). x, r, dy and the
// row outputs share one dtype (fp32, bf16 or fp16); b, w, lb are fp32 (the
// wrapper widens 16-bit parameters, which is exact); all arithmetic is fp32
// with one rounding per output, as in the TPU kernel bodies. The LayerNorm of
// raln_fwd runs on the sum AFTER its rounding, with the centred two-pass
// variance of layer_norm.cu.
//
// What bounds them on the H100: device-memory bytes. Each does a few to a
// few tens of flops per element against 4 to 14 bytes per element (bf16),
// far below the card's ~20 flops per byte of fp32 CUDA-core rate.
//
// Design. Every thread owns 8 consecutive columns (one 16-byte bf16 vector,
// two fp32 ones) and a block spans at most kCols columns of a row and a group
// of rows; blockIdx.y picks the column chunk. The parameter vectors are read
// once per block into registers. The TPU kernels summed the column
// gradients into one block revisited by every sequential grid step; GPU
// blocks run in no order, so (as layer_norm.cu's backward) each block keeps
// its columns' partial sums in registers over its kSumRows rows and writes
// one partial row, and a second launch (col_sum_kernel) sums the partial
// rows per column in a fixed order: deterministic, no fp32 atomics.
//
// Any width. A trailing dim n that is not a multiple of 8 leaves rows off
// 16-byte boundaries: the kernels' A = false instances read and write a
// thread's columns one by one, the columns at or past n read as 0 and never
// written. The LayerNorm kernels need a whole row in one block (block
// reductions): for n <= kCols with n % 8 == 0 each thread holds its 8 columns
// in registers (raln_fwd_kernel, raln_bwd_kernel); for a wider or unaligned
// row (raln_*_wide_kernel) each thread walks its columns in steps of the
// block's span and reads the row again from L1/L2 for each later pass, as
// layer_norm.cu does: the forward re-reads the sum it wrote, the backward
// takes the row sums of all its rows first (kept in shared memory), then
// walks its columns over the rows, so its column partials stay 24 registers
// whatever the width.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"  // keep_bit, the dropout hash

namespace {

constexpr int kVec = 8;              // columns a thread owns
constexpr int kCols = 4096;          // columns a block spans at most
constexpr int kMaxThreads = kCols / kVec;
constexpr int kEwRows = 4;           // rows per block, forward kernels
constexpr int kSumRows = 16;         // rows per block, column-sum kernels
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;

struct Drop {
  int on;
  uint32_t seed;
  uint32_t threshold;
  float scale;  // 1 / (1 - p)
  __device__ __forceinline__ float apply(float v, int row, int col) const {
    if (!on) return v;
    const bool keep = keep_bit(seed, 0u, static_cast<uint32_t>(row),
                               static_cast<uint32_t>(col), threshold);
    return v * (keep ? 1.f : 0.f) * scale;
  }
};

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const __half* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half* h = reinterpret_cast<const __half*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = __half2float(h[j]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  alignas(16) __nv_bfloat16 h[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) h[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store8(__half* p, const float* v) {
  alignas(16) __half h[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) h[j] = __float2half_rn(v[j]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// A thread's kVec columns from p on, cnt = min(kVec, n - c) of them in the
// row: one vector access when A (n % 8 == 0), else element by element, the
// columns past the row read as 0 and not written.
template <bool A, typename T>
__device__ __forceinline__ void loadv(const T* p, float* v, int cnt) {
  if constexpr (A) {
    load8(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = j < cnt ? to_f32(p[j]) : 0.f;
  }
}
template <bool A, typename T>
__device__ __forceinline__ void storev(T* p, const float* v, int cnt) {
  if constexpr (A) {
    store8(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < cnt) store1(p + j, v[j]);
  }
}
// x rounded to T and back (the TPU kernel's store-then-reload of the sum)
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, __half*) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = kSqrt2OverPi * (x + kGeluC * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}
__device__ __forceinline__ float dgelu_tanh(float x) {
  const float inner = kSqrt2OverPi * (x + kGeluC * x * x * x);
  const float t = tanhf(inner);
  const float dinner = kSqrt2OverPi * (1.f + 3.f * kGeluC * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * dinner;
}

// Block-wide sums over blockDim.x (a multiple of 32, <= 1024) threads;
// every thread gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  a = lane < n_warps ? red[lane] : 0.f;
  b = lane < n_warps ? red[32 + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();  // red is reused by the next call
}

// The first column of this thread, or -1 when it owns none.
__device__ __forceinline__ int my_col(int n) {
  const int c = blockIdx.y * kCols + threadIdx.x * kVec;
  return c < n ? c : -1;
}

template <typename T, bool A>
__global__ void __launch_bounds__(kMaxThreads)
    bias_gelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                         T* __restrict__ y, int rows, int n) {
  const int c = my_col(n);
  if (c < 0) return;
  const int cnt = min(kVec, n - c);
  float bv[kVec];
  loadv<A>(b + c, bv, cnt);
  const int r1 = min(rows, (blockIdx.x + 1) * kEwRows);
  for (int r = blockIdx.x * kEwRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float v[kVec];
    loadv<A>(x + off, v, cnt);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = gelu_tanh(v[j] + bv[j]);
    storev<A>(y + off, v, cnt);
  }
}

template <typename T, bool A>
__global__ void __launch_bounds__(kMaxThreads)
    bias_gelu_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ b, T* __restrict__ dx,
                         float* __restrict__ part, int rows, int n) {
  const int c = my_col(n);
  if (c < 0) return;
  const int cnt = min(kVec, n - c);
  float bv[kVec], acc[kVec];
  loadv<A>(b + c, bv, cnt);
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  const int r1 = min(rows, (blockIdx.x + 1) * kSumRows);
  for (int r = blockIdx.x * kSumRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float g[kVec], v[kVec];
    loadv<A>(dy + off, g, cnt);
    loadv<A>(x + off, v, cnt);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = g[j] * dgelu_tanh(v[j] + bv[j]);
      acc[j] += v[j];
    }
    storev<A>(dx + off, v, cnt);
  }
  storev<A>(part + static_cast<long long>(blockIdx.x) * n + c, acc, cnt);
}

template <typename T, bool A>
__global__ void __launch_bounds__(kMaxThreads)
    bdr_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                   const T* __restrict__ res, T* __restrict__ out, int rows,
                   int n, Drop drop) {
  const int c = my_col(n);
  if (c < 0) return;
  const int cnt = min(kVec, n - c);
  float bv[kVec];
  loadv<A>(b + c, bv, cnt);
  const int r1 = min(rows, (blockIdx.x + 1) * kEwRows);
  for (int r = blockIdx.x * kEwRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float v[kVec], rv[kVec];
    loadv<A>(x + off, v, cnt);
    loadv<A>(res + off, rv, cnt);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v[j] = rv[j] + drop.apply(v[j] + bv[j], r, c + j);
    storev<A>(out + off, v, cnt);
  }
}

template <typename T, bool A>
__global__ void __launch_bounds__(kMaxThreads)
    bdr_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int n, Drop drop) {
  const int c = my_col(n);
  if (c < 0) return;
  const int cnt = min(kVec, n - c);
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  const int r1 = min(rows, (blockIdx.x + 1) * kSumRows);
  for (int r = blockIdx.x * kSumRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float v[kVec];
    loadv<A>(dy + off, v, cnt);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = drop.apply(v[j], r, c + j);
      acc[j] += v[j];
    }
    storev<A>(dx + off, v, cnt);
  }
  storev<A>(part + static_cast<long long>(blockIdx.x) * n + c, acc, cnt);
}

// One block spans the whole row (n <= kCols); threads past the row's end
// own no columns but take part in the block sums.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    raln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                    const T* __restrict__ res, const float* __restrict__ w,
                    const float* __restrict__ lb, T* __restrict__ sum,
                    T* __restrict__ y, float* __restrict__ mu,
                    float* __restrict__ rstd, int rows, int n, float eps,
                    Drop drop) {
  __shared__ float red[64];
  const int c = my_col(n);
  const bool active = c >= 0;
  float bv[kVec], wv[kVec], lv[kVec];
  if (active) {
    load8(b + c, bv);
    load8(w + c, wv);
    load8(lb + c, lv);
  }
  const float inv_n = 1.f / static_cast<float>(n);
  const int r1 = min(rows, (blockIdx.x + 1) * kEwRows);
  for (int r = blockIdx.x * kEwRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float s[kVec];
    float t = 0.f, unused = 0.f;
    if (active) {
      float rv[kVec];
      load8(x + off, s);
      load8(res + off, rv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] = round_to(rv[j] + drop.apply(s[j] + bv[j], r, c + j), sum);
        t += s[j];
      }
      store8(sum + off, s);
    }
    block_sum2(t, unused, red);
    const float mean = t * inv_n;
    float v = 0.f;
    if (active) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = s[j] - mean;
        v += d * d;
      }
    }
    unused = 0.f;
    block_sum2(v, unused, red);
    const float rs = rsqrtf(v * inv_n + eps);
    if (active) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) s[j] = ((s[j] - mean) * rs) * wv[j] + lv[j];
      store8(y + off, s);
    }
    if (threadIdx.x == 0) {
      mu[r] = mean;
      rstd[r] = rs;
    }
  }
}

// part is [3, n_blocks, n]: dw, dlb, db partial rows.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    raln_bwd_kernel(const T* __restrict__ dsum_out, const T* __restrict__ dy,
                    const T* __restrict__ sum, const float* __restrict__ mu,
                    const float* __restrict__ rstd,
                    const float* __restrict__ w, T* __restrict__ dres,
                    T* __restrict__ dx, float* __restrict__ part, int rows,
                    int n, Drop drop) {
  __shared__ float red[64];
  const int c = my_col(n);
  const bool active = c >= 0;
  float wv[kVec], pw[kVec], pl[kVec], pb[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) pw[j] = pl[j] = pb[j] = 0.f;
  if (active) load8(w + c, wv);
  const float inv_n = 1.f / static_cast<float>(n);
  const int r1 = min(rows, (blockIdx.x + 1) * kSumRows);
  for (int r = blockIdx.x * kSumRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    const float m = mu[r];
    const float rs = rstd[r];
    float g[kVec], xh[kVec];
    float s1 = 0.f, s2 = 0.f;
    if (active) {
      load8(dy + off, g);
      load8(sum + off, xh);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        xh[j] = (xh[j] - m) * rs;
        const float wdy = g[j] * wv[j];
        s1 += xh[j] * wdy;
        s2 += wdy;
      }
    }
    block_sum2(s1, s2, red);
    if (active) {
      const float c1 = s1 * inv_n;
      const float c2 = s2 * inv_n;
      float ds[kVec], d[kVec];
      load8(dsum_out + off, ds);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ds[j] += (g[j] * wv[j] - xh[j] * c1 - c2) * rs;
        d[j] = drop.apply(ds[j], r, c + j);
        pw[j] += g[j] * xh[j];
        pl[j] += g[j];
        pb[j] += d[j];
      }
      store8(dres + off, ds);
      store8(dx + off, d);
    }
  }
  if (active) {
    const long long stride = static_cast<long long>(gridDim.x) * n;
    float* p = part + static_cast<long long>(blockIdx.x) * n + c;
    store8(p, pw);
    store8(p + stride, pl);
    store8(p + 2 * stride, pb);
  }
}

// A row wider than kCols, or not a multiple of 8 wide: each thread walks
// columns c = 8 * threadIdx.x + k * 8 * blockDim.x. The first pass writes the
// rounded sum; the variance and output passes read it back (this thread's
// own writes).
template <typename T, bool A>
__global__ void __launch_bounds__(kMaxThreads)
    raln_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ b,
                         const T* __restrict__ res,
                         const float* __restrict__ w,
                         const float* __restrict__ lb, T* sum,
                         T* __restrict__ y, float* __restrict__ mu,
                         float* __restrict__ rstd, int rows, int n,
                         float eps, Drop drop) {
  __shared__ float red[64];
  const int c0 = threadIdx.x * kVec;
  const int step = blockDim.x * kVec;
  const float inv_n = 1.f / static_cast<float>(n);
  const int r1 = min(rows, (blockIdx.x + 1) * kEwRows);
  for (int r = blockIdx.x * kEwRows; r < r1; ++r) {
    const long long row = static_cast<long long>(r) * n;
    float t = 0.f, unused = 0.f;
    for (int c = c0; c < n; c += step) {
      const int cnt = min(kVec, n - c);
      float s[kVec], rv[kVec], bv[kVec];
      loadv<A>(x + row + c, s, cnt);
      loadv<A>(res + row + c, rv, cnt);
      loadv<A>(b + c, bv, cnt);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] = round_to(rv[j] + drop.apply(s[j] + bv[j], r, c + j), sum);
        if (j < cnt) t += s[j];
      }
      storev<A>(sum + row + c, s, cnt);
    }
    block_sum2(t, unused, red);
    const float mean = t * inv_n;
    float v = 0.f;
    for (int c = c0; c < n; c += step) {
      const int cnt = min(kVec, n - c);
      float s[kVec];
      loadv<A>(sum + row + c, s, cnt);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = s[j] - mean;
        if (j < cnt) v += d * d;
      }
    }
    unused = 0.f;
    block_sum2(v, unused, red);
    const float rs = rsqrtf(v * inv_n + eps);
    for (int c = c0; c < n; c += step) {
      const int cnt = min(kVec, n - c);
      float s[kVec], wv[kVec], lv[kVec];
      loadv<A>(sum + row + c, s, cnt);
      loadv<A>(w + c, wv, cnt);
      loadv<A>(lb + c, lv, cnt);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s[j] = ((s[j] - mean) * rs) * wv[j] + lv[j];
      storev<A>(y + row + c, s, cnt);
    }
    if (threadIdx.x == 0) {
      mu[r] = mean;
      rstd[r] = rs;
    }
  }
}

// The backward over wide or unaligned rows: first the two row sums of each
// of the block's rows (kept in shared memory), then, column by column, the
// gradients of every row and the column partials of this block.
template <typename T, bool A>
__global__ void __launch_bounds__(kMaxThreads)
    raln_bwd_wide_kernel(const T* __restrict__ dsum_out,
                         const T* __restrict__ dy, const T* __restrict__ sum,
                         const float* __restrict__ mu,
                         const float* __restrict__ rstd,
                         const float* __restrict__ w, T* __restrict__ dres,
                         T* __restrict__ dx, float* __restrict__ part,
                         int rows, int n, Drop drop) {
  __shared__ float red[64];
  __shared__ float c1s[kSumRows], c2s[kSumRows];
  const int c0 = threadIdx.x * kVec;
  const int step = blockDim.x * kVec;
  const float inv_n = 1.f / static_cast<float>(n);
  const int r0 = blockIdx.x * kSumRows;
  const int r1 = min(rows, r0 + kSumRows);
  for (int r = r0; r < r1; ++r) {
    const long long row = static_cast<long long>(r) * n;
    const float m = mu[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = c0; c < n; c += step) {
      const int cnt = min(kVec, n - c);
      float g[kVec], xh[kVec], wv[kVec];
      loadv<A>(dy + row + c, g, cnt);
      loadv<A>(sum + row + c, xh, cnt);
      loadv<A>(w + c, wv, cnt);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = (xh[j] - m) * rs;
        const float wdy = g[j] * wv[j];
        if (j < cnt) {
          s1 += xhat * wdy;
          s2 += wdy;
        }
      }
    }
    block_sum2(s1, s2, red);
    if (threadIdx.x == 0) {
      c1s[r - r0] = s1 * inv_n;
      c2s[r - r0] = s2 * inv_n;
    }
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * n;
  for (int c = c0; c < n; c += step) {
    const int cnt = min(kVec, n - c);
    float wv[kVec], pw[kVec], pl[kVec], pb[kVec];
    loadv<A>(w + c, wv, cnt);
#pragma unroll
    for (int j = 0; j < kVec; ++j) pw[j] = pl[j] = pb[j] = 0.f;
    for (int r = r0; r < r1; ++r) {
      const long long off = static_cast<long long>(r) * n + c;
      const float m = mu[r];
      const float rs = rstd[r];
      const float c1 = c1s[r - r0];
      const float c2 = c2s[r - r0];
      float g[kVec], xh[kVec], ds[kVec], d[kVec];
      loadv<A>(dy + off, g, cnt);
      loadv<A>(sum + off, xh, cnt);
      loadv<A>(dsum_out + off, ds, cnt);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        xh[j] = (xh[j] - m) * rs;
        ds[j] += (g[j] * wv[j] - xh[j] * c1 - c2) * rs;
        d[j] = drop.apply(ds[j], r, c + j);
        pw[j] += g[j] * xh[j];
        pl[j] += g[j];
        pb[j] += d[j];
      }
      storev<A>(dres + off, ds, cnt);
      storev<A>(dx + off, d, cnt);
    }
    float* p = part + static_cast<long long>(blockIdx.x) * n + c;
    storev<A>(p, pw, cnt);
    storev<A>(p + stride, pl, cnt);
    storev<A>(p + 2 * stride, pb, cnt);
  }
}

// out[k, c] = sum over p of part[k, p, c], p in [0, n_part): thread (tx, ty)
// sums p = ty, ty + 32, ... for column blockIdx.x * 32 + tx, then row ty = 0
// adds the 32 partial sums in order. blockIdx.y = k.
__global__ void __launch_bounds__(1024)
    col_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int n_part, int n) {
  __shared__ float acc[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* src = part + static_cast<long long>(blockIdx.y) * n_part * n;
  float s = 0.f;
  if (c < n) {
    for (int p = threadIdx.y; p < n_part; p += 32)
      s += src[static_cast<long long>(p) * n + c];
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float t = 0.f;
    for (int k = 0; k < 32; ++k) t += acc[k][threadIdx.x];
    out[static_cast<long long>(blockIdx.y) * n + c] = t;
  }
}

struct Shape {
  dim3 grid, block;
};
// Column-chunked launches: blockIdx.y picks a chunk of kCols columns.
Shape shape(int rows, int n, int rows_per_block) {
  const int span = n < kCols ? n : kCols;
  const int threads = (((span + kVec - 1) / kVec + 31) / 32) * 32;
  return {dim3((rows + rows_per_block - 1) / rows_per_block,
               (n + kCols - 1) / kCols),
          dim3(threads)};
}
// The LayerNorm kernels: one block spans the whole row.
Shape row_shape(int rows, int n, int rows_per_block) {
  Shape sh = shape(rows, n, rows_per_block);
  sh.grid.y = 1;
  return sh;
}
// The LayerNorm tail keeps a row in registers when it fits one block span
// in 16-byte vectors; otherwise the wide kernels walk it.
bool fits(int n) { return n <= kCols && n % kVec == 0; }

cudaError_t col_sum(const float* part, float* out, int n_part, int n,
                    int k, cudaStream_t s) {
  col_sum_kernel<<<dim3((n + 31) / 32, k), dim3(32, 32), 0, s>>>(
      part, out, n_part, n);
  return cudaGetLastError();
}

template <typename T, bool A>
void launch_bias_gelu_fwd(const Shape& sh, const void* x, const float* b,
                          void* y, int rows, int n, cudaStream_t s) {
  bias_gelu_fwd_kernel<T, A><<<sh.grid, sh.block, 0, s>>>(
      static_cast<const T*>(x), b, static_cast<T*>(y), rows, n);
}

template <typename T, bool A>
void launch_bias_gelu_bwd(const Shape& sh, const void* dy, const void* x,
                          const float* b, void* dx, float* part, int rows,
                          int n, cudaStream_t s) {
  bias_gelu_bwd_kernel<T, A><<<sh.grid, sh.block, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), b,
      static_cast<T*>(dx), part, rows, n);
}

template <typename T, bool A>
void launch_bdr_fwd(const Shape& sh, const void* x, const float* b,
                    const void* res, void* out, int rows, int n,
                    const Drop& d, cudaStream_t s) {
  bdr_fwd_kernel<T, A><<<sh.grid, sh.block, 0, s>>>(
      static_cast<const T*>(x), b, static_cast<const T*>(res),
      static_cast<T*>(out), rows, n, d);
}

template <typename T, bool A>
void launch_bdr_bwd(const Shape& sh, const void* dy, void* dx, float* part,
                    int rows, int n, const Drop& d, cudaStream_t s) {
  bdr_bwd_kernel<T, A><<<sh.grid, sh.block, 0, s>>>(
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, n, d);
}

template <typename T>
void launch_raln_fwd(const Shape& sh, const void* x, const float* b,
                     const void* res, const float* w, const float* lb,
                     void* sum, void* y, float* mu, float* rstd, int rows,
                     int n, float eps, const Drop& d, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* st = static_cast<T*>(sum);
  T* yt = static_cast<T*>(y);
  if (fits(n))
    raln_fwd_kernel<T><<<sh.grid, sh.block, 0, s>>>(xt, b, rt, w, lb, st, yt,
                                                   mu, rstd, rows, n, eps, d);
  else if (n % kVec == 0)
    raln_fwd_wide_kernel<T, true><<<sh.grid, sh.block, 0, s>>>(
        xt, b, rt, w, lb, st, yt, mu, rstd, rows, n, eps, d);
  else
    raln_fwd_wide_kernel<T, false><<<sh.grid, sh.block, 0, s>>>(
        xt, b, rt, w, lb, st, yt, mu, rstd, rows, n, eps, d);
}

template <typename T>
void launch_raln_bwd(const Shape& sh, const void* dsum_out, const void* dy,
                     const void* sum, const float* mu, const float* rstd,
                     const float* w, void* dres, void* dx, float* part,
                     int rows, int n, const Drop& d, cudaStream_t s) {
  const T* dso = static_cast<const T*>(dsum_out);
  const T* dyt = static_cast<const T*>(dy);
  const T* st = static_cast<const T*>(sum);
  T* drt = static_cast<T*>(dres);
  T* dxt = static_cast<T*>(dx);
  if (fits(n))
    raln_bwd_kernel<T><<<sh.grid, sh.block, 0, s>>>(
        dso, dyt, st, mu, rstd, w, drt, dxt, part, rows, n, d);
  else if (n % kVec == 0)
    raln_bwd_wide_kernel<T, true><<<sh.grid, sh.block, 0, s>>>(
        dso, dyt, st, mu, rstd, w, drt, dxt, part, rows, n, d);
  else
    raln_bwd_wide_kernel<T, false><<<sh.grid, sh.block, 0, s>>>(
        dso, dyt, st, mu, rstd, w, drt, dxt, part, rows, n, d);
}

// F<dtype, aligned>(args...) for the six instances of an elementwise
// kernel; dtype is the wrappers' code (0 fp32, 1 bf16, 2 fp16)
#define APEX_DISPATCH_T(F, T, aligned_, ...)                    \
  do {                                                          \
    if (aligned_) F<T, true>(__VA_ARGS__);                      \
    else F<T, false>(__VA_ARGS__);                              \
  } while (0)
#define APEX_DISPATCH(F, dtype, n, ...)                                   \
  do {                                                                    \
    const bool aligned_ = (n) % kVec == 0;                                \
    if ((dtype) == 1) APEX_DISPATCH_T(F, __nv_bfloat16, aligned_,         \
                                      __VA_ARGS__);                       \
    else if ((dtype) == 2) APEX_DISPATCH_T(F, __half, aligned_,           \
                                           __VA_ARGS__);                  \
    else APEX_DISPATCH_T(F, float, aligned_, __VA_ARGS__);                \
  } while (0)

}  // namespace

// Every entry point returns the cudaError_t of its launches (0 on success).
// The caller checks shapes, dtypes, devices, contiguity and 16-byte
// alignment of the buffers; any trailing dim n >= 1 is taken.

// Number of partial rows the column-sum kernels write for ``rows`` rows
// (the caller allocates part as [k, n_part, n] fp32).
extern "C" int apex_fused_block_partials(int rows) {
  return (rows + kSumRows - 1) / kSumRows;
}

extern "C" int apex_bias_gelu_fwd(const void* x, const void* b, void* y,
                                  int rows, int n, int dtype, int device,
                                  void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kEwRows);
  APEX_DISPATCH(launch_bias_gelu_fwd, dtype, n, sh, x,
                static_cast<const float*>(b), y, rows, n, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_bias_gelu_bwd(const void* dy, const void* x,
                                  const void* b, void* dx, void* part,
                                  void* db, int rows, int n, int dtype,
                                  int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kSumRows);
  float* pf = static_cast<float*>(part);
  APEX_DISPATCH(launch_bias_gelu_bwd, dtype, n, sh, dy, x,
                static_cast<const float*>(b), dx, pf, rows, n, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      col_sum(pf, static_cast<float*>(db), sh.grid.x, n, 1, s));
}

extern "C" int apex_bdr_fwd(const void* x, const void* b, const void* res,
                            void* out, int rows, int n, int dropout,
                            uint32_t seed, uint32_t threshold, float scale,
                            int dtype, int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kEwRows);
  const Drop d{dropout, seed, threshold, scale};
  APEX_DISPATCH(launch_bdr_fwd, dtype, n, sh, x,
                static_cast<const float*>(b), res, out, rows, n, d, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_bdr_bwd(const void* dy, void* dx, void* part, void* db,
                            int rows, int n, int dropout, uint32_t seed,
                            uint32_t threshold, float scale, int dtype,
                            int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kSumRows);
  const Drop d{dropout, seed, threshold, scale};
  float* pf = static_cast<float*>(part);
  APEX_DISPATCH(launch_bdr_bwd, dtype, n, sh, dy, dx, pf, rows, n, d, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      col_sum(pf, static_cast<float*>(db), sh.grid.x, n, 1, s));
}

extern "C" int apex_raln_fwd(const void* x, const void* b, const void* res,
                             const void* w, const void* lb, void* sum,
                             void* y, void* mu, void* rstd, int rows, int n,
                             float eps, int dropout, uint32_t seed,
                             uint32_t threshold, float scale, int dtype,
                             int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = row_shape(rows, n, kEwRows);
  const Drop d{dropout, seed, threshold, scale};
  const float* bf = static_cast<const float*>(b);
  const float* wf = static_cast<const float*>(w);
  const float* lf = static_cast<const float*>(lb);
  float* muf = static_cast<float*>(mu);
  float* rf = static_cast<float*>(rstd);
  if (dtype == 1)
    launch_raln_fwd<__nv_bfloat16>(sh, x, bf, res, wf, lf, sum, y, muf, rf,
                                   rows, n, eps, d, s);
  else if (dtype == 2)
    launch_raln_fwd<__half>(sh, x, bf, res, wf, lf, sum, y, muf, rf, rows, n,
                            eps, d, s);
  else
    launch_raln_fwd<float>(sh, x, bf, res, wf, lf, sum, y, muf, rf, rows, n,
                           eps, d, s);
  return static_cast<int>(cudaGetLastError());
}

// grads is [3, n] fp32: dw, dlb, db.
extern "C" int apex_raln_bwd(const void* dsum_out, const void* dy,
                             const void* sum, const void* mu,
                             const void* rstd, const void* w, void* dres,
                             void* dx, void* part, void* grads, int rows,
                             int n, int dropout, uint32_t seed,
                             uint32_t threshold, float scale, int dtype,
                             int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = row_shape(rows, n, kSumRows);
  const Drop d{dropout, seed, threshold, scale};
  const float* muf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  if (dtype == 1)
    launch_raln_bwd<__nv_bfloat16>(sh, dsum_out, dy, sum, muf, rf, wf, dres,
                                   dx, pf, rows, n, d, s);
  else if (dtype == 2)
    launch_raln_bwd<__half>(sh, dsum_out, dy, sum, muf, rf, wf, dres, dx, pf,
                            rows, n, d, s);
  else
    launch_raln_bwd<float>(sh, dsum_out, dy, sum, muf, rf, wf, dres, dx, pf,
                           rows, n, d, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      col_sum(pf, static_cast<float*>(grads), sh.grid.x, n, 3, s));
}
