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
// row outputs share one dtype (fp32 or bf16); b, w, lb are fp32 (the wrapper
// widens bf16 parameters, which is exact); all arithmetic is fp32 with one
// rounding per output, as in the TPU kernel bodies. The LayerNorm of
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
// rows per column in a fixed order: deterministic, no fp32 atomics. The
// LayerNorm kernels need a whole row in one block (block reductions), so
// they take n <= kCols.
#include <cuda_bf16.h>
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
// x rounded to T and back (the TPU kernel's store-then-reload of the sum)
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bias_gelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                         T* __restrict__ y, int rows, int n) {
  const int c = my_col(n);
  if (c < 0) return;
  float bv[kVec];
  load8(b + c, bv);
  const int r1 = min(rows, (blockIdx.x + 1) * kEwRows);
  for (int r = blockIdx.x * kEwRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float v[kVec];
    load8(x + off, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = gelu_tanh(v[j] + bv[j]);
    store8(y + off, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bias_gelu_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ b, T* __restrict__ dx,
                         float* __restrict__ part, int rows, int n) {
  const int c = my_col(n);
  if (c < 0) return;
  float bv[kVec], acc[kVec];
  load8(b + c, bv);
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  const int r1 = min(rows, (blockIdx.x + 1) * kSumRows);
  for (int r = blockIdx.x * kSumRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float g[kVec], v[kVec];
    load8(dy + off, g);
    load8(x + off, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = g[j] * dgelu_tanh(v[j] + bv[j]);
      acc[j] += v[j];
    }
    store8(dx + off, v);
  }
  store8(part + static_cast<long long>(blockIdx.x) * n + c, acc);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bdr_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                   const T* __restrict__ res, T* __restrict__ out, int rows,
                   int n, Drop drop) {
  const int c = my_col(n);
  if (c < 0) return;
  float bv[kVec];
  load8(b + c, bv);
  const int r1 = min(rows, (blockIdx.x + 1) * kEwRows);
  for (int r = blockIdx.x * kEwRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float v[kVec], rv[kVec];
    load8(x + off, v);
    load8(res + off, rv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v[j] = rv[j] + drop.apply(v[j] + bv[j], r, c + j);
    store8(out + off, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    bdr_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int n, Drop drop) {
  const int c = my_col(n);
  if (c < 0) return;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  const int r1 = min(rows, (blockIdx.x + 1) * kSumRows);
  for (int r = blockIdx.x * kSumRows; r < r1; ++r) {
    const long long off = static_cast<long long>(r) * n + c;
    float v[kVec];
    load8(dy + off, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = drop.apply(v[j], r, c + j);
      acc[j] += v[j];
    }
    store8(dx + off, v);
  }
  store8(part + static_cast<long long>(blockIdx.x) * n + c, acc);
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
Shape shape(int rows, int n, int rows_per_block) {
  const int span = n < kCols ? n : kCols;
  const int threads = ((span / kVec + 31) / 32) * 32;
  return {dim3((rows + rows_per_block - 1) / rows_per_block,
               (n + kCols - 1) / kCols),
          dim3(threads)};
}

cudaError_t col_sum(const float* part, float* out, int n_part, int n,
                    int k, cudaStream_t s) {
  col_sum_kernel<<<dim3((n + 31) / 32, k), dim3(32, 32), 0, s>>>(
      part, out, n_part, n);
  return cudaGetLastError();
}

}  // namespace

// Every entry point returns the cudaError_t of its launches (0 on success).
// The caller checks shapes, dtypes, devices, contiguity and 16-byte
// alignment: n % 8 == 0; n <= 4096 for the LayerNorm kernels.

// Number of partial rows the column-sum kernels write for ``rows`` rows
// (the caller allocates part as [k, n_part, n] fp32).
extern "C" int apex_fused_block_partials(int rows) {
  return (rows + kSumRows - 1) / kSumRows;
}

extern "C" int apex_bias_gelu_fwd(const void* x, const void* b, void* y,
                                  int rows, int n, int is_bf16, int device,
                                  void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kEwRows);
  const float* bf = static_cast<const float*>(b);
  if (is_bf16) {
    bias_gelu_fwd_kernel<__nv_bfloat16><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), bf,
        static_cast<__nv_bfloat16*>(y), rows, n);
  } else {
    bias_gelu_fwd_kernel<float><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const float*>(x), bf, static_cast<float*>(y), rows, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_bias_gelu_bwd(const void* dy, const void* x,
                                  const void* b, void* dx, void* part,
                                  void* db, int rows, int n, int is_bf16,
                                  int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kSumRows);
  const float* bf = static_cast<const float*>(b);
  float* pf = static_cast<float*>(part);
  if (is_bf16) {
    bias_gelu_bwd_kernel<__nv_bfloat16><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(x), bf,
        static_cast<__nv_bfloat16*>(dx), pf, rows, n);
  } else {
    bias_gelu_bwd_kernel<float><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), bf,
        static_cast<float*>(dx), pf, rows, n);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      col_sum(pf, static_cast<float*>(db), sh.grid.x, n, 1, s));
}

extern "C" int apex_bdr_fwd(const void* x, const void* b, const void* res,
                            void* out, int rows, int n, int dropout,
                            uint32_t seed, uint32_t threshold, float scale,
                            int is_bf16, int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kEwRows);
  const Drop d{dropout, seed, threshold, scale};
  const float* bf = static_cast<const float*>(b);
  if (is_bf16) {
    bdr_fwd_kernel<__nv_bfloat16><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), bf,
        static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(out), rows, n, d);
  } else {
    bdr_fwd_kernel<float><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const float*>(x), bf, static_cast<const float*>(res),
        static_cast<float*>(out), rows, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_bdr_bwd(const void* dy, void* dx, void* part, void* db,
                            int rows, int n, int dropout, uint32_t seed,
                            uint32_t threshold, float scale, int is_bf16,
                            int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kSumRows);
  const Drop d{dropout, seed, threshold, scale};
  float* pf = static_cast<float*>(part);
  if (is_bf16) {
    bdr_bwd_kernel<__nv_bfloat16><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), pf, rows, n, d);
  } else {
    bdr_bwd_kernel<float><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const float*>(dy), static_cast<float*>(dx), pf, rows, n,
        d);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      col_sum(pf, static_cast<float*>(db), sh.grid.x, n, 1, s));
}

extern "C" int apex_raln_fwd(const void* x, const void* b, const void* res,
                             const void* w, const void* lb, void* sum,
                             void* y, void* mu, void* rstd, int rows, int n,
                             float eps, int dropout, uint32_t seed,
                             uint32_t threshold, float scale, int is_bf16,
                             int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kEwRows);
  const Drop d{dropout, seed, threshold, scale};
  const float* bf = static_cast<const float*>(b);
  const float* wf = static_cast<const float*>(w);
  const float* lf = static_cast<const float*>(lb);
  float* muf = static_cast<float*>(mu);
  float* rf = static_cast<float*>(rstd);
  if (is_bf16) {
    raln_fwd_kernel<__nv_bfloat16><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), bf,
        static_cast<const __nv_bfloat16*>(res), wf, lf,
        static_cast<__nv_bfloat16*>(sum), static_cast<__nv_bfloat16*>(y),
        muf, rf, rows, n, eps, d);
  } else {
    raln_fwd_kernel<float><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const float*>(x), bf, static_cast<const float*>(res), wf,
        lf, static_cast<float*>(sum), static_cast<float*>(y), muf, rf, rows,
        n, eps, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// grads is [3, n] fp32: dw, dlb, db.
extern "C" int apex_raln_bwd(const void* dsum_out, const void* dy,
                             const void* sum, const void* mu,
                             const void* rstd, const void* w, void* dres,
                             void* dx, void* part, void* grads, int rows,
                             int n, int dropout, uint32_t seed,
                             uint32_t threshold, float scale, int is_bf16,
                             int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape(rows, n, kSumRows);
  const Drop d{dropout, seed, threshold, scale};
  const float* muf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  if (is_bf16) {
    raln_bwd_kernel<__nv_bfloat16><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dsum_out),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(sum), muf, rf, wf,
        static_cast<__nv_bfloat16*>(dres), static_cast<__nv_bfloat16*>(dx),
        pf, rows, n, d);
  } else {
    raln_bwd_kernel<float><<<sh.grid, sh.block, 0, s>>>(
        static_cast<const float*>(dsum_out), static_cast<const float*>(dy),
        static_cast<const float*>(sum), muf, rf, wf,
        static_cast<float*>(dres), static_cast<float*>(dx), pf, rows, n, d);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      col_sum(pf, static_cast<float*>(grads), sh.grid.x, n, 3, s));
}
