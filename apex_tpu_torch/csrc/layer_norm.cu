// LayerNorm forward and backward for Hopper (sm_90a): fp32 statistics per
// row.
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
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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
                                   float eps, int x_is_bf16, int device,
                                   void* stream) {
  if (rows == 0) return 0;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* muf = static_cast<float*>(mu);
  float* rf = static_cast<float*>(rstd);
  if (x_is_bf16) {
    ln_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf,
        static_cast<__nv_bfloat16*>(y), muf, rf, hidden, eps);
  } else {
    ln_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), wf, bf, static_cast<float*>(y), muf,
        rf, hidden, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward. Replaces: apex_tpu/ops/layer_norm.py, _ln_bwd_pallas /
// _ln_bwd_kernel. For each row, with xhat = (x - mu) * rstd and wdy = w * dy:
//   dx = (wdy - xhat * mean(xhat * wdy) - mean(wdy)) * rstd   (dy's dtype)
//   dgamma = sum over rows of dy * xhat,  dbeta = sum over rows of dy  (fp32)
//
// What bounds it on the H100: bytes — x and dy read, dx written (about 12
// flops per element against 12 bytes in fp32).
//
// Design: the TPU kernel summed dgamma/dbeta into one block revisited by
// every (sequential) grid step. GPU blocks run in no order, so that carry
// becomes two launches with no atomics, deterministic run to run:
// (1) ln_bwd_rows_kernel: one block per group of kBwdRows rows; per row a
//     fused two-value block sum gives both means, then dx is written; each
//     thread keeps the column partials of the columns it owns (c = tid +
//     k * kThreads) in shared memory, so no two threads touch one column,
//     and the block writes one [hidden] partial row of dgamma and of dbeta;
// (2) ln_bwd_cols_kernel: one thread per column sums the [n_blocks, hidden]
//     partials in block order (coalesced across threads).
namespace {

constexpr int kBwdRows = 32;

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

template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                       const float* __restrict__ mu,
                       const float* __restrict__ rstd,
                       const float* __restrict__ w, TD* __restrict__ dx,
                       float* __restrict__ dw_part,
                       float* __restrict__ db_part, int rows, int hidden) {
  extern __shared__ float part[];  // [2 * hidden]: dgamma then dbeta
  __shared__ float red[2 * (kThreads / 32)];
  float* pw = part;
  float* pb = part + hidden;
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    pw[c] = 0.f;
    pb[c] = 0.f;
  }
  const float h = static_cast<float>(hidden);
  const int r0 = blockIdx.x * kBwdRows;
  const int r1 = min(rows, r0 + kBwdRows);
  for (int r = r0; r < r1; ++r) {
    const TD* dyr = dy + static_cast<long long>(r) * hidden;
    const TX* xr = x + static_cast<long long>(r) * hidden;
    const float m = mu[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      const float g = to_f32(dyr[c]);
      const float xh = (to_f32(xr[c]) - m) * rs;
      const float wdy = g * w[c];
      s1 += xh * wdy;
      s2 += wdy;
      pw[c] += g * xh;  // column c is owned by this thread alone
      pb[c] += g;
    }
    block_sum2(s1, s2, red);
    const float c1 = s1 / h;
    const float c2 = s2 / h;
    TD* dxr = dx + static_cast<long long>(r) * hidden;
    for (int c = threadIdx.x; c < hidden; c += kThreads) {
      const float g = to_f32(dyr[c]);
      const float xh = (to_f32(xr[c]) - m) * rs;
      store(dxr + c, (g * w[c] - xh * c1 - c2) * rs);
    }
  }
  float* ow = dw_part + static_cast<long long>(blockIdx.x) * hidden;
  float* ob = db_part + static_cast<long long>(blockIdx.x) * hidden;
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    ow[c] = pw[c];
    ob[c] = pb[c];
  }
}

__global__ void __launch_bounds__(kThreads)
    ln_bwd_cols_kernel(const float* __restrict__ dw_part,
                       const float* __restrict__ db_part,
                       float* __restrict__ dw, float* __restrict__ db,
                       int n_blocks, int hidden) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= hidden) return;
  float sw = 0.f, sb = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    sw += dw_part[static_cast<long long>(k) * hidden + c];
    sb += db_part[static_cast<long long>(k) * hidden + c];
  }
  dw[c] = sw;
  db[c] = sb;
}

template <typename TD, typename TX>
cudaError_t launch_ln_bwd(const void* dy, const void* x, const float* mu,
                          const float* rstd, const float* w, void* dx,
                          float* dw_part, float* db_part, int rows,
                          int hidden, cudaStream_t s) {
  const int n_blocks = (rows + kBwdRows - 1) / kBwdRows;
  const size_t smem = 2 * static_cast<size_t>(hidden) * sizeof(float);
  auto kern = ln_bwd_rows_kernel<TD, TX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<n_blocks, kThreads, smem, s>>>(
      static_cast<const TD*>(dy), static_cast<const TX*>(x), mu, rstd, w,
      static_cast<TD*>(dx), dw_part, db_part, rows, hidden);
  return cudaGetLastError();
}

}  // namespace

// Number of [hidden] partial rows the backward's first launch writes (the
// caller allocates dw_part and db_part as [n, hidden] fp32).
extern "C" int apex_layer_norm_bwd_blocks(int rows) {
  return (rows + kBwdRows - 1) / kBwdRows;
}

// Returns the cudaError_t of the launches (0 on success). dy and dx share a
// dtype (fp32 or bf16); x is fp32 or bf16; mu, rstd [rows] and w [hidden]
// fp32; dw, db [hidden] fp32. hidden <= 28672 (two fp32 partial rows must
// fit in one block's shared memory).
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mu, const void* rstd,
                                   const void* w, void* dx, void* dw_part,
                                   void* db_part, void* dw, void* db,
                                   int rows, int hidden, int dy_is_bf16,
                                   int x_is_bf16, int device, void* stream) {
  if (rows == 0 || hidden == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* muf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  const float* wf = static_cast<const float*>(w);
  float* pw = static_cast<float*>(dw_part);
  float* pb = static_cast<float*>(db_part);
  if (dy_is_bf16 && x_is_bf16) {
    e = launch_ln_bwd<__nv_bfloat16, __nv_bfloat16>(dy, x, muf, rf, wf, dx,
                                                    pw, pb, rows, hidden, s);
  } else if (dy_is_bf16) {
    e = launch_ln_bwd<__nv_bfloat16, float>(dy, x, muf, rf, wf, dx, pw, pb,
                                            rows, hidden, s);
  } else if (x_is_bf16) {
    e = launch_ln_bwd<float, __nv_bfloat16>(dy, x, muf, rf, wf, dx, pw, pb,
                                            rows, hidden, s);
  } else {
    e = launch_ln_bwd<float, float>(dy, x, muf, rf, wf, dx, pw, pb, rows,
                                    hidden, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_blocks = (rows + kBwdRows - 1) / kBwdRows;
  ln_bwd_cols_kernel<<<(hidden + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      pw, pb, static_cast<float*>(dw), static_cast<float*>(db), n_blocks,
      hidden);
  return static_cast<int>(cudaGetLastError());
}
