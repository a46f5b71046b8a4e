// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a): fp32
// statistics per row.
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
                                 int x_is_bf16, int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* rf = static_cast<float*>(rstd);
  if (x_is_bf16) {
    rms_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf,
        static_cast<__nv_bfloat16*>(y), rf, hidden, eps);
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
// becomes two launches with no atomics, deterministic run to run:
// (1) norm_bwd_rows_kernel: one block per group of up to kBwdRows rows
//     (fewer when the rows are few, so that at least kMinBlocks blocks
//     fill the card: wide rows come in small numbers); per row a
//     fused two-value block sum gives both means, then dx is written (the
//     row walked twice); each thread keeps the column partials of the
//     columns it owns (c = tid + k * kThreads), so no two threads touch one
//     column, and the block writes one [hidden] partial row of dgamma (and
//     of dbeta). The partials sit in shared memory while they fit in a
//     block's (hidden up to ~29,000 for LayerNorm, ~58,000 for RMSNorm); wider
//     rows keep them in the block's own partial rows in device memory, read
//     and written by their owning thread alone, so any width runs;
// (2) norm_bwd_cols_kernel: one thread per column sums the [n_blocks, hidden]
//     partials in block order (coalesced across threads).
namespace {

constexpr int kBwdRows = 32;
constexpr int kMinBlocks = 256;

// Rows one block of the backward takes.
int bwd_rows_per_block(int rows) {
  const int r = rows / kMinBlocks;
  return r < 1 ? 1 : (r > kBwdRows ? kBwdRows : r);
}

int bwd_blocks(int rows) {
  const int r = bwd_rows_per_block(rows);
  return (rows + r - 1) / r;
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

// kRms: RMSNorm (no mean, no dbeta); kSmem: column partials in shared memory
// (else in the block's rows of dw_part / db_part).
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
__global__ void __launch_bounds__(kThreads)
    norm_bwd_cols_kernel(const float* __restrict__ dw_part,
                         const float* __restrict__ db_part,
                         float* __restrict__ dw, float* __restrict__ db,
                         int n_blocks, int hidden) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= hidden) return;
  float sw = 0.f, sb = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    sw += dw_part[static_cast<long long>(k) * hidden + c];
    if (db_part != nullptr)
      sb += db_part[static_cast<long long>(k) * hidden + c];
  }
  dw[c] = sw;
  if (db != nullptr) db[c] = sb;
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
};

template <typename TD, typename TX, bool kRms, bool kSmem>
cudaError_t launch_rows(const BwdArgs& a, size_t smem, cudaStream_t s) {
  auto kern = norm_bwd_rows_kernel<TD, TX, kRms, kSmem>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<bwd_blocks(a.rows), kThreads, smem, s>>>(
      static_cast<const TD*>(a.dy), static_cast<const TX*>(a.x), a.mu,
      a.rstd, a.w, static_cast<TD*>(a.dx), a.dw_part, a.db_part, a.rows,
      bwd_rows_per_block(a.rows), a.hidden, a.x_is_xhat);
  return cudaGetLastError();
}

// The rows kernel for one dtype pair: shared-memory partials when they fit
// in the block's opt-in shared memory beside its static array, else
// device-memory partials.
template <typename TD, typename TX, bool kRms>
cudaError_t launch_by_width(const BwdArgs& a, int device, cudaStream_t s) {
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

template <bool kRms>
cudaError_t launch_norm_bwd(const BwdArgs& a, float* dw, float* db,
                            int dy_is_bf16, int x_is_bf16, int device,
                            cudaStream_t s) {
  cudaError_t e;
  if (dy_is_bf16 && x_is_bf16) {
    e = launch_by_width<__nv_bfloat16, __nv_bfloat16, kRms>(a, device, s);
  } else if (dy_is_bf16) {
    e = launch_by_width<__nv_bfloat16, float, kRms>(a, device, s);
  } else if (x_is_bf16) {
    e = launch_by_width<float, __nv_bfloat16, kRms>(a, device, s);
  } else {
    e = launch_by_width<float, float, kRms>(a, device, s);
  }
  if (e != cudaSuccess) return e;
  norm_bwd_cols_kernel<<<(a.hidden + kThreads - 1) / kThreads, kThreads, 0,
                         s>>>(a.dw_part, a.db_part, dw, db,
                              bwd_blocks(a.rows), a.hidden);
  return cudaGetLastError();
}

}  // namespace

// Number of [hidden] partial rows the backwards' first launch writes (the
// caller allocates dw_part, and db_part for LayerNorm, as [n, hidden] fp32).
extern "C" int apex_layer_norm_bwd_blocks(int rows) {
  return bwd_blocks(rows);
}

// LayerNorm backward. Returns the cudaError_t of the launches (0 on
// success). dy and dx share a dtype (fp32 or bf16); x is fp32 or bf16 (xhat
// itself when x_is_xhat, then mu is not read); mu, rstd [rows] and w
// [hidden] fp32; dw, db [hidden] fp32. Any hidden.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mu, const void* rstd,
                                   const void* w, void* dx, void* dw_part,
                                   void* db_part, void* dw, void* db,
                                   int rows, int hidden, int dy_is_bf16,
                                   int x_is_bf16, int x_is_xhat, int device,
                                   void* stream) {
  if (rows == 0 || hidden == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BwdArgs a{dy, x, static_cast<const float*>(mu),
                  static_cast<const float*>(rstd),
                  static_cast<const float*>(w), dx,
                  static_cast<float*>(dw_part), static_cast<float*>(db_part),
                  rows, hidden, x_is_xhat};
  return static_cast<int>(launch_norm_bwd<false>(
      a, static_cast<float*>(dw), static_cast<float*>(db), dy_is_bf16,
      x_is_bf16, device, static_cast<cudaStream_t>(stream)));
}

// RMSNorm backward, as apex_layer_norm_bwd without mu, db_part and db.
extern "C" int apex_rms_norm_bwd(const void* dy, const void* x,
                                 const void* rstd, const void* w, void* dx,
                                 void* dw_part, void* dw, int rows,
                                 int hidden, int dy_is_bf16, int x_is_bf16,
                                 int x_is_xhat, int device, void* stream) {
  if (rows == 0 || hidden == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BwdArgs a{dy, x, nullptr, static_cast<const float*>(rstd),
                  static_cast<const float*>(w), dx,
                  static_cast<float*>(dw_part), nullptr, rows, hidden,
                  x_is_xhat};
  return static_cast<int>(launch_norm_bwd<true>(
      a, static_cast<float*>(dw), nullptr, dy_is_bf16, x_is_bf16, device,
      static_cast<cudaStream_t>(stream)));
}
