// Packed LAMB for Hopper (sm_90a): the three sweeps of one FusedLAMB step
// over flat buffers laid out by PackSpec (whole 1024-element rows).
//
// Replaces three TPU kernels of apex_tpu/ops/packed_optimizer.py:
//   packed_row_reduce  (:611, launched at :642)  -> apex_packed_row_reduce
//   packed_lamb_stage1 (:395, launched at :458)  -> apex_packed_lamb_stage1
//   packed_scale_update (:479, launched at :519) -> apex_packed_scale_update
//
// Row reduce, per 1024-element row r, of x = x * inv_scale in fp32:
//   out[r] = sum x * x   (op_max = 0)   or   max |x|   (op_max = 1; NaN wins)
// Stage 1, per element, in fp32 (the JAX kernel's order):
//   g  = (g * inv_scale) / clip;  p = src
//   g += wd * p                                  (L2 mode, wd != 0)
//   m' = beta1 * m + beta3 * g;  v' = beta2 * v + ((1 - beta2) * g) * g
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps)
//   u += wd * p                                  (adam_w_mode, wd != 0)
// writing u to a new buffer, m' and v' in place, and per row sum u * u and
// sum p * p (the trust ratios' partials). noop set: m and v are not
// written (u and the row sums are, and the caller's scale update skips).
// Scale update (LAMB stage 2), per element of row r:
//   p' = p - (lr * coef[r]) * u;  p_out = p' in the parameter dtype,
//   the fp32 master written in place when write_master;
//   noop set: p_out = p and the master is not written.
//
// inv_scale, clip, bc1, bc2, lr and noop are fp32 scalars in device memory:
// clip comes from the global gradient norm on the card, noop from the
// overflow check, so a step never reads them on the host.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, IEEE
// division and square root: no contraction into fused multiply-adds), in
// the order written above, as the plain PyTorch version runs them. The
// row reduce's max and the scale update equal it bit for bit; stage 1's
// quotients may lie an ulp from PyTorch's CUDA division's (1e-6 relative
// at most where beta1 * m + beta3 * g cancels), and the row sums differ
// from it in their summation order.
//
// What bounds them on the H100: bytes. Stage 1 reads g, m, v and src and
// writes u, m and v (28 bytes an element in fp32) against ~20 flops; the
// reduce reads 4 (or 2) bytes an element; the scale update reads u, src
// and writes p_out and the master. Design: the row kernels give each row
// to one warp (8 rows a block): a lane takes every 32nd group of four
// elements (16-byte fp32 loads, 8-byte bf16 ones, a warp covering 512
// contiguous bytes at a time), sums its 32 elements in a fixed order, and
// the warp adds the 32 partials with a butterfly of shuffles. The order
// never changes between runs: no atomics, so the sums are deterministic.
// The scale update is a grid-stride loop over groups of four.
#include "packed_sweep.cuh"

namespace {

using packed_sweep::load4;
using packed_sweep::store4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;       // rows a block of a row kernel
constexpr int kGroupsPerRow = 1024 / 4;     // groups of four in a row
constexpr int kGroupsPerLane = kGroupsPerRow / 32;

__device__ __forceinline__ float max_nan(float acc, float x) {
  return (x > acc || x != x) ? x : acc;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
    row_reduce_kernel(const T* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ inv_p, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float inv = *inv_p;
  const long long base = row * kGroupsPerRow + lane;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kGroupsPerLane; ++k) {
    float xr[4];
    load4(x, base + k * 32, xr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = __fmul_rn(xr[e], inv);
      acc = kMax ? max_nan(acc, fabsf(s)) : __fadd_rn(acc, __fmul_rn(s, s));
    }
  }
  acc = kMax ? warp_max(acc) : warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

struct LambHyper {
  float beta1, beta2, beta3, one_minus_beta2, eps, wd;
  int adam_w_mode;
};

template <typename TG>
__global__ void __launch_bounds__(kThreads)
    lamb_stage1_kernel(const TG* __restrict__ g, float* __restrict__ m,
                       float* __restrict__ v, const float* __restrict__ src,
                       float* __restrict__ u, float* __restrict__ row_u,
                       float* __restrict__ row_p,
                       const float* __restrict__ inv_p,
                       const float* __restrict__ clip_p,
                       const float* __restrict__ bc1_p,
                       const float* __restrict__ bc2_p,
                       const float* __restrict__ noop_p, long long rows,
                       LambHyper hp) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float inv = *inv_p;
  const float clip = *clip_p;
  const float bc1 = *bc1_p;
  const float bc2 = *bc2_p;
  const bool skip = noop_p != nullptr && *noop_p >= 0.5f;
  const bool decay = hp.wd != 0.f;
  const long long base = row * kGroupsPerRow + lane;
  float su = 0.f, sp = 0.f;
#pragma unroll 2
  for (int k = 0; k < kGroupsPerLane; ++k) {
    const long long i = base + k * 32;
    float gr[4], mr[4], vr[4], pr[4], uo[4], mo[4], vo[4];
    load4(g, i, gr);
    load4(m, i, mr);
    load4(v, i, vr);
    load4(src, i, pr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = pr[e];
      float gg = __fdiv_rn(__fmul_rn(gr[e], inv), clip);
      if (!hp.adam_w_mode && decay) gg = __fadd_rn(gg, __fmul_rn(hp.wd, p));
      mo[e] = __fadd_rn(__fmul_rn(hp.beta1, mr[e]), __fmul_rn(hp.beta3, gg));
      vo[e] = __fadd_rn(__fmul_rn(hp.beta2, vr[e]),
                        __fmul_rn(__fmul_rn(hp.one_minus_beta2, gg), gg));
      const float den =
          __fadd_rn(__fsqrt_rn(__fdiv_rn(vo[e], bc2)), hp.eps);
      float uu = __fdiv_rn(__fdiv_rn(mo[e], bc1), den);
      if (hp.adam_w_mode && decay) uu = __fadd_rn(uu, __fmul_rn(hp.wd, p));
      uo[e] = uu;
      su = __fadd_rn(su, __fmul_rn(uu, uu));
      sp = __fadd_rn(sp, __fmul_rn(p, p));
    }
    store4(u, i, uo);
    if (!skip) {
      store4(m, i, mo);
      store4(v, i, vo);
    }
  }
  su = warp_sum(su);
  sp = warp_sum(sp);
  if (lane == 0) {
    row_u[row] = su;
    row_p[row] = sp;
  }
}

template <typename TP>
__global__ void __launch_bounds__(kThreads)
    scale_update_kernel(const float* __restrict__ u, float* __restrict__ src,
                        const float* __restrict__ coef,
                        TP* __restrict__ p_out,
                        const float* __restrict__ lr_p,
                        const float* __restrict__ noop_p, long long n4,
                        int write_master) {
  const float lr = *lr_p;
  const bool skip = noop_p != nullptr && *noop_p >= 0.5f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    float pr[4];
    load4(src, i, pr);
    if (!skip) {
      float ur[4];
      load4(u, i, ur);
      const float s = __fmul_rn(lr, coef[i / kGroupsPerRow]);
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] = __fsub_rn(pr[e], __fmul_rn(s, ur[e]));
      if (write_master) store4(src, i, pr);
    }
    store4(p_out, i, pr);
  }
}

unsigned row_blocks(long long rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

}  // namespace

// Per-row sum of squares (op_max = 0) or max |x| (op_max = 1) of
// x * inv_scale over `rows` rows of 1024 elements; x fp32 or bf16, out
// fp32 (rows,), inv_scale an fp32 device scalar. Returns the cudaError_t
// of the launch.
extern "C" int apex_packed_row_reduce(const void* x, void* out,
                                      const void* inv_scale, long long rows,
                                      int op_max, int x_is_bf16, int device,
                                      void* stream) {
  if (rows == 0) return 0;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* inv = static_cast<const float*>(inv_scale);
  float* o = static_cast<float*>(out);
  const unsigned blocks = row_blocks(rows);
  if (x_is_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (op_max)
      row_reduce_kernel<__nv_bfloat16, true><<<blocks, kThreads, 0, s>>>(
          xb, o, inv, rows);
    else
      row_reduce_kernel<__nv_bfloat16, false><<<blocks, kThreads, 0, s>>>(
          xb, o, inv, rows);
  } else {
    const float* xf = static_cast<const float*>(x);
    if (op_max)
      row_reduce_kernel<float, true><<<blocks, kThreads, 0, s>>>(xf, o, inv,
                                                                 rows);
    else
      row_reduce_kernel<float, false><<<blocks, kThreads, 0, s>>>(xf, o, inv,
                                                                  rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// LAMB stage 1 over `rows` rows of 1024 elements. g fp32 or bf16; m, v
// fp32, updated in place unless noop; src fp32; u fp32 (new); row_u,
// row_p fp32 (rows,). inv_scale, clip, bc1, bc2 point to fp32 device
// scalars, noop to one (>= 0.5 means skip) or is null.
extern "C" int apex_packed_lamb_stage1(
    const void* g, void* m, void* v, const void* src, void* u, void* row_u,
    void* row_p, const void* inv_scale, const void* clip, const void* bc1,
    const void* bc2, const void* noop, long long rows, float beta1,
    float beta2, float beta3, float one_minus_beta2, float eps, float wd,
    int adam_w_mode, int g_is_bf16, int device, void* stream) {
  if (rows == 0) return 0;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LambHyper hp{beta1, beta2, beta3, one_minus_beta2, eps, wd,
                     adam_w_mode};
  const unsigned blocks = row_blocks(rows);
#define APEX_STAGE1_ARGS                                                    \
  static_cast<float*>(m), static_cast<float*>(v),                          \
      static_cast<const float*>(src), static_cast<float*>(u),              \
      static_cast<float*>(row_u), static_cast<float*>(row_p),              \
      static_cast<const float*>(inv_scale), static_cast<const float*>(clip), \
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),      \
      static_cast<const float*>(noop), rows, hp
  if (g_is_bf16)
    lamb_stage1_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), APEX_STAGE1_ARGS);
  else
    lamb_stage1_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), APEX_STAGE1_ARGS);
#undef APEX_STAGE1_ARGS
  return static_cast<int>(cudaGetLastError());
}

// LAMB stage 2 over `rows` rows of 1024 elements: p_out (fp32 or bf16) =
// src - (lr * coef[row]) * u; src (fp32) updated in place when
// write_master. coef fp32 (rows,); lr and noop as in stage 1.
extern "C" int apex_packed_scale_update(const void* u, void* src,
                                        const void* coef, void* p_out,
                                        const void* lr, const void* noop,
                                        long long rows, int write_master,
                                        int p_is_bf16, int device,
                                        void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = rows * kGroupsPerRow;
  const int blocks = packed_sweep::stride_blocks(n4, kThreads, sms);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(src);
  const float* cf = static_cast<const float*>(coef);
  const float* lf = static_cast<const float*>(lr);
  const float* nf = static_cast<const float*>(noop);
  if (p_is_bf16)
    scale_update_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        uf, sf, cf, static_cast<__nv_bfloat16*>(p_out), lf, nf, n4,
        write_master);
  else
    scale_update_kernel<float><<<blocks, kThreads, 0, s>>>(
        uf, sf, cf, static_cast<float*>(p_out), lf, nf, n4, write_master);
  return static_cast<int>(cudaGetLastError());
}
