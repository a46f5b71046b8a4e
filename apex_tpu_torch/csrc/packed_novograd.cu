// Packed NovoGrad's elementwise stage for Hopper (sm_90a): one sweep over
// flat buffers.
//
// Replaces: apex_tpu/ops/packed_optimizer.py, packed_novograd_apply (:537,
// the TPU kernel launched at :590). NovoGrad's second moment is one scalar
// per tensor (layer-wise); the caller reduces it from the gradient's row
// partials (packed_row_reduce) and hands it over per ROW of 1024 elements as
// denom[row] = sqrt(v[leaf]) + eps. Per element, in fp32 (the JAX kernel's
// order):
//   g  = g * inv_scale;  p = src
//   mi = g / denom[row]                           (a true division)
//   mi += wd * p                                  (wd != 0, reg_inside_moment)
//   m' = beta1 * m + beta3 * mi
//   u  = m' / bc1                                 (a true division)
//   u += wd * p                                   (wd != 0, not inside)
//   p' = p - lr * u
//   noop set: nothing is written but p_out = p    (the CUDA noop_flag contract)
// then p_out = p' in the parameter dtype (fp32/bf16/fp16), and m' written back
// in place. src is read only (the JAX kernel aliases m alone).
//
// lr, bc1, inv_scale and noop are fp32 scalars in device memory, so a step
// never reads them on the host. Every operation is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn: no contraction into fused multiply-adds
// and no reciprocal) in the order above, as the plain PyTorch version.
//
// What bounds it on the H100: bytes. With fp32 grads and parameters it reads
// g, m and src and writes m and p_out, 20 bytes an element, against about 10
// flops (the row's denominator is one fp32 load for 1024 elements). Design:
// packed_sgd.cu's, a grid-stride loop over groups of four elements with
// 16-byte fp32 and 8-byte bf16 accesses, no shared memory; a group never
// straddles two rows.
#include "packed_sweep.cuh"

namespace {

using packed_sweep::load4;
using packed_sweep::store4;

constexpr int kThreads = 256;
constexpr int kGroupsPerRow = 1024 / 4;

struct NovoHyper {
  float beta1, beta3, wd;
  int reg_inside_moment;
};

template <typename TG, typename TP>
__global__ void __launch_bounds__(kThreads)
    packed_novograd_kernel(const TG* __restrict__ g, float* __restrict__ m,
                           const float* __restrict__ src,
                           const float* __restrict__ denom,
                           TP* __restrict__ p_out,
                           const float* __restrict__ lr_p,
                           const float* __restrict__ bc1_p,
                           const float* __restrict__ inv_p,
                           const float* __restrict__ noop_p, long long n4,
                           NovoHyper hp) {
  const float lr = *lr_p;
  const float bc1 = *bc1_p;
  const float inv = *inv_p;
  const bool skip = noop_p != nullptr && *noop_p >= 0.5f;
  const bool decay = hp.wd != 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    float pr[4];
    load4(src, i, pr);
    if (!skip) {
      float gr[4], mr[4];
      load4(g, i, gr);
      load4(m, i, mr);
      const float d = denom[i / kGroupsPerRow];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = pr[e];
        float mi = __fdiv_rn(__fmul_rn(gr[e], inv), d);
        if (decay && hp.reg_inside_moment) mi = __fadd_rn(mi, __fmul_rn(hp.wd, p));
        mr[e] = __fadd_rn(__fmul_rn(hp.beta1, mr[e]), __fmul_rn(hp.beta3, mi));
        float u = __fdiv_rn(mr[e], bc1);
        if (decay && !hp.reg_inside_moment) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
        pr[e] = __fsub_rn(p, __fmul_rn(lr, u));
      }
      store4(m, i, mr);
    }
    store4(p_out, i, pr);
  }
}

template <typename TG, typename TP>
cudaError_t launch(const void* g, void* m, const void* src, const void* denom,
                   void* p_out, const float* lr, const float* bc1,
                   const float* inv, const float* noop, long long n4,
                   const NovoHyper& hp, int sms, cudaStream_t s) {
  const int blocks = packed_sweep::stride_blocks(n4, kThreads, sms);
  packed_novograd_kernel<TG, TP><<<blocks, kThreads, 0, s>>>(
      static_cast<const TG*>(g), static_cast<float*>(m),
      static_cast<const float*>(src), static_cast<const float*>(denom),
      static_cast<TP*>(p_out), lr, bc1, inv, noop, n4, hp);
  return cudaGetLastError();
}

}  // namespace

// One packed NovoGrad sweep over n elements (n a multiple of 1024; every
// pointer 16-byte aligned). g and p_out each fp32, bf16 or fp16, m fp32 and
// updated in place, src fp32 and read only, denom fp32 with one value per
// row of 1024 elements. lr, bc1 and inv_scale point to fp32 device scalars;
// noop to one (>= 0.5 means skip) or is null. Returns the cudaError_t of the
// launch.
extern "C" int apex_packed_novograd(const void* g, void* m, const void* src,
                                    const void* denom, void* p_out,
                                    const void* lr, const void* bc1,
                                    const void* inv_scale, const void* noop,
                                    long long n, float beta1, float beta3,
                                    float wd, int reg_inside_moment,
                                    int g_dtype, int p_dtype, int device,
                                    void* stream) {
  if (n == 0) return 0;
  if (n % 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const NovoHyper hp{beta1, beta3, wd, reg_inside_moment};
  const float* f_lr = static_cast<const float*>(lr);
  const float* f_bc1 = static_cast<const float*>(bc1);
  const float* f_inv = static_cast<const float*>(inv_scale);
  const float* f_noop = static_cast<const float*>(noop);
  const long long n4 = n / 4;
  e = packed_sweep::by_dtype(g_dtype, [&](auto tg) {
    return packed_sweep::by_dtype(p_dtype, [&](auto tp) {
      return launch<typename decltype(tg)::type, typename decltype(tp)::type>(
          g, m, src, denom, p_out, f_lr, f_bc1, f_inv, f_noop, n4, hp, sms,
          s);
    });
  });
  return static_cast<int>(e);
}
