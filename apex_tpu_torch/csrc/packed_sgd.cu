// Packed momentum SGD for Hopper (sm_90a): one sweep over flat buffers.
//
// Replaces: apex_tpu/ops/packed_optimizer.py, packed_sgd_apply (:292, the
// TPU kernel launched at :374). Per element, in fp32 (the JAX kernel's
// order):
//   g  = g * inv_scale;  p = src;  d = g
//   d += wd * p                                   (wd != 0, before momentum)
//   momentum != 0:
//     buf' = first_run ? d : momentum * buf + (1 - dampening) * d
//     d    = nesterov ? d + momentum * buf' : buf'
//   d += wd * p                                   (wd != 0, wd_after_momentum)
//   p' = p - lr * d
//   noop set: nothing is written but p_out = p    (the CUDA noop_flag contract)
// then p_out = p' in the parameter dtype (fp32 or bf16), buf' written back
// in place (when momentum != 0) and the fp32 master in place when
// write_master.
//
// lr, first_run (the step count is 0: the momentum buffer is materialised
// as d), inv_scale and noop are fp32 scalars in device memory, so a step
// never reads them on the host.
//
// Every operation is rounded on its own (__fmul_rn / __fadd_rn, no
// contraction into fused multiply-adds) in the order written above: the
// kernel gives the plain PyTorch version's bits.
//
// What bounds it on the H100: bytes. With bf16 grads and parameters and
// fp32 masters it reads 2 + 2 * 4 bytes and writes 2 + 2 * 4 bytes per
// element against under 10 flops. Design: packed_adam.cu's, a grid-stride
// loop over groups of four elements with 16-byte fp32 and 8-byte bf16
// accesses, no shared memory.
#include "packed_sweep.cuh"

namespace {

using packed_sweep::load4;
using packed_sweep::store4;

constexpr int kThreads = 256;

struct SgdHyper {
  float momentum, one_minus_dampening, wd;
  int nesterov, wd_after_momentum, write_master;
};

template <typename TG, typename TP>
__global__ void __launch_bounds__(kThreads)
    packed_sgd_kernel(const TG* __restrict__ g, float* __restrict__ buf,
                      float* __restrict__ src, TP* __restrict__ p_out,
                      const float* __restrict__ lr_p,
                      const float* __restrict__ first_p,
                      const float* __restrict__ inv_p,
                      const float* __restrict__ noop_p, long long n4,
                      SgdHyper hp) {
  const float lr = *lr_p;
  const bool first = *first_p >= 0.5f;
  const float inv = *inv_p;
  const bool skip = noop_p != nullptr && *noop_p >= 0.5f;
  const bool decay = hp.wd != 0.f;
  const bool mom = hp.momentum != 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    float pr[4];
    load4(src, i, pr);
    if (!skip) {
      float gr[4], br[4];
      load4(g, i, gr);
      if (mom) load4(buf, i, br);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = pr[e];
        float d = __fmul_rn(gr[e], inv);
        if (decay && !hp.wd_after_momentum) d = __fadd_rn(d, __fmul_rn(hp.wd, p));
        if (mom) {
          br[e] = first ? d
                        : __fadd_rn(__fmul_rn(hp.momentum, br[e]),
                                    __fmul_rn(hp.one_minus_dampening, d));
          d = hp.nesterov ? __fadd_rn(d, __fmul_rn(hp.momentum, br[e]))
                          : br[e];
        }
        if (decay && hp.wd_after_momentum) d = __fadd_rn(d, __fmul_rn(hp.wd, p));
        pr[e] = __fsub_rn(p, __fmul_rn(lr, d));
      }
      if (mom) store4(buf, i, br);
      if (hp.write_master) store4(src, i, pr);
    }
    store4(p_out, i, pr);
  }
}

template <typename TG, typename TP>
cudaError_t launch(const void* g, void* buf, void* src, void* p_out,
                   const float* lr, const float* first, const float* inv,
                   const float* noop, long long n4, const SgdHyper& hp,
                   int sms, cudaStream_t s) {
  const int blocks = packed_sweep::stride_blocks(n4, kThreads, sms);
  packed_sgd_kernel<TG, TP><<<blocks, kThreads, 0, s>>>(
      static_cast<const TG*>(g), static_cast<float*>(buf),
      static_cast<float*>(src), static_cast<TP*>(p_out), lr, first, inv, noop,
      n4, hp);
  return cudaGetLastError();
}

}  // namespace

// One packed SGD sweep over n elements (n a multiple of 4; every pointer
// 16-byte aligned). g fp32 or bf16, p_out fp32 or bf16, buf and src fp32
// and updated in place (buf when momentum != 0, src when write_master).
// lr, first_run and inv_scale point to fp32 device scalars (first_run
// >= 0.5 means the first step); noop to one (>= 0.5 means skip) or is
// null. Returns the cudaError_t of the launch.
extern "C" int apex_packed_sgd(const void* g, void* buf, void* src,
                               void* p_out, const void* lr,
                               const void* first_run, const void* inv_scale,
                               const void* noop, long long n, float momentum,
                               float one_minus_dampening, float wd,
                               int nesterov, int wd_after_momentum,
                               int write_master, int g_is_bf16,
                               int p_is_bf16, int device, void* stream) {
  if (n == 0) return 0;
  if (n % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SgdHyper hp{momentum, one_minus_dampening, wd,
                    nesterov, wd_after_momentum, write_master};
  const float* f_lr = static_cast<const float*>(lr);
  const float* f_first = static_cast<const float*>(first_run);
  const float* f_inv = static_cast<const float*>(inv_scale);
  const float* f_noop = static_cast<const float*>(noop);
  const long long n4 = n / 4;
  if (g_is_bf16 && p_is_bf16)
    e = launch<__nv_bfloat16, __nv_bfloat16>(g, buf, src, p_out, f_lr,
                                             f_first, f_inv, f_noop, n4, hp,
                                             sms, s);
  else if (g_is_bf16)
    e = launch<__nv_bfloat16, float>(g, buf, src, p_out, f_lr, f_first, f_inv,
                                     f_noop, n4, hp, sms, s);
  else if (p_is_bf16)
    e = launch<float, __nv_bfloat16>(g, buf, src, p_out, f_lr, f_first, f_inv,
                                     f_noop, n4, hp, sms, s);
  else
    e = launch<float, float>(g, buf, src, p_out, f_lr, f_first, f_inv, f_noop,
                             n4, hp, sms, s);
  return static_cast<int>(e);
}
