// Packed Adam / AdamW for Hopper (sm_90a): one sweep over flat buffers.
//
// Replaces: apex_tpu/ops/packed_optimizer.py, packed_adam_apply (:152, the
// TPU kernel launched at :263). Per element, in fp32:
//   g  = g * inv_scale;  p = src
//   g += wd * p                               (Adam, L2 mode, wd != 0)
//   m' = beta1 * m + (1 - beta1) * g;  v' = beta2 * v + (1 - beta2) * g * g
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps)
//   u += wd * p                               (AdamW, wd != 0)
//   p' = p - lr * u
//   noop set: p' = p, m' = m, v' = v          (the CUDA noop_flag contract)
// then p_out = p' in the parameter dtype (fp32 or bf16), and m, v and the
// fp32 master are written back IN PLACE when asked (write_mv, write_master).
// write_mv = 0 is the fork's no_update_mv mode: m' and v' only feed p'.
//
// lr, bc1, bc2, inv_scale and noop are read from device memory, so the
// caller never synchronises to pass them (they are device scalars that the
// step count and the overflow check produce on the card).
//
// Every operation is rounded on its own (__fmul_rn / __fadd_rn / IEEE
// division and square root, no contraction into fused multiply-adds), in
// the order written above: the kernel gives the same bits as the plain
// PyTorch version, which runs one rounded operation per elementwise op.
//
// What bounds it on the H100: bytes. With bf16 grads and parameters it
// reads 2 + 3 * 4 bytes and writes 2 + 3 * 4 bytes per element against
// about 15 flops. Design: a grid-stride loop over groups of four elements
// (the flat buffers are padded to whole 1024-element rows), 16-byte loads
// and stores of the fp32 buffers, 8-byte ones of bf16, no shared memory.
#include "packed_sweep.cuh"

namespace {

using packed_sweep::load4;
using packed_sweep::store4;

constexpr int kThreads = 256;

struct Hyper {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd;
  int adam_w_mode, write_mv, write_master;
};

template <typename TG, typename TP>
__global__ void __launch_bounds__(kThreads)
    packed_adam_kernel(const TG* __restrict__ g, float* __restrict__ m,
                       float* __restrict__ v, float* __restrict__ src,
                       TP* __restrict__ p_out, const float* __restrict__ lr_p,
                       const float* __restrict__ bc1_p,
                       const float* __restrict__ bc2_p,
                       const float* __restrict__ inv_p,
                       const float* __restrict__ noop_p, long long n4,
                       Hyper hp) {
  const float lr = *lr_p;
  const float bc1 = *bc1_p;
  const float bc2 = *bc2_p;
  const float inv = *inv_p;
  const bool skip = noop_p != nullptr && *noop_p >= 0.5f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    float gr[4], mr[4], vr[4], pr[4], po[4], mo[4], vo[4];
    load4(g, i, gr);
    load4(m, i, mr);
    load4(v, i, vr);
    load4(src, i, pr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float gg = __fmul_rn(gr[e], inv);
      const float p = pr[e];
      if (!hp.adam_w_mode && hp.wd != 0.f)
        gg = __fadd_rn(gg, __fmul_rn(hp.wd, p));
      const float nm = __fadd_rn(__fmul_rn(hp.beta1, mr[e]),
                                 __fmul_rn(hp.one_minus_beta1, gg));
      const float nv =
          __fadd_rn(__fmul_rn(hp.beta2, vr[e]),
                    __fmul_rn(__fmul_rn(hp.one_minus_beta2, gg), gg));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nv, bc2)), hp.eps);
      float u = __fdiv_rn(__fdiv_rn(nm, bc1), den);
      if (hp.adam_w_mode && hp.wd != 0.f)
        u = __fadd_rn(u, __fmul_rn(hp.wd, p));
      const float np = __fsub_rn(p, __fmul_rn(lr, u));
      po[e] = skip ? p : np;
      mo[e] = skip ? mr[e] : nm;
      vo[e] = skip ? vr[e] : nv;
    }
    store4(p_out, i, po);
    if (hp.write_mv) {
      store4(m, i, mo);
      store4(v, i, vo);
    }
    if (hp.write_master) store4(src, i, po);
  }
}

template <typename TG, typename TP>
cudaError_t launch(const void* g, void* m, void* v, void* src, void* p_out,
                   const float* lr, const float* bc1, const float* bc2,
                   const float* inv, const float* noop, long long n4,
                   const Hyper& hp, int sms, cudaStream_t s) {
  const int blocks = packed_sweep::stride_blocks(n4, kThreads, sms);
  packed_adam_kernel<TG, TP><<<blocks, kThreads, 0, s>>>(
      static_cast<const TG*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<float*>(src),
      static_cast<TP*>(p_out), lr, bc1, bc2, inv, noop, n4, hp);
  return cudaGetLastError();
}

}  // namespace

// One packed Adam sweep over n elements (n a multiple of 4; every pointer
// 16-byte aligned). g is fp32 or bf16, p_out fp32 or bf16, m/v/src fp32
// and updated in place as write_mv / write_master say. lr, bc1, bc2 and
// inv_scale point to fp32 device scalars; noop to an fp32 device scalar
// (>= 0.5 means skip) or is null. Returns the cudaError_t of the launch.
extern "C" int apex_packed_adam(const void* g, void* m, void* v, void* src,
                                void* p_out, const void* lr, const void* bc1,
                                const void* bc2, const void* inv_scale,
                                const void* noop, long long n, float beta1,
                                float one_minus_beta1, float beta2,
                                float one_minus_beta2, float eps, float wd,
                                int adam_w_mode, int write_mv,
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
  const Hyper hp{beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd,
                 adam_w_mode, write_mv, write_master};
  const float* f_lr = static_cast<const float*>(lr);
  const float* f_bc1 = static_cast<const float*>(bc1);
  const float* f_bc2 = static_cast<const float*>(bc2);
  const float* f_inv = static_cast<const float*>(inv_scale);
  const float* f_noop = static_cast<const float*>(noop);
  const long long n4 = n / 4;
  if (g_is_bf16 && p_is_bf16) {
    e = launch<__nv_bfloat16, __nv_bfloat16>(g, m, v, src, p_out, f_lr,
                                             f_bc1, f_bc2, f_inv, f_noop, n4,
                                             hp, sms, s);
  } else if (g_is_bf16) {
    e = launch<__nv_bfloat16, float>(g, m, v, src, p_out, f_lr, f_bc1, f_bc2,
                                     f_inv, f_noop, n4, hp, sms, s);
  } else if (p_is_bf16) {
    e = launch<float, __nv_bfloat16>(g, m, v, src, p_out, f_lr, f_bc1, f_bc2,
                                     f_inv, f_noop, n4, hp, sms, s);
  } else {
    e = launch<float, float>(g, m, v, src, p_out, f_lr, f_bc1, f_bc2, f_inv,
                             f_noop, n4, hp, sms, s);
  }
  return static_cast<int>(e);
}
