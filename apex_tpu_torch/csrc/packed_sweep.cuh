// Loads and stores of four consecutive elements of a packed flat buffer,
// shared by the packed optimizer sweeps (packed_adam.cu, packed_lamb.cu,
// packed_sgd.cu and the other packed sweeps), and the dispatch on the
// wrappers' dtype codes (0 fp32, 1 bf16, 2 fp16). Index i counts groups of
// four elements: one 16-byte access of an fp32 buffer, one 8-byte access of
// a 16-bit one. The flat
// buffers are whole 1024-element rows (PackSpec), so a group never runs
// past the end, and the wrappers check 16-byte alignment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace packed_sweep {

__device__ __forceinline__ void load4(const float* p, long long i,
                                      float (&x)[4]) {
  const float4 v = reinterpret_cast<const float4*>(p)[i];
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long i,
                                      float (&x)[4]) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  x[0] = __low2float(lo);
  x[1] = __high2float(lo);
  x[2] = __low2float(hi);
  x[3] = __high2float(hi);
}
__device__ __forceinline__ void load4(const __half* p, long long i,
                                      float (&x)[4]) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
  const __half2 lo = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 hi = *reinterpret_cast<const __half2*>(&raw.y);
  x[0] = __low2float(lo);
  x[1] = __high2float(lo);
  x[2] = __low2float(hi);
  x[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, long long i,
                                       const float (&x)[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i,
                                       const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = raw;
}

__device__ __forceinline__ void store4(__half* p, long long i,
                                       const float (&x)[4]) {
  __half2 lo = __floats2half2_rn(x[0], x[1]);
  __half2 hi = __floats2half2_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = raw;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(__half* p, float v) {
  *p = __float2half_rn(v);
}

// An element type as a value, for by_dtype's callbacks.
template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) with T the element type of a wrappers' dtype code (0 fp32,
// 1 bf16, 2 fp16); another code is refused. Nest two calls for a pair:
//   by_dtype(g, [&](auto tg) { return by_dtype(p, [&](auto tp) {
//     return launch<typename decltype(tg)::type,
//                   typename decltype(tp)::type>(...); }); });
template <typename F>
cudaError_t by_dtype(int code, F&& f) {
  switch (code) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<__nv_bfloat16>{});
    case 2: return f(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

// Blocks for a grid-stride loop over n4 groups: one thread a group, at
// most 8 blocks of `threads` per SM.
inline int stride_blocks(long long n4, int threads, int sms) {
  const long long want = (n4 + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * 8;
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace packed_sweep
