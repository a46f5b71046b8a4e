// What the flash-attention sources share: the launch arguments, the masking
// constants, the additive bias and segment-id reads, and the tensor-core
// launcher (flash_attention_bf16.cu, bf16 and fp16), which
// flash_attention.cu's entry points call for 16-bit inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace apex_flash {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF
constexpr float kDead = -5e29f;    // _NEG_INF / 2: at or below counts masked

// dtype codes of the wrappers (q, k, v, o and the bias)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse_in;
  const uint8_t* kv_mask;  // [b, s_k], nonzero = attend; null = all
  // additive logit bias [b|1, n|1, s_q|1, s_k] (null = none): element
  // (ib, ih, qi, kj) at ib * bias_sb + ih * bias_sh + qi * bias_sq + kj, a
  // broadcast dim with stride 0; dtype fp32 or q's (bias_dtype, a code)
  const void* bias;
  long long bias_sb, bias_sh, bias_sq;
  int bias_dtype;
  // the bias's gradient: fp32 [b, n, s_q, s_k] that the dq kernel writes ds
  // into (null = none); the wrapper zeroes it, so tiles no kernel visits
  // read 0
  float* dbias;
  // segment ids (null = none): int32 [b|1, s_q] and [b|1, s_k], batch
  // stride 0 or s, non-decreasing along each row (as cu_seqlens makes
  // them); a score whose query and key ids differ is masked
  const int* seg_q;
  const int* seg_k;
  long long seg_sb_q, seg_sb_k;
  void* out;
  float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int n, s_q, s_k;
  float scale;
  int causal;
  int dropout;
  uint32_t seed;
  uint32_t threshold;
  float drop_scale;  // 1 / (1 - p_drop)
};

// The bias at offset i of the block's (ib, ih) plane, as fp32.
__device__ __forceinline__ float bias_at(const Args& a, long long i) {
  switch (a.bias_dtype) {
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[i]);
    case kF16:
      return __half2float(static_cast<const __half*>(a.bias)[i]);
    default:
      return static_cast<const float*>(a.bias)[i];
  }
}

// The number of entries of the non-decreasing seg[0, n) below key (at or
// below it when `upper`): the position of the first id >= key (> key). Every
// thread of the block calls it and gets the count: one round samples every
// (n / blockDim)-th id, a second counts inside the sample gap that holds the
// boundary, so two dependent reads a thread and no binary search.
__device__ __forceinline__ int block_count_below(const int* seg, int n,
                                                 int key, bool upper) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int stride = (n + nt - 1) / nt;
  const int i = t * stride;
  const bool below = i < n && (upper ? seg[i] <= key : seg[i] < key);
  const int c = __syncthreads_count(below);  // samples 0 .. c-1 are below
  if (c == 0) return 0;
  const int base = (c - 1) * stride + 1;
  const int end = min(n, c * stride);
  int count = base;
  for (int off = 0; off < end - base; off += nt) {
    const int j = base + off + t;
    const bool b = j < end && (upper ? seg[j] <= key : seg[j] < key);
    count += __syncthreads_count(b);
  }
  return count;
}

// The range [lo, hi) of the other operand's positions whose segment ids can
// match some row in [r0, r_end) of this operand's (ids non-decreasing): the
// rows' first and last ids bound it. Every thread of the block calls it.
__device__ __forceinline__ void segment_range(const int* own, int r0,
                                              int r_end, const int* other,
                                              int n_other, int* lo, int* hi) {
  const int first = own[r0], last = own[r_end - 1];
  *lo = block_count_below(other, n_other, first, false);
  *hi = block_count_below(other, n_other, last, true);
}

// The forward (fwd) or backward on the tensor cores in bf16 (dtype kBF16) or
// fp16 (kF16) for bn = b * n heads at head dim d (32, 64, 96, 128 or 256;
// another d or dtype is refused).
cudaError_t launch_tc(bool fwd, const Args& a, int bn, int d, int dtype,
                      int device, cudaStream_t stream);

}  // namespace apex_flash
