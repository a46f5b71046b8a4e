// What the flash-attention sources share: the launch arguments, the masking
// constants, and the bf16 tensor-core launcher (flash_attention_bf16.cu),
// which flash_attention.cu's entry points call for bf16 inputs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apex_flash {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF
constexpr float kDead = -5e29f;    // _NEG_INF / 2: at or below counts masked

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse_in;
  const uint8_t* kv_mask;  // [b, s_k], nonzero = attend; null = all
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

// The bf16 forward (fwd) or backward on the tensor cores for bn = b * n
// heads at head dim d (32, 64, 96, 128 or 256; another d is refused).
cudaError_t launch_bf16(bool fwd, const Args& a, int bn, int d, int device,
                        cudaStream_t stream);

}  // namespace apex_flash
