// Fused scale + mask + softmax of attention scores for Hopper (sm_90a): three
// kernels over the rows of a [rows, sk] score matrix, rows being every
// leading index of [b, np, sq, sk] (row = (b_i * np + h_i) * sq + q_i).
//
// Replaces the TPU kernels of apex_tpu/transformer/functional/fused_softmax.py:
//   softmax_fwd_kernel         _fwd_pallas (:90)          y = softmax(scale * x),
//                                                         causal: col > q_i -> -10000
//   softmax_masked_fwd_kernel  _fwd_masked_pallas (:105)  y = softmax(scale * x),
//                                                         mask != 0 -> -10000
//   softmax_bwd_kernel         _bwd_pallas (:121)         dx = scale * y *
//                                                         (dy - sum_row(dy * y))
// A masked score is -10000 after scaling (the TPU kernels' _NEG_INF), not
// -inf: it takes part in the row's max and sum, a masked probability is 0
// only because exp(-10000 - max) underflows, and a fully masked row is the
// uniform 1 / sk. x, y, dy and dx are fp32, bf16 or fp16 (y and dx in the
// input's dtype); all arithmetic is fp32. exp is __expf (ex2.approx): its
// relative error is a few fp32 ulps, inside the fp32 tolerance the plain
// version is held to.
//
// What bounds them on the H100: device-memory bytes. The forwards read x once
// and write y once, about 5 flops per element against 4 bytes (bf16); the
// backward reads dy and y and writes dx. The causal forward never reads a
// score above the diagonal (its value does not depend on x), so it reads
// about half of x. The masked forward reads the caller's mask through its own
// broadcast strides ([b, 1, sq|1, sk] bytes, mostly from L2): the
// [b, np, sq, sk] mask the TPU wrapper materialised never exists.
//
// Design: one warp per row, kWarps rows per block. A lane owns chunks of 8
// consecutive columns (one 16-byte load in bf16/fp16, two in fp32), chunk
// it * 32 + lane. Up to sk = 1024 the row stays in registers, kVecs chunks a
// lane, between the max, the exp-sum and the write: one read and one write
// of device memory. kVecs is the smallest tile that holds the row: 2 up to
// sk = 512 (BERT-large), 4 up to 1024 (GPT-2 345M); a 4-chunk tile on
// 512-column rows left half its registers and exps idle and ran #15 1.5x
// slower on the H100. Longer rows (up to the 16384 the wrapper allows) take
// kVecs = 0: one sweep keeps a running max and a rescaled running sum, a
// second sweep re-reads the row (from L2) and writes. Max and sum are
// warp-shuffle reductions: no shared memory, no block barrier. A row whose
// length is not a multiple of 8 (or a misaligned pointer) falls back to
// scalar accesses chunk by chunk.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;                   // columns a lane loads at once
constexpr float kMaskFill = -10000.f;     // the TPU kernels' _NEG_INF

enum Mode { kPlain = 0, kCausal = 1, kMasked = 2 };

// Where a row's mask lies: mask + b_i * sb + h_i * sh + q_i * sq, stride 1
// along the keys; a broadcast dimension has stride 0.
struct MaskArgs {
  const uint8_t* mask;
  long long sb, sh, sq;
  int heads;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void from_f32(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <typename T>  // bf16, fp16: one 16-byte load
__device__ __forceinline__ void load8(const T* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = to_f32(h[j]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
  alignas(16) T h[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) from_f32(h + j, v[j]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// Columns [c0, c0 + 8) of a row into v; columns at or past lim read as 0.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* r, int c0, int lim,
                                           bool vec, float* v) {
  if (vec && c0 + kVec <= lim) {
    load8(r + c0, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    v[j] = c0 + j < lim ? to_f32(r[c0 + j]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* r, int c0, int n, bool vec,
                                            const float* v) {
  if (vec && c0 + kVec <= n) {
    store8(r + c0, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (c0 + j < n) from_f32(r + c0 + j, v[j]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The scaled, masked scores of columns [c0, c0 + 8) of one row; columns past
// sk are -inf, so they drop out of the max and the sum. A causal row reads x
// only up to its diagonal (lim = q + 1).
template <typename T, int kMode>
__device__ __forceinline__ void scores8(const T* xr, const uint8_t* mr,
                                        int c0, int sk, int lim, int q,
                                        float scale, bool vec, float* v) {
  load_chunk(xr, c0, lim, vec, v);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = c0 + j;
    float s = v[j] * scale;
    if (kMode == kCausal && c > q) s = kMaskFill;
    if (kMode == kMasked && c < sk && mr[c] != 0) s = kMaskFill;
    v[j] = c < sk ? s : -INFINITY;
  }
}

template <typename T, int kVecs, int kMode>
__device__ __forceinline__ void softmax_row(const T* __restrict__ x,
                                            T* __restrict__ y, long long row,
                                            int sk, int sq, float scale,
                                            MaskArgs m, bool vec) {
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const int q = static_cast<int>(row % sq);
  const uint8_t* mr = nullptr;
  if (kMode == kMasked) {
    const long long bh = row / sq;
    mr = m.mask + (bh / m.heads) * m.sb + (bh % m.heads) * m.sh + q * m.sq;
  }
  const int lim = kMode == kCausal ? min(sk, q + 1) : sk;
  if constexpr (kVecs > 0) {
    float v[kVecs][kVec];
    float mx = -INFINITY;
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
      scores8<T, kMode>(xr, mr, (it * 32 + lane) * kVec, sk, lim, q, scale,
                        vec, v[it]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) mx = fmaxf(mx, v[it][j]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[it][j] = __expf(v[it][j] - mx);
        s += v[it][j];
      }
    }
    const float inv = 1.f / warp_sum(s);
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
      const int c0 = (it * 32 + lane) * kVec;
      if (c0 >= sk) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[it][j] *= inv;
      store_chunk(yr, c0, sk, vec, v[it]);
    }
    return;
  }
  // long rows: a running max and a running sum rescaled to it, then a
  // second sweep that writes
  float mx = -INFINITY, s = 0.f;
  float v[kVec];
  for (int c0 = lane * kVec; c0 < sk; c0 += 32 * kVec) {
    scores8<T, kMode>(xr, mr, c0, sk, lim, q, scale, vec, v);
    float cm = v[0];
#pragma unroll
    for (int j = 1; j < kVec; ++j) cm = fmaxf(cm, v[j]);
    const float nm = fmaxf(mx, cm);
    s *= __expf(mx - nm);  // 0 while mx is still -inf
#pragma unroll
    for (int j = 0; j < kVec; ++j) s += __expf(v[j] - nm);
    mx = nm;
  }
  const float gm = warp_max(mx);
  s = mx == -INFINITY ? 0.f : s * __expf(mx - gm);  // a lane with no chunk
  const float inv = 1.f / warp_sum(s);
  for (int c0 = lane * kVec; c0 < sk; c0 += 32 * kVec) {
    scores8<T, kMode>(xr, mr, c0, sk, lim, q, scale, vec, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __expf(v[j] - gm) * inv;
    store_chunk(yr, c0, sk, vec, v);
  }
}

// #14: causal (kCausal) or unmasked (kPlain)
template <typename T, int kVecs, int kMode>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       long long rows, int sk, int sq, float scale, int vec) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  softmax_row<T, kVecs, kMode>(x, y, row, sk, sq, scale, MaskArgs{}, vec);
}

// #15: a byte mask, nonzero = masked out
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
    softmax_masked_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                              long long rows, int sk, int sq, float scale,
                              MaskArgs m, int vec) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  softmax_row<T, kVecs, kMasked>(x, y, row, sk, sq, scale, m, vec);
}

// #16: dx = scale * y * (dy - sum_row(dy * y)), the backward of all three
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       T* __restrict__ dx, long long rows, int sk,
                       float scale, int vec) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* gr = dy + row * sk;
  const T* pr = y + row * sk;
  T* dr = dx + row * sk;
  if constexpr (kVecs > 0) {
    float g[kVecs][kVec], p[kVecs][kVec];
    float s = 0.f;
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
      const int c0 = (it * 32 + lane) * kVec;
      load_chunk(gr, c0, sk, vec, g[it]);
      load_chunk(pr, c0, sk, vec, p[it]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s += g[it][j] * p[it][j];
    }
    s = warp_sum(s);
#pragma unroll
    for (int it = 0; it < kVecs; ++it) {
      const int c0 = (it * 32 + lane) * kVec;
      if (c0 >= sk) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        g[it][j] = scale * p[it][j] * (g[it][j] - s);
      store_chunk(dr, c0, sk, vec, g[it]);
    }
    return;
  }
  float g[kVec], p[kVec];
  float s = 0.f;
  for (int c0 = lane * kVec; c0 < sk; c0 += 32 * kVec) {
    load_chunk(gr, c0, sk, vec, g);
    load_chunk(pr, c0, sk, vec, p);
#pragma unroll
    for (int j = 0; j < kVec; ++j) s += g[j] * p[j];
  }
  s = warp_sum(s);
  for (int c0 = lane * kVec; c0 < sk; c0 += 32 * kVec) {
    load_chunk(gr, c0, sk, vec, g);
    load_chunk(pr, c0, sk, vec, p);
#pragma unroll
    for (int j = 0; j < kVec; ++j) g[j] = scale * p[j] * (g[j] - s);
    store_chunk(dr, c0, sk, vec, g);
  }
}

// columns a register tile of V chunks a lane holds
constexpr int tile_cols(int v) { return v * 32 * kVec; }

inline unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

template <typename T, int kMode>
void launch_fwd(const void* x, void* y, long long rows, int sk, int sq,
                float scale, const MaskArgs& m, int vec, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const unsigned nb = blocks_for(rows);
#define APEX_SOFTMAX_FWD(V)                                                  \
  if constexpr (kMode == kMasked) {                                          \
    softmax_masked_fwd_kernel<T, V><<<nb, kThreads, 0, s>>>(                 \
        xp, yp, rows, sk, sq, scale, m, vec);                                \
  } else {                                                                   \
    softmax_fwd_kernel<T, V, kMode><<<nb, kThreads, 0, s>>>(                 \
        xp, yp, rows, sk, sq, scale, vec);                                   \
  }
  if (sk <= tile_cols(2)) {
    APEX_SOFTMAX_FWD(2)
  } else if (sk <= tile_cols(4)) {
    APEX_SOFTMAX_FWD(4)
  } else {
    APEX_SOFTMAX_FWD(0)
  }
#undef APEX_SOFTMAX_FWD
}

template <int kMode>
void launch_fwd_typed(int dtype, const void* x, void* y, long long rows,
                      int sk, int sq, float scale, const MaskArgs& m, int vec,
                      cudaStream_t s) {
  if (dtype == 1) {
    launch_fwd<__nv_bfloat16, kMode>(x, y, rows, sk, sq, scale, m, vec, s);
  } else if (dtype == 2) {
    launch_fwd<__half, kMode>(x, y, rows, sk, sq, scale, m, vec, s);
  } else {
    launch_fwd<float, kMode>(x, y, rows, sk, sq, scale, m, vec, s);
  }
}

template <typename T>
void launch_bwd(const void* dy, const void* y, void* dx, long long rows,
                int sk, float scale, int vec, cudaStream_t s) {
  const T* gp = static_cast<const T*>(dy);
  const T* pp = static_cast<const T*>(y);
  T* dp = static_cast<T*>(dx);
  const unsigned nb = blocks_for(rows);
  if (sk <= tile_cols(2)) {
    softmax_bwd_kernel<T, 2><<<nb, kThreads, 0, s>>>(gp, pp, dp, rows, sk,
                                                      scale, vec);
  } else if (sk <= tile_cols(4)) {
    softmax_bwd_kernel<T, 4><<<nb, kThreads, 0, s>>>(gp, pp, dp, rows, sk,
                                                      scale, vec);
  } else {
    softmax_bwd_kernel<T, 0><<<nb, kThreads, 0, s>>>(gp, pp, dp, rows, sk,
                                                     scale, vec);
  }
}

}  // namespace

// The C entry points return the cudaError_t of the launch (0 on success).
// dtype: 0 fp32, 1 bf16, 2 fp16. vec = 1 when sk is a multiple of 8 and every
// pointer is 16-byte aligned (the caller checks), else 0. The caller checks
// shapes, dtypes, devices, contiguity and 0 < sk <= 16384; x, y, dy, dx are
// contiguous [rows, sk].

// #14: y = softmax(scale * x), with the causal fill when causal != 0 (row
// q_i = row % sq keeps columns <= q_i).
extern "C" int apex_softmax_fwd(const void* x, void* y, long long rows,
                                int sk, int sq, float scale, int causal,
                                int dtype, int vec, int device,
                                void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskArgs none{};
  if (causal) {
    launch_fwd_typed<kCausal>(dtype, x, y, rows, sk, sq, scale, none, vec, s);
  } else {
    launch_fwd_typed<kPlain>(dtype, x, y, rows, sk, sq, scale, none, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// #15: y = softmax(scale * x) with mask != 0 -> -10000; x is [b, heads, sq,
// sk] flattened to rows, mask a uint8 array read at mask + b_i * msb + h_i *
// msh + q_i * msq + col.
extern "C" int apex_softmax_masked_fwd(const void* x, const void* mask,
                                       void* y, long long rows, int sk,
                                       int sq, int heads, long long msb,
                                       long long msh, long long msq,
                                       float scale, int dtype, int vec,
                                       int device, void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const MaskArgs m{static_cast<const uint8_t*>(mask), msb, msh, msq, heads};
  launch_fwd_typed<kMasked>(dtype, x, y, rows, sk, sq, scale, m, vec,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// #16: dx = scale * y * (dy - sum_row(dy * y)); dy, y, dx share one dtype.
extern "C" int apex_softmax_bwd(const void* dy, const void* y, void* dx,
                                long long rows, int sk, float scale,
                                int dtype, int vec, int device,
                                void* stream) {
  if (rows == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(dy, y, dx, rows, sk, scale, vec, s);
  } else if (dtype == 2) {
    launch_bwd<__half>(dy, y, dx, rows, sk, scale, vec, s);
  } else {
    launch_bwd<float>(dy, y, dx, rows, sk, scale, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
