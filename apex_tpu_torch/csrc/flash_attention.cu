// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py, the TPU kernels _fwd_kernel
// (launched by _fwd, :390) and _bwd_dq_kernel / _bwd_dkv_kernel (launched by
// _bwd, :673). Layout [b, n, s, d], contiguous; q, k, v, o, do and the
// gradients share one dtype (fp32 or bf16); the lse is [b, n, s_q] fp32.
//
//   s   = (round(q * scale)) . k            fp32; masked to -1e30 (causal
//                                           ki > qi, kv_mask[b, ki] == 0)
//   o   = dropout(softmax(s)) @ v           p rounded to the input dtype
//                                           before the product, as the TPU
//                                           kernel's p.astype(v.dtype)
//   lse = m + log(l), -1e30 and o = 0 for a fully masked row
//
// The backward recomputes p = exp(s - lse) from the saved lse, with
// delta = rowsum(do * o) in fp32 and ds = p * (dp * keep / (1 - p_drop) -
// delta); dv = p_drop^T do, dk = ds^T round(q * scale), dq = ds k * scale.
// Every score at or below -5e29 counts as masked (p = 0), so a fully masked
// row has zero gradients, never NaN. Dropout keeps (q, k) when the murmur3
// hash of (seed, b * n + h, global q, global k) in uint32 arithmetic is at
// least round(p_drop * 2^32): the TPU kernel's _keep_mask bit for bit, the
// same bits in forward and backward.
//
// What bounds it on the H100: arithmetic. These kernels do their products in
// fp32 on the CUDA cores (the tensor cores are for a later change), so at
// the GPT-2 345M shape ([8, 16, 1024, 64], causal) the ~17 GFLOP forward and
// ~43 GFLOP backward cost far more than the ~64 MB they move.
//
// Design. The TPU grid ran (b, h, q-tile, k-tile) in order and carried the
// online-softmax state and the dk/dv sums in VMEM across the last grid axis.
// GPU blocks run in no order, so each block owns its rows and loops over the
// other axis itself, with nothing carried between blocks and no atomics:
// - forward: one block per (b, h, 64 query rows); two threads per row, each
//   holding half of the scaled q row and of the output accumulator in
//   registers; key/value tiles of 32 rows are staged in shared memory as
//   fp32 and read as broadcasts; the running max and sum live per row, and
//   the tile's 32 scores sit in registers between the max and the sum pass;
// - backward, dq: one block per (b, h, 64 query rows), the same layout over
//   key tiles; it also computes delta (written for the next launch);
// - backward, dk/dv: one block per (b, h, 64 key rows); two threads per key
//   row hold half of k, v, dk, dv in registers and loop over query tiles
//   staged in shared memory with their lse and delta.
// The two halves of a row combine their partial dot products with one warp
// shuffle. Causal blocks skip the tiles that lie wholly above the diagonal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF
constexpr float kDead = -5e29f;    // _NEG_INF / 2: at or below counts masked
constexpr int kRows = 64;          // rows a block owns
constexpr int kThreads = 2 * kRows;
constexpr int kTile = 32;          // rows of the other operand per stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// x rounded to T and back: the TPU kernel's astype(dtype) before a dot
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The keep bit of _keep_mask: unsigned compare of the hash against the
// threshold (the TPU code's sign-flip compare is the same order).
__device__ __forceinline__ bool keep_bit(uint32_t seed, uint32_t bh,
                                         uint32_t qi, uint32_t ki,
                                         uint32_t threshold) {
  uint32_t x = qi * 0x9E3779B1u;
  x ^= ki * 0x85EBCA77u;
  x ^= seed + bh * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

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

// A row split in two halves of H floats, each half padded by 4 floats so
// the two halves of one row start in different banks (the two threads of a
// row read them in the same instruction) and stay 16-byte aligned.
template <int H>
struct Tile {
  float x[kTile][2][H + 4];
};

template <int H>
__device__ __forceinline__ float half_dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < H; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + d);
    acc += a[d] * bv.x;
    acc += a[d + 1] * bv.y;
    acc += a[d + 2] * bv.z;
    acc += a[d + 3] * bv.w;
  }
  return acc;
}

template <int H>
__device__ __forceinline__ void half_axpy(float* acc, float a,
                                          const float* b) {
#pragma unroll
  for (int d = 0; d < H; d += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + d);
    acc[d] += a * bv.x;
    acc[d + 1] += a * bv.y;
    acc[d + 2] += a * bv.z;
    acc[d + 3] += a * bv.w;
  }
}

// Stage rows [r0, r0 + kTile) of a [rows, D] matrix into a Tile as fp32
// (times mul, then rounded to T when round_q: the scaled q); rows past the
// end are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(Tile<D / 2>& dst, const T* src, int r0,
                                      int rows, float mul, bool round_q) {
  constexpr int H = D / 2;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int j = e / D;
    const int d = e % D;
    float val = 0.f;
    if (r0 + j < rows) {
      val = to_f32(src[static_cast<long long>(r0 + j) * D + d]);
      if (round_q) val = round_to<T>(val * mul);
    }
    dst.x[j][d / H][d % H] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int H = D / 2;
  __shared__ __align__(16) Tile<H> ks;
  __shared__ __align__(16) Tile<H> vs;
  __shared__ uint8_t live_k[kTile];
  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int qi = iq * kRows + row;
  const bool qvalid = qi < a.s_q;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const T* q = static_cast<const T*>(a.q) + qbase;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  float qr[H], acc[H];
#pragma unroll
  for (int d = 0; d < H; ++d) {
    qr[d] = qvalid ? round_to<T>(to_f32(q[static_cast<long long>(qi) * D +
                                           half * H + d]) * a.scale)
                   : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int k_end = a.causal ? min(a.s_k, (iq + 1) * kRows) : a.s_k;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage<T, D>(ks, k, k0, a.s_k, 1.f, false);
    stage<T, D>(vs, v, k0, a.s_k, 1.f, false);
    if (threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      live_k[threadIdx.x] =
          kj < a.s_k &&
          (a.kv_mask == nullptr ||
           a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0);
    }
    __syncthreads();
    float s[kTile];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float part = half_dot<H>(qr, ks.x[j][half]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kj = k0 + j;
      const bool live = live_k[j] && !(a.causal && kj > qi);
      s[j] = live ? part : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = m <= kDead ? 0.f : expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < H; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = s[j] <= kDead ? 0.f : expf(s[j] - m_new);
      l += p;  // the normaliser takes the undropped p
      float pd = p;
      if (a.dropout) {
        pd = keep_bit(a.seed, bh, qi, k0 + j, a.threshold) ? p * a.drop_scale
                                                            : 0.f;
      }
      half_axpy<H>(acc, round_to<T>(pd), vs.x[j][half]);
    }
    m = m_new;
  }
  if (qvalid) {
    T* o = static_cast<T*>(a.out) + qbase + static_cast<long long>(qi) * D +
           half * H;
    const bool dead = l == 0.f;
    const float safe_l = dead ? 1.f : l;
#pragma unroll
    for (int d = 0; d < H; ++d) store(o + d, acc[d] / safe_l);
    if (half == 0) {
      a.lse[static_cast<long long>(bh) * a.s_q + qi] =
          dead ? kNegInf : m + logf(safe_l);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int H = D / 2;
  __shared__ __align__(16) Tile<H> ks;
  __shared__ __align__(16) Tile<H> vs;
  __shared__ uint8_t live_k[kTile];
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int qi = iq * kRows + row;
  const bool qvalid = qi < a.s_q;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const long long qoff = qbase + static_cast<long long>(qi) * D + half * H;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  float qr[H], dor[H], acc[H];
  float dpart = 0.f;
#pragma unroll
  for (int d = 0; d < H; ++d) {
    float qv = 0.f, dov = 0.f, ov = 0.f;
    if (qvalid) {
      qv = to_f32(static_cast<const T*>(a.q)[qoff + d]);
      dov = to_f32(static_cast<const T*>(a.dout)[qoff + d]);
      ov = to_f32(static_cast<const T*>(a.o)[qoff + d]);
    }
    qr[d] = round_to<T>(qv * a.scale);
    dor[d] = dov;
    dpart += dov * ov;
    acc[d] = 0.f;
  }
  const float delta = dpart + __shfl_xor_sync(0xffffffffu, dpart, 1);
  const long long srow = static_cast<long long>(bh) * a.s_q + qi;
  if (qvalid && half == 0) a.delta[srow] = delta;
  const float lse = qvalid ? a.lse_in[srow] : 0.f;
  const int k_end = a.causal ? min(a.s_k, (iq + 1) * kRows) : a.s_k;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage<T, D>(ks, k, k0, a.s_k, 1.f, false);
    stage<T, D>(vs, v, k0, a.s_k, 1.f, false);
    if (threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      live_k[threadIdx.x] =
          kj < a.s_k &&
          (a.kv_mask == nullptr ||
           a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float sp = half_dot<H>(qr, ks.x[j][half]);
      float dp = half_dot<H>(dor, vs.x[j][half]);
      sp += __shfl_xor_sync(0xffffffffu, sp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const int kj = k0 + j;
      const bool live = qvalid && live_k[j] && !(a.causal && kj > qi);
      const float s = live ? sp : kNegInf;
      const float p = s <= kDead ? 0.f : expf(s - lse);
      if (a.dropout) {
        dp = keep_bit(a.seed, bh, qi, kj, a.threshold) ? dp * a.drop_scale
                                                        : 0.f;
      }
      const float ds = p * (dp - delta);
      half_axpy<H>(acc, round_to<T>(ds), ks.x[j][half]);
    }
  }
  if (qvalid) {
    T* dq = static_cast<T*>(a.dq) + qoff;
#pragma unroll
    for (int d = 0; d < H; ++d) store(dq + d, acc[d] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int H = D / 2;
  __shared__ __align__(16) Tile<H> qs;   // round(q * scale)
  __shared__ __align__(16) Tile<H> dos;  // do
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  const int ik = blockIdx.x;  // low key tiles see the most queries: first
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int kj = ik * kRows + row;
  const bool kvalid = kj < a.s_k;
  const bool klive =
      kvalid && (a.kv_mask == nullptr ||
                 a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0);
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const long long koff = kbase + static_cast<long long>(kj) * D + half * H;
  const T* q = static_cast<const T*>(a.q) + qbase;
  const T* dout = static_cast<const T*>(a.dout) + qbase;

  float kr[H], vr[H], dk[H], dv[H];
#pragma unroll
  for (int d = 0; d < H; ++d) {
    kr[d] = kvalid ? to_f32(static_cast<const T*>(a.k)[koff + d]) : 0.f;
    vr[d] = kvalid ? to_f32(static_cast<const T*>(a.v)[koff + d]) : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  // causal: query qi sees key kj only when qi >= kj
  const int q_begin = a.causal ? (ik * kRows / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < a.s_q; q0 += kTile) {
    __syncthreads();
    stage<T, D>(qs, q, q0, a.s_q, a.scale, true);
    stage<T, D>(dos, dout, q0, a.s_q, 1.f, false);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      const bool ok = qi < a.s_q;
      const long long r = static_cast<long long>(bh) * a.s_q + qi;
      lse_s[threadIdx.x] = ok ? a.lse_in[r] : 0.f;
      delta_s[threadIdx.x] = ok ? a.delta[r] : 0.f;
    }
    __syncthreads();
    const int n_i = min(kTile, a.s_q - q0);
#pragma unroll 4
    for (int i = 0; i < n_i; ++i) {
      float sp = half_dot<H>(kr, qs.x[i][half]);
      float dp = half_dot<H>(vr, dos.x[i][half]);
      sp += __shfl_xor_sync(0xffffffffu, sp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const int qi = q0 + i;
      const bool live = klive && !(a.causal && kj > qi);
      const float s = live ? sp : kNegInf;
      const float p = s <= kDead ? 0.f : expf(s - lse_s[i]);
      float pd = p;
      if (a.dropout) {
        const bool kp = keep_bit(a.seed, bh, qi, kj, a.threshold);
        pd = kp ? p * a.drop_scale : 0.f;
        dp = kp ? dp * a.drop_scale : 0.f;
      }
      half_axpy<H>(dv, round_to<T>(pd), dos.x[i][half]);
      const float ds = p * (dp - delta_s[i]);
      half_axpy<H>(dk, round_to<T>(ds), qs.x[i][half]);
    }
  }
  if (kvalid) {
    T* dkp = static_cast<T*>(a.dk) + koff;
    T* dvp = static_cast<T*>(a.dv) + koff;
#pragma unroll
    for (int d = 0; d < H; ++d) {
      store(dkp + d, dk[d]);
      store(dvp + d, dv[d]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const Args& a, int bn, cudaStream_t s) {
  const dim3 grid((a.s_q + kRows - 1) / kRows, bn);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const Args& a, int bn, cudaStream_t s) {
  // dq first: it writes delta, which the dk/dv launch reads
  const dim3 gq((a.s_q + kRows - 1) / kRows, bn);
  flash_bwd_dq_kernel<T, D><<<gq, kThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 gk((a.s_k + kRows - 1) / kRows, bn);
  flash_bwd_dkv_kernel<T, D><<<gk, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool fwd, const Args& a, int d, int bn, cudaStream_t s) {
  // GPT-2's head dim; another d is refused before the launch
  if (d != 64) return cudaErrorInvalidValue;
  return fwd ? launch_fwd<T, 64>(a, bn, s) : launch_bwd<T, 64>(a, bn, s);
}

int run(bool fwd, const Args& a, int b, int d, int is_bf16, int device,
        void* stream) {
  if (b == 0 || a.n == 0 || a.s_q == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = b * a.n;
  e = is_bf16 ? dispatch<__nv_bfloat16>(fwd, a, d, bn, s)
              : dispatch<float>(fwd, a, d, bn, s);
  return static_cast<int>(e);
}

}  // namespace

// Forward: o [b, n, s_q, d] and lse [b, n, s_q] fp32. head dim d = 64;
// kv_mask may be null. Returns the cudaError_t of the launch.
extern "C" int apex_flash_attn_fwd(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* o, void* lse, int b, int n, int s_q,
                                   int s_k, int d, float scale, int causal,
                                   int dropout, uint32_t seed,
                                   uint32_t threshold, float drop_scale,
                                   int is_bf16, int device, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.out = o;
  a.lse = static_cast<float*>(lse);
  a.n = n;
  a.s_q = s_q;
  a.s_k = s_k;
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.threshold = threshold;
  a.drop_scale = drop_scale;
  return run(true, a, b, d, is_bf16, device, stream);
}

// Backward: dq, dk, dv from q, k, v, o, do and the forward's lse; delta is
// fp32 [b, n, s_q] scratch. Two launches (dq and delta, then dk and dv).
extern "C" int apex_flash_attn_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   const void* kv_mask, void* delta,
                                   void* dq, void* dk, void* dv, int b,
                                   int n, int s_q, int s_k, int d,
                                   float scale, int causal, int dropout,
                                   uint32_t seed, uint32_t threshold,
                                   float drop_scale, int is_bf16, int device,
                                   void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.n = n;
  a.s_q = s_q;
  a.s_k = s_k;
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.threshold = threshold;
  a.drop_scale = drop_scale;
  return run(false, a, b, d, is_bf16, device, stream);
}
