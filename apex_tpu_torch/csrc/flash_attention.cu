// Flash attention forward and backward for Hopper (sm_90a): the fp32 kernels
// on the CUDA cores, and the entry points of both dtypes.
//
// Replaces: apex_tpu/ops/flash_attention.py, the TPU kernels _fwd_kernel
// (launched by _fwd, :390) and _bwd_dq_kernel / _bwd_dkv_kernel (launched by
// _bwd, :673). Layout [b, n, s, d], contiguous; q, k, v, o, do and the
// gradients share one dtype (fp32, bf16 or fp16); the lse is [b, n, s_q]
// fp32. bf16 and fp16 inputs go to the tensor-core kernels of
// flash_attention_bf16.cu (launch_tc); fp32 inputs stay on the kernels
// below, since a tensor core would round fp32 operands to TF32.
//
//   s   = (round(q * scale)) . k + bias     fp32; masked to -1e30 (causal
//                                           ki > qi, kv_mask[b, ki] == 0,
//                                           seg_q[qi] != seg_k[ki])
//   o   = dropout(softmax(s)) @ v           p rounded to the input dtype
//                                           before the product, as the TPU
//                                           kernel's p.astype(v.dtype)
//   lse = m + log(l), -1e30 and o = 0 for a fully masked row
//
// The backward recomputes p = exp(s - lse) from the saved lse, with
// delta = rowsum(do * o) in fp32 and ds = p * (dp * keep / (1 - p_drop) -
// delta); dv = p_drop^T do, dk = ds^T round(q * scale), dq = ds k * scale.
// Every score at or below -5e29 counts as masked (p = 0), so a fully masked
// row has zero gradients, never NaN. With a bias gradient the dq kernel
// writes ds (fp32, before the scale) into dbias [b, n, s_q, s_k], each
// element once; the wrapper sums it over the bias's broadcast dims. Segment
// ids are non-decreasing, so each block walks only the tiles of the other
// operand whose ids can match its own (segment_range). Dropout keeps (q, k)
// when the murmur3
// hash of (seed, b * n + h, global q, global k) in uint32 arithmetic is at
// least round(p_drop * 2^32): the TPU kernel's _keep_mask bit for bit, the
// same bits in forward and backward.
//
// What bounds it on the H100: arithmetic. These kernels do their products in
// fp32 on the CUDA cores, so at the GPT-2 345M shape ([8, 16, 1024, 64],
// causal) the ~17 GFLOP forward and ~43 GFLOP backward cost far more than
// the ~64 MB they move.
//
// Design. The TPU grid ran (b, h, q-tile, k-tile) in order and carried the
// online-softmax state and the dk/dv sums in VMEM across the last grid axis.
// GPU blocks run in no order, so each block owns its rows and loops over the
// other axis itself, with nothing carried between blocks and no atomics:
// - forward: one block per (b, h, R query rows); P threads per row, each
//   holding a D/P slice of the scaled q row and of the output accumulator
//   in registers; key/value tiles of KT rows are staged in shared memory as
//   fp32 and read as broadcasts; the running max and sum live per row, and
//   the tile's KT scores sit in registers between the max and the sum pass;
// - backward, dq: one block per (b, h, R query rows), the same layout over
//   key tiles; it also computes delta (written for the next launch);
// - backward, dk/dv: one block per (b, h, R key rows); P threads per key
//   row hold a slice of k, v, dk, dv in registers and loop over query tiles
//   staged in shared memory with their lse and delta.
// The P slices of a row combine their partial dot products with a butterfly
// of warp shuffles. Causal blocks skip the tiles that lie wholly above the
// diagonal.
//
// Head dims. The geometry (P, R, KT) is chosen per head dim D (Geo below)
// so that a thread's slice stays at most 32 floats: the dk/dv kernel keeps
// four slices (k, v, dk, dv) in registers, 128 floats, within the 255
// registers a thread may hold; and two staged tiles stay under the 48 KB
// of static shared memory. D = 32, 64: 2 threads a row, 64 rows a block;
// D = 96, 128: 4 threads a row, 64 rows; D = 256: 8 threads a row, 32 rows
// and tiles of 16 rows (36,864 bytes of tiles). Other head dims are refused
// before the launch (flash_attention_available in the wrapper).
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"  // Args, kNegInf, kDead, launch_tc
#include "hash_dropout.cuh"     // keep_bit, the dropout hash

namespace {

using apex_flash::Args;
using apex_flash::bias_at;
using apex_flash::kDead;
using apex_flash::kNegInf;
using apex_flash::segment_range;

// Threads per row P (a power of two, so a row's threads share a warp), rows
// a block owns R, rows of the other operand per staged tile KT.
template <int D>
struct Geo;
template <>
struct Geo<32> { static constexpr int P = 2, R = 64, KT = 32; };
template <>
struct Geo<64> { static constexpr int P = 2, R = 64, KT = 32; };
template <>
struct Geo<96> { static constexpr int P = 4, R = 64, KT = 32; };
template <>
struct Geo<128> { static constexpr int P = 4, R = 64, KT = 32; };
template <>
struct Geo<256> { static constexpr int P = 8, R = 32, KT = 16; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// x rounded to T and back: the TPU kernel's astype(dtype) before a dot
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

// The offset of a block's (batch, head) bias plane and its rows of segment
// ids (null without ids).
struct Plane {
  long long bias;
  const int* seg_q;
  const int* seg_k;
};

__device__ __forceinline__ Plane plane_of(const Args& a, int bh) {
  const int ib = bh / a.n, ih = bh % a.n;
  Plane p;
  p.bias = ib * a.bias_sb + ih * a.bias_sh;
  p.seg_q = a.seg_q ? a.seg_q + ib * a.seg_sb_q : nullptr;
  p.seg_k = a.seg_k ? a.seg_k + ib * a.seg_sb_k : nullptr;
  return p;
}

// The bias of score (qi, kj) of a plane, 0 without a bias.
__device__ __forceinline__ float bias_of(const Args& a, const Plane& pl,
                                         int qi, int kj) {
  return a.bias != nullptr ? bias_at(a, pl.bias + qi * a.bias_sq + kj) : 0.f;
}

// A row split in P slices of H floats, each slice padded by 4 floats so
// the P slices of one row start in different banks (the P threads of a row
// read them in the same instruction) and stay 16-byte aligned.
template <int KT, int P, int H>
struct Tile {
  float x[KT][P][H + 4];
};

// The sum of a partial over the P threads of a row (neighbouring lanes).
template <int P>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int o = 1; o < P; o <<= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

template <int H>
__device__ __forceinline__ float slice_dot(const float* a, const float* b) {
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
__device__ __forceinline__ void slice_axpy(float* acc, float a,
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

// Stage rows [r0, r0 + KT) of a [rows, D] matrix into a Tile as fp32
// (times mul, then rounded to T when round_q: the scaled q); rows past the
// end are zero.
template <typename T, int D, typename G = Geo<D>>
__device__ __forceinline__ void stage(Tile<G::KT, G::P, D / G::P>& dst,
                                      const T* src, int r0, int rows,
                                      float mul, bool round_q) {
  constexpr int H = D / G::P;
  for (int e = threadIdx.x; e < G::KT * D; e += G::R * G::P) {
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

// The keys [*k_begin, *k_end) that query rows [q0, q0 + rows) visit: up to
// the causal diagonal, within the range whose segment ids can match. Every
// thread of the block calls it.
template <int kTile>
__device__ __forceinline__ void key_range(const Args& a, const Plane& pl,
                                          int q0, int rows, int* k_begin,
                                          int* k_end) {
  *k_begin = 0;
  *k_end = a.causal ? min(a.s_k, q0 + rows) : a.s_k;
  if (pl.seg_q != nullptr) {
    int lo, hi;
    segment_range(pl.seg_q, q0, min(q0 + rows, a.s_q), pl.seg_k, a.s_k, &lo,
                  &hi);
    *k_begin = lo;
    *k_end = min(*k_end, hi);
  }
}

// One thread per key of the tile at k0 (threads below kTile): whether it is
// alive (inside s_k, kv_mask set) and its segment id.
template <int kTile>
__device__ __forceinline__ void stage_keys(const Args& a, const Plane& pl,
                                           int ib, int k0, uint8_t* live,
                                           int* seg) {
  if (threadIdx.x >= kTile) return;
  const int kj = k0 + threadIdx.x;
  const bool in = kj < a.s_k;
  live[threadIdx.x] =
      in && (a.kv_mask == nullptr ||
             a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0);
  if (pl.seg_k != nullptr) seg[threadIdx.x] = in ? pl.seg_k[kj] : -2;
}

template <typename T, int D, typename G = Geo<D>>
__global__ void __launch_bounds__(G::R * G::P) flash_fwd_kernel(Args a) {
  constexpr int P = G::P, H = D / P, kRows = G::R, kTile = G::KT;
  __shared__ __align__(16) Tile<kTile, P, H> ks;
  __shared__ __align__(16) Tile<kTile, P, H> vs;
  __shared__ uint8_t live_k[kTile];
  __shared__ int seg_k[kTile];
  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int row = threadIdx.x / P;
  const int slice = threadIdx.x % P;
  const int qi = iq * kRows + row;
  const bool qvalid = qi < a.s_q;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const Plane pl = plane_of(a, bh);
  const int qseg = pl.seg_q != nullptr && qvalid ? pl.seg_q[qi] : -1;
  const T* q = static_cast<const T*>(a.q) + qbase;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;

  float qr[H], acc[H];
#pragma unroll
  for (int d = 0; d < H; ++d) {
    qr[d] = qvalid ? round_to<T>(to_f32(q[static_cast<long long>(qi) * D +
                                           slice * H + d]) * a.scale)
                   : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  int k_begin, k_end;
  key_range<kTile>(a, pl, iq * kRows, kRows, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage<T, D>(ks, k, k0, a.s_k, 1.f, false);
    stage<T, D>(vs, v, k0, a.s_k, 1.f, false);
    stage_keys<kTile>(a, pl, ib, k0, live_k, seg_k);
    __syncthreads();
    float s[kTile];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float part = slice_dot<H>(qr, ks.x[j][slice]);
      part = row_sum<P>(part);
      const int kj = k0 + j;
      const bool live = live_k[j] && !(a.causal && kj > qi) &&
                        (pl.seg_q == nullptr || seg_k[j] == qseg);
      s[j] = live ? part + bias_of(a, pl, qi, kj) : kNegInf;
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
      slice_axpy<H>(acc, round_to<T>(pd), vs.x[j][slice]);
    }
    m = m_new;
  }
  if (qvalid) {
    T* o = static_cast<T*>(a.out) + qbase + static_cast<long long>(qi) * D +
           slice * H;
    const bool dead = l == 0.f;
    const float safe_l = dead ? 1.f : l;
#pragma unroll
    for (int d = 0; d < H; ++d) store(o + d, acc[d] / safe_l);
    if (slice == 0) {
      a.lse[static_cast<long long>(bh) * a.s_q + qi] =
          dead ? kNegInf : m + logf(safe_l);
    }
  }
}

template <typename T, int D, typename G = Geo<D>>
__global__ void __launch_bounds__(G::R * G::P) flash_bwd_dq_kernel(Args a) {
  constexpr int P = G::P, H = D / P, kRows = G::R, kTile = G::KT;
  __shared__ __align__(16) Tile<kTile, P, H> ks;
  __shared__ __align__(16) Tile<kTile, P, H> vs;
  __shared__ uint8_t live_k[kTile];
  __shared__ int seg_k[kTile];
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int row = threadIdx.x / P;
  const int slice = threadIdx.x % P;
  const int qi = iq * kRows + row;
  const bool qvalid = qi < a.s_q;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const Plane pl = plane_of(a, bh);
  const int qseg = pl.seg_q != nullptr && qvalid ? pl.seg_q[qi] : -1;
  float* dbias = a.dbias != nullptr
                     ? a.dbias + static_cast<long long>(bh) * a.s_q * a.s_k +
                           static_cast<long long>(qi) * a.s_k
                     : nullptr;
  const long long qoff = qbase + static_cast<long long>(qi) * D + slice * H;
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
  const float delta = row_sum<P>(dpart);
  const long long srow = static_cast<long long>(bh) * a.s_q + qi;
  if (qvalid && slice == 0) a.delta[srow] = delta;
  const float lse = qvalid ? a.lse_in[srow] : 0.f;
  int k_begin, k_end;
  key_range<kTile>(a, pl, iq * kRows, kRows, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage<T, D>(ks, k, k0, a.s_k, 1.f, false);
    stage<T, D>(vs, v, k0, a.s_k, 1.f, false);
    stage_keys<kTile>(a, pl, ib, k0, live_k, seg_k);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float sp = slice_dot<H>(qr, ks.x[j][slice]);
      float dp = slice_dot<H>(dor, vs.x[j][slice]);
      sp = row_sum<P>(sp);
      dp = row_sum<P>(dp);
      const int kj = k0 + j;
      const bool live = qvalid && live_k[j] && !(a.causal && kj > qi) &&
                        (pl.seg_q == nullptr || seg_k[j] == qseg);
      const float s = live ? sp + bias_of(a, pl, qi, kj) : kNegInf;
      const float p = s <= kDead ? 0.f : expf(s - lse);
      if (a.dropout) {
        dp = keep_bit(a.seed, bh, qi, kj, a.threshold) ? dp * a.drop_scale
                                                        : 0.f;
      }
      const float ds = p * (dp - delta);
      if (dbias != nullptr && qvalid && slice == 0 && kj < a.s_k)
        dbias[kj] = ds;
      slice_axpy<H>(acc, round_to<T>(ds), ks.x[j][slice]);
    }
  }
  if (qvalid) {
    T* dq = static_cast<T*>(a.dq) + qoff;
#pragma unroll
    for (int d = 0; d < H; ++d) store(dq + d, acc[d] * a.scale);
  }
}

template <typename T, int D, typename G = Geo<D>>
__global__ void __launch_bounds__(G::R * G::P) flash_bwd_dkv_kernel(Args a) {
  constexpr int P = G::P, H = D / P, kRows = G::R, kTile = G::KT;
  __shared__ __align__(16) Tile<kTile, P, H> qs;   // round(q * scale)
  __shared__ __align__(16) Tile<kTile, P, H> dos;  // do
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  __shared__ int seg_q[kTile];
  const int ik = blockIdx.x;  // low key tiles see the most queries: first
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int row = threadIdx.x / P;
  const int slice = threadIdx.x % P;
  const int kj = ik * kRows + row;
  const bool kvalid = kj < a.s_k;
  const Plane pl = plane_of(a, bh);
  const int kseg = pl.seg_k != nullptr && kvalid ? pl.seg_k[kj] : -1;
  const bool klive =
      kvalid && (a.kv_mask == nullptr ||
                 a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0);
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const long long koff = kbase + static_cast<long long>(kj) * D + slice * H;
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
  // causal: query qi sees key kj only when qi >= kj; segments: only the
  // queries whose ids can match the block's keys
  int q_begin = a.causal ? (ik * kRows / kTile) * kTile : 0, q_end = a.s_q;
  if (pl.seg_q != nullptr) {
    int lo, hi;
    segment_range(pl.seg_k, ik * kRows, min((ik + 1) * kRows, a.s_k),
                  pl.seg_q, a.s_q, &lo, &hi);
    q_begin = max(q_begin, lo);
    q_end = hi;
  }
  for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
    __syncthreads();
    stage<T, D>(qs, q, q0, a.s_q, a.scale, true);
    stage<T, D>(dos, dout, q0, a.s_q, 1.f, false);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      const bool ok = qi < a.s_q;
      const long long r = static_cast<long long>(bh) * a.s_q + qi;
      lse_s[threadIdx.x] = ok ? a.lse_in[r] : 0.f;
      delta_s[threadIdx.x] = ok ? a.delta[r] : 0.f;
      if (pl.seg_q != nullptr) seg_q[threadIdx.x] = ok ? pl.seg_q[qi] : -2;
    }
    __syncthreads();
    const int n_i = min(kTile, q_end - q0);
#pragma unroll 4
    for (int i = 0; i < n_i; ++i) {
      float sp = slice_dot<H>(kr, qs.x[i][slice]);
      float dp = slice_dot<H>(vr, dos.x[i][slice]);
      sp = row_sum<P>(sp);
      dp = row_sum<P>(dp);
      const int qi = q0 + i;
      const bool live = klive && !(a.causal && kj > qi) &&
                        (pl.seg_q == nullptr || seg_q[i] == kseg);
      const float s = live ? sp + bias_of(a, pl, qi, kj) : kNegInf;
      const float p = s <= kDead ? 0.f : expf(s - lse_s[i]);
      float pd = p;
      if (a.dropout) {
        const bool kp = keep_bit(a.seed, bh, qi, kj, a.threshold);
        pd = kp ? p * a.drop_scale : 0.f;
        dp = kp ? dp * a.drop_scale : 0.f;
      }
      slice_axpy<H>(dv, round_to<T>(pd), dos.x[i][slice]);
      const float ds = p * (dp - delta_s[i]);
      slice_axpy<H>(dk, round_to<T>(ds), qs.x[i][slice]);
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
  using G = Geo<D>;
  const dim3 grid((a.s_q + G::R - 1) / G::R, bn);
  flash_fwd_kernel<T, D><<<grid, G::R * G::P, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const Args& a, int bn, cudaStream_t s) {
  using G = Geo<D>;
  // dq first: it writes delta, which the dk/dv launch reads
  const dim3 gq((a.s_q + G::R - 1) / G::R, bn);
  flash_bwd_dq_kernel<T, D><<<gq, G::R * G::P, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 gk((a.s_k + G::R - 1) / G::R, bn);
  flash_bwd_dkv_kernel<T, D><<<gk, G::R * G::P, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(bool fwd, const Args& a, int bn, cudaStream_t s) {
  return fwd ? launch_fwd<T, D>(a, bn, s) : launch_bwd<T, D>(a, bn, s);
}

cudaError_t dispatch_f32(bool fwd, const Args& a, int d, int bn,
                         cudaStream_t s) {
  // the instantiated head dims (KERNEL_HEAD_DIMS of the wrapper); another d
  // is refused before the launch
  switch (d) {
    case 32: return launch<float, 32>(fwd, a, bn, s);
    case 64: return launch<float, 64>(fwd, a, bn, s);
    case 96: return launch<float, 96>(fwd, a, bn, s);
    case 128: return launch<float, 128>(fwd, a, bn, s);
    case 256: return launch<float, 256>(fwd, a, bn, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool fwd, const Args& a, int b, int d, int dtype, int device,
        void* stream) {
  if (b == 0 || a.n == 0 || a.s_q == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = b * a.n;
  e = dtype == apex_flash::kF32
          ? dispatch_f32(fwd, a, d, bn, s)
          : apex_flash::launch_tc(fwd, a, bn, d, dtype, device, s);
  return static_cast<int>(e);
}

// The inputs both passes share: the bias (pointer, dtype code, batch, head
// and row strides in elements) and the segment ids (batch strides).
void set_extras(Args& a, const void* bias, int bias_dtype, long long bias_sb,
                long long bias_sh, long long bias_sq, const void* seg_q,
                const void* seg_k, long long seg_sb_q, long long seg_sb_k) {
  a.bias = bias;
  a.bias_dtype = bias_dtype;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  a.bias_sq = bias_sq;
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.seg_sb_q = seg_sb_q;
  a.seg_sb_k = seg_sb_k;
}

}  // namespace

// Forward: o [b, n, s_q, d] and lse [b, n, s_q] fp32. head dim d one of 32,
// 64, 96, 128, 256; dtype 0 fp32, 1 bf16, 2 fp16; kv_mask, bias and the
// segment ids may be null (the ids come in pairs). Returns the cudaError_t of
// the launch.
extern "C" int apex_flash_attn_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask,
    const void* bias, const void* seg_q, const void* seg_k, void* o,
    void* lse, int b, int n, int s_q, int s_k, int d, float scale,
    int causal, int dropout, uint32_t seed, uint32_t threshold,
    float drop_scale, int bias_dtype, long long bias_sb, long long bias_sh,
    long long bias_sq, long long seg_sb_q, long long seg_sb_k, int dtype,
    int device, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  set_extras(a, bias, bias_dtype, bias_sb, bias_sh, bias_sq, seg_q, seg_k,
             seg_sb_q, seg_sb_k);
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
  return run(true, a, b, d, dtype, device, stream);
}

// Backward: dq, dk, dv from q, k, v, o, do and the forward's lse; delta is
// fp32 [b, n, s_q] scratch; dbias, when not null, fp32 [b, n, s_q, s_k]
// zeroed by the caller, receives ds. Two launches (dq, delta and dbias, then
// dk and dv).
extern "C" int apex_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_mask, const void* bias,
    const void* seg_q, const void* seg_k, void* delta, void* dq, void* dk,
    void* dv, void* dbias, int b, int n, int s_q, int s_k, int d,
    float scale, int causal, int dropout, uint32_t seed, uint32_t threshold,
    float drop_scale, int bias_dtype, long long bias_sb, long long bias_sh,
    long long bias_sq, long long seg_sb_q, long long seg_sb_k, int dtype,
    int device, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  set_extras(a, bias, bias_dtype, bias_sb, bias_sh, bias_sq, seg_q, seg_k,
             seg_sb_q, seg_sb_k);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias = static_cast<float*>(dbias);
  a.n = n;
  a.s_q = s_q;
  a.s_k = s_k;
  a.scale = scale;
  a.causal = causal;
  a.dropout = dropout;
  a.seed = seed;
  a.threshold = threshold;
  a.drop_scale = drop_scale;
  return run(false, a, b, d, dtype, device, stream);
}
