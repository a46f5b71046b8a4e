// The numerics monitor's row statistics for Hopper (sm_90a): per ROW of
// 1024 elements of a flat buffer, in one read of it, the sum of squares, the
// largest magnitude and the count of non-finite elements of x * inv_scale.
//
// Replaces: apex_tpu/ops/packed_optimizer.py, packed_row_stats (:654, the
// TPU kernel launched at :699). Per row r, with s = x * inv_scale in fp32
// (one rounding):
//   sq[r] = sum s * s      ma[r] = max |s|      nf[r] = #{s not finite}
// all three fp32. The reductions are raw, as the TPU kernel's: a nan in a
// row makes its sq and ma nan (the max keeps a nan, as jnp.max does, where
// fmaxf would drop it), an inf makes them inf; nf counts exactly. The
// products and sums are rounded one by one (__fmul_rn / __fadd_rn); the sums
// run in a fixed order, so a row's sq is the same from run to run.
//
// inv_scale is an fp32 scalar in device memory, read on the card: the
// monitor takes 1 / loss_scale from the scaler's state without a host read.
//
// The input need not fill whole rows: the last row is cut at n, and the
// elements past n are not read (the TPU kernel's zero padding adds nothing
// to any of the three).
//
// What bounds it on the H100: bytes. It reads 2 (bf16) or 4 (fp32) bytes an
// element and writes 12 bytes a row, against ~4 operations an element.
// Design: one warp a row (packed_lamb.cu's row reduce and packed_flat.cu's
// sweep): each lane takes every 32nd group of four consecutive elements
// (16-byte fp32 or 8-byte bf16 loads, a warp covering 512 contiguous bytes
// at a time), keeps its three partials, and the warp combines them with
// butterflies of shuffles; a grid-stride loop over rows.
#include "packed_sweep.cuh"

namespace {

using packed_sweep::load4;

constexpr int kRow = 1024;              // PackSpec's ROW
constexpr int kGroups = kRow / 4 / 32;  // groups of four a lane owns in a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using packed_sweep::to_f32;

// max that keeps a nan (a nan operand wins)
__device__ __forceinline__ float max_nan(float acc, float x) {
  return (x > acc || x != x) ? x : acc;
}

struct Stats {
  float sq, ma;
  int nf;
};

__device__ __forceinline__ void fold(Stats& st, float x, float inv) {
  const float s = __fmul_rn(x, inv);
  st.sq = __fadd_rn(st.sq, __fmul_rn(s, s));
  st.ma = max_nan(st.ma, fabsf(s));
  st.nf += isfinite(s) ? 0 : 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_stats_kernel(const T* __restrict__ x, float* __restrict__ sq,
                     float* __restrict__ ma, float* __restrict__ nf,
                     const float* __restrict__ inv_p, long long n,
                     long long rows) {
  const float inv = *inv_p;
  const int lane = threadIdx.x & 31;
  const long long warp0 =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = warp0; r < rows; r += n_warps) {
    Stats st{0.f, 0.f, 0};
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long e = r * kRow + (k * 32 + lane) * 4;  // first element
      if (e + 4 <= n) {
        float v[4];
        load4(x, e / 4, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) fold(st, v[j], inv);
      } else {
        for (long long i = e; i < n && i < e + 4; ++i)
          fold(st, to_f32(x[i]), inv);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      st.sq = __fadd_rn(st.sq, __shfl_xor_sync(0xffffffffu, st.sq, off));
      st.ma = max_nan(st.ma, __shfl_xor_sync(0xffffffffu, st.ma, off));
      st.nf += __shfl_xor_sync(0xffffffffu, st.nf, off);
    }
    if (lane == 0) {
      sq[r] = st.sq;
      ma[r] = st.ma;
      nf[r] = static_cast<float>(st.nf);
    }
  }
}

}  // namespace

// Per-row statistics of x * inv_scale over n elements (x fp32, bf16 or fp16,
// 16-byte aligned): sq, ma and nf are fp32 [(n + 1023) / 1024]; inv_scale
// points to an fp32 device scalar. Returns the cudaError_t of the launch.
extern "C" int apex_packed_row_stats(const void* x, void* sq, void* ma,
                                     void* nf, const void* inv_scale,
                                     long long n, int x_dtype, int device,
                                     void* stream) {
  if (n == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (n + kRow - 1) / kRow;
  const long long want = (rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  float* sqf = static_cast<float*>(sq);
  float* maf = static_cast<float*>(ma);
  float* nff = static_cast<float*>(nf);
  const float* inv = static_cast<const float*>(inv_scale);
  e = packed_sweep::by_dtype(x_dtype, [&](auto tx) {
    using T = typename decltype(tx)::type;
    row_stats_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), sqf, maf, nff, inv, n, rows);
    return cudaSuccess;
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
