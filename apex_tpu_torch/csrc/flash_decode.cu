// Paged flash-decode: single-query attention over a paged KV pool, for
// Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_decode.py, _decode_pallas / _decode_kernel
// (the TPU kernel). Computes, per slot b and head h,
//   out[b, h] = softmax(q[b, h] . K[b, h, :kv_len]^T * scale) @ V[b, h, :kv_len]
// where token t of slot b lives in pool page page_table[b, t / page_size],
// row t % page_size. Pages are head-major [P, n, page_size, d]. A slot with
// kv_len == 0 writes zeros.
//
// What bounds it on the H100: device-memory bytes. Each call reads every
// live token's K and V row once (2 * d * elem bytes per token per head) and
// does 4 * d flops per token per head, about one flop per byte in bf16,
// far below the ~295 flop/byte at which the tensor cores would bind. The
// least time is the K/V bytes over 3.35 TB/s.
//
// Design against that bound:
// - The TPU grid (slot, page) ran the page axis in order and carried the
//   online-softmax state in VMEM scratch from one grid step to the next.
//   GPU blocks run in no order, so the token axis is split instead
//   (split-K): a block owns one (slot, head, split), split s covering
//   tokens [s * split_len, (s + 1) * split_len). The host plans the split
//   count from the static pages_per_seq * page_size and the SM count
//   (apex_tpu_torch/ops/flash_decode.py, decode_plan), never from kv_lens,
//   which would synchronise the serving step. The splits of one (slot,
//   head) form a thread block cluster (at most kMaxSplits blocks): each
//   keeps its online-softmax state (m, l, acc[d]) in its shared memory,
//   and after a cluster barrier the cluster's first block reads the
//   others' through distributed shared memory and merges them in split
//   order, skipping those that read no token (l = 0, a split at or past
//   its slot's kv_len). No scratch in device memory, no second launch, no
//   atomics: the order is fixed, so two runs give the same bits. With one
//   split the block writes the output itself.
// - A token row is read as 16-byte vectors by a group of LPR lanes (d 64
//   bf16: 8 lanes, so one warp load instruction covers 4 tokens), and
//   each group keeps kUnroll rows of K and V in flight before it reduces;
//   the score needs log2(LPR) shuffles. A head dim that is not a multiple
//   of the vector (or a pool that is not 16-byte aligned) is read element
//   by element.
// - The split's page ids are staged in shared memory (kPageStage at a
//   time; the first stage loaded beside kv_len, not after it) before its
//   token loop, so no K/V load waits on a page-table load of its own. K and
//   V rows stay packed in registers until used (bf16: half the registers,
//   so more blocks stay resident).
// - The block only visits tokens t < kv_len: no page past the length is
//   read (the TPU DMA'd them from the garbage page and gated them off), and
//   a masked position never touches the accumulator (stale V in a reused
//   page may hold anything, so it is skipped, not multiplied by zero).
// - Scores and accumulation are fp32, the softmax in base 2 with scale *
//   log2(e) folded into q (exp2f); q and the pages may be f32/f32,
//   bf16/bf16, fp16/fp16 or f32 q over 16-bit pages (no cast of the pool). The output
//   takes q's dtype. Each lane group's (m, l, acc) merges with the warp's
//   other groups by shuffles, then the warps' through shared memory, in
//   warp order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;        // warps per block
constexpr int kUnroll = 4;       // token rows a lane group loads per step
constexpr int kPageStage = 64;   // page ids staged in shared memory at once
constexpr int kMaxSplits = 8;    // blocks of a cluster (the portable most)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A 16-byte vector of a K or V row, kept as loaded (bf16 stays packed, so
// a lane holds kUnroll rows of K and V in half the registers) and widened
// to fp32 where it is used.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using Raw = float4;
  static constexpr int kN = 4;
};
template <> struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kN = 8;
};
// eight fp16 values, a type of their own so that unpack and pack pick the
// fp16 conversions
struct __align__(16) Half8 {
  uint4 u;
};
template <> struct Vec<__half> {
  using Raw = Half8;
  static constexpr int kN = 8;
};

__device__ __forceinline__ void unpack(const float4& r, float v[4]) {
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void unpack(const uint4& r, float v[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(b[i]);
    v[2 * i + 1] = __high2float(b[i]);
  }
}
__device__ __forceinline__ void unpack(const Half8& r, float v[8]) {
  const __half2* h = reinterpret_cast<const __half2*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(h[i]);
    v[2 * i + 1] = __high2float(h[i]);
  }
}
__device__ __forceinline__ void pack(const float v[4], float4& r) {
  r = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(const float v[8], uint4& r) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<unsigned*>(&b);
  }
  r = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void pack(const float v[8], Half8& r) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<unsigned*>(&h);
  }
  r.u = make_uint4(u[0], u[1], u[2], u[3]);
}

// The vector of a row at column c: one 16-byte load when `vec` (then d is
// a multiple of the vector, so a vector that starts inside the row ends
// inside it), else element by element (bf16 values repack exactly);
// columns at or past n read 0 (n = 0 for a token that is not read at all).
template <typename T>
__device__ __forceinline__ typename Vec<T>::Raw load_vec(const T* row, int c,
                                                         int n, bool vec) {
  constexpr int VW = Vec<T>::kN;
  typename Vec<T>::Raw r;
  float v[VW];
  if (vec && c < n) {
    r = *reinterpret_cast<const typename Vec<T>::Raw*>(row + c);
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e)
      v[e] = !vec && c + e < n ? to_f32(row[c + e]) : 0.f;
    pack(v, r);
  }
  return r;
}

// (m, l, acc) += (m2, l2, a2): online-softmax states in base 2; an empty
// state (l == 0, m == -inf) adds nothing.
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc,
                                            float m2, float l2,
                                            const float* a2) {
  if (l2 == 0.f) return;
  if (l == 0.f) {
    m = m2;
    l = l2;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = a2[e];
    return;
  }
  const float mx = fmaxf(m, m2);
  const float a = exp2f(m - mx);
  const float b = exp2f(m2 - mx);
  l = l * a + l2 * b;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = acc[e] * a + a2[e] * b;
  m = mx;
}

// LPR lanes read a token row, VPL 16-byte vectors each (LPR * VPL * VW >=
// head_dim). kCluster: launched in clusters of (1, n_splits, 1) blocks that
// merge their states; else one split (n_splits == 1), and no cluster code is
// compiled in (compiled in, it left the one-split bf16 kernel 80 registers
// and a spill where it takes 94, and cost it 10 % of its time at 64 slots x
// 1024 tokens, H100 80GB HBM3 at 700 W).
template <typename QT, typename KT, int LPR, int VPL, bool kCluster>
__global__ void __launch_bounds__(kWarps * 32)
    flash_decode_kernel(const QT* __restrict__ q,
                        const KT* __restrict__ k_pages,
                        const KT* __restrict__ v_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ kv_lens,
                        QT* __restrict__ out, int n_heads, int head_dim,
                        int page_size, int pages_per_seq, int n_splits,
                        int split_len, float scale_log2, int vec) {
  constexpr int VW = Vec<KT>::kN;  // elements of a 16-byte vector
  constexpr int EPL = VPL * VW;    // elements a lane holds of a row
  constexpr int TPW = 32 / LPR;    // token rows a warp reads at once
  using Raw = typename Vec<KT>::Raw;
  __shared__ int sm_pt[kPageStage];
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][LPR * EPL];
  // kCluster: the block's (m, l, acc)
  __shared__ float sm_split[kCluster ? 2 + LPR * EPL : 1];

  const int pair = blockIdx.x;  // slot * n_heads + head
  const int split = blockIdx.y;
  const int slot = pair / n_heads;
  const int head = pair % n_heads;
  const int t_begin = split * split_len;
  const int* pt = page_table + static_cast<long long>(slot) * pages_per_seq;
  // the split's first page ids, loaded beside kv_len rather than after it
  // (entries past a slot's length are valid pool indices, never followed)
  const int p_first = t_begin / page_size;
  const int p_last = min(pages_per_seq, (t_begin + split_len + page_size - 1) /
                                            page_size);
  const int kv_raw = kv_lens[slot];
  for (int i = threadIdx.x; i < min(kPageStage, p_last - p_first);
       i += blockDim.x)
    sm_pt[i] = pt[p_first + i];
  const int kv_len = min(kv_raw, page_size * pages_per_seq);
  // a split at or past kv_len reads nothing (t_end <= t_begin) and holds
  // l = 0; it stays to the cluster barrier
  const int t_end = min(kv_len, t_begin + split_len);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPR;  // the lane group's token row
  const int li = lane % LPR;   // the lane within it
  const long long qo = static_cast<long long>(pair) * head_dim;

  float qf[EPL], acc[EPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const int c = (j * LPR + li) * VW + e;
      qf[j * VW + e] = c < head_dim ? to_f32(q[qo + c]) * scale_log2 : 0.f;
      acc[j * VW + e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  const long long page_stride =
      static_cast<long long>(n_heads) * page_size * head_dim;
  const long long head_off = static_cast<long long>(head) * page_size *
                             head_dim;
  const int p_end = (t_end + page_size - 1) / page_size;  // live pages
  for (int p0 = p_first; p0 < p_end; p0 += kPageStage) {
    const int np = min(kPageStage, p_end - p0);
    if (p0 != p_first) {  // a split of more than kPageStage pages
      __syncthreads();    // the previous stage's ids are consumed
      for (int i = threadIdx.x; i < np; i += blockDim.x)
        sm_pt[i] = pt[p0 + i];
    }
    __syncthreads();
    const int c0 = max(t_begin, p0 * page_size);
    const int c1 = min(t_end, (p0 + np) * page_size);
    for (int base = c0 + warp * TPW * kUnroll; base < c1;
         base += kWarps * TPW * kUnroll) {
      Raw kr[kUnroll][VPL], vr[kUnroll][VPL];
      bool live[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + u * TPW + grp;
        live[u] = t < c1;
        long long row = 0;
        if (live[u]) {
          row = static_cast<long long>(sm_pt[t / page_size - p0]) *
                    page_stride +
                head_off + static_cast<long long>(t % page_size) * head_dim;
        }
        const int n = live[u] ? head_dim : 0;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int c = (j * LPR + li) * VW;
          kr[u][j] = load_vec<KT>(k_pages + row, c, n, vec);
          vr[u][j] = load_vec<KT>(v_pages + row, c, n, vec);
        }
      }
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          float kf[VW];
          unpack(kr[u][j], kf);
#pragma unroll
          for (int e = 0; e < VW; ++e) p += qf[j * VW + e] * kf[e];
        }
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        s[u] = p;
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (live[u]) m_new = fmaxf(m_new, s[u]);
      if (m_new != -INFINITY) {  // the group read a token this step
        const float alpha = exp2f(m - m_new);  // 0 before the first token
        l *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (live[u]) {  // positions past kv_len never reach acc
            const float p = exp2f(s[u] - m_new);
            l += p;
#pragma unroll
            for (int j = 0; j < VPL; ++j) {
              float vf[VW];
              unpack(vr[u][j], vf);
#pragma unroll
              for (int e = 0; e < VW; ++e) acc[j * VW + e] += p * vf[e];
            }
          }
        }
        m = m_new;
      }
    }
  }

  // the warp's lane groups, pairwise (group 0 ends with the warp's state)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    float a2[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      a2[e] = __shfl_xor_sync(0xffffffffu, acc[e], o);
    merge_state<EPL>(m, l, acc, m2, l2, a2);
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
#pragma unroll
      for (int e = 0; e < VW; ++e)
        sm_acc[warp][(j * LPR + li) * VW + e] = acc[j * VW + e];
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  __syncthreads();

  // the block's warps, in warp order (warps that read no token hold l == 0)
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (sm_l[w] > 0.f) mx = fmaxf(mx, sm_m[w]);
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (sm_l[w] > 0.f) den += exp2f(sm_m[w] - mx) * sm_l[w];
  for (int c = threadIdx.x; c < head_dim; c += blockDim.x) {
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (sm_l[w] > 0.f) num += exp2f(sm_m[w] - mx) * sm_acc[w][c];
    if (kCluster) {
      sm_split[2 + c] = num;
    } else {
      store(out + qo + c, den > 0.f ? num / den : 0.f);
    }
  }
  if (!kCluster) return;
  if (threadIdx.x == 0) {
    sm_split[0] = mx;
    sm_split[1] = den;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's state is in its shared memory
  if (cluster.block_rank() == 0) {
    // the splits in split order; those that read no token (l == 0) skipped
    float wt[kMaxSplits];  // each split's m, then its weight
    float ls[kMaxSplits];
    float gm = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      wt[r] = -INFINITY;
      ls[r] = 0.f;
      if (r < n_splits) {
        const float* st = cluster.map_shared_rank(sm_split, r);
        wt[r] = st[0];
        ls[r] = st[1];
      }
      if (ls[r] > 0.f) gm = fmaxf(gm, wt[r]);
    }
    float gden = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      wt[r] = ls[r] > 0.f ? exp2f(wt[r] - gm) : 0.f;
      gden += wt[r] * ls[r];
    }
    for (int c = threadIdx.x; c < head_dim; c += blockDim.x) {
      float num = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (ls[r] > 0.f)
          num += wt[r] * cluster.map_shared_rank(sm_split, r)[2 + c];
      store(out + qo + c, gden > 0.f ? num / gden : 0.f);
    }
  }
  cluster.sync();  // the others' shared memory outlives the first's reads
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename QT, typename KT, int LPR, int VPL>
cudaError_t launch_config(const void* q, const void* k, const void* v,
                          const int* pt, const int* lens, void* out,
                          int n_slots, int n_heads, int head_dim,
                          int page_size, int pages_per_seq, int n_splits,
                          int split_len, float scale_log2, int vec,
                          cudaStream_t stream) {
  if (n_splits == 1) {
    flash_decode_kernel<QT, KT, LPR, VPL, false>
        <<<n_slots * n_heads, kWarps * 32, 0, stream>>>(
            static_cast<const QT*>(q), static_cast<const KT*>(k),
            static_cast<const KT*>(v), pt, lens, static_cast<QT*>(out),
            n_heads, head_dim, page_size, pages_per_seq, 1, split_len,
            scale_log2, vec);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_slots * n_heads, n_splits);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<QT, KT, LPR, VPL, true>,
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), pt, lens, static_cast<QT*>(out), n_heads,
      head_dim, page_size, pages_per_seq, n_splits, split_len, scale_log2,
      vec);
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* pt, const int* lens, void* out,
                         int n_slots, int n_heads, int head_dim,
                         int page_size, int pages_per_seq, int n_splits,
                         int split_len, float scale, cudaStream_t stream) {
  constexpr int VW = Vec<KT>::kN;
  const int vec = head_dim % VW == 0 && aligned16(k) && aligned16(v);
  const int vecs = (head_dim + VW - 1) / VW;  // 16-byte vectors a row
#define APEX_FD_LAUNCH(LPR, VPL)                                             \
  launch_config<QT, KT, LPR, VPL>(q, k, v, pt, lens, out, n_slots, n_heads,  \
                                  head_dim, page_size, pages_per_seq,        \
                                  n_splits, split_len, scale * kLog2e, vec,  \
                                  stream)
  cudaError_t e;
  if (vecs <= 4) {
    e = APEX_FD_LAUNCH(4, 1);
  } else if (vecs <= 8) {
    e = APEX_FD_LAUNCH(8, 1);
  } else if (vecs <= 16) {
    e = APEX_FD_LAUNCH(16, 1);
  } else if (vecs <= 32) {
    e = APEX_FD_LAUNCH(32, 1);
  } else if (vecs <= 64) {
    e = APEX_FD_LAUNCH(32, 2);
  } else {
    return cudaErrorInvalidValue;
  }
#undef APEX_FD_LAUNCH
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller checks
// shapes, dtypes, devices and contiguity; every buffer is contiguous. The
// plan (n_splits <= 8 splits of split_len tokens, n_splits * split_len >=
// page_size * pages_per_seq) is the host's decode_plan.
extern "C" int apex_flash_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* kv_lens, void* out, int n_slots,
                                 int n_heads, int head_dim, int page_size,
                                 int pages_per_seq, int n_splits,
                                 int split_len, float scale, int q_dtype,
                                 int kv_dtype, int device, void* stream) {
  if (n_slots == 0) return 0;
  if (n_splits < 1 || n_splits > kMaxSplits || split_len < 1 ||
      static_cast<long long>(n_splits) * split_len <
          static_cast<long long>(page_size) * pages_per_seq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // q and pages in one dtype, or an fp32 q over 16-bit pages (dtype codes
  // 0 fp32, 1 bf16, 2 fp16); a 16-bit q over fp32 pages is not taken
#define APEX_FD_TYPED(QT, KT)                                               \
  launch_typed<QT, KT>(q, k_pages, v_pages, pt, lens, out, n_slots, n_heads, \
                       head_dim, page_size, pages_per_seq, n_splits,        \
                       split_len, scale, s)
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0) {
    err = APEX_FD_TYPED(float, float);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = APEX_FD_TYPED(__nv_bfloat16, __nv_bfloat16);
  } else if (q_dtype == 2 && kv_dtype == 2) {
    err = APEX_FD_TYPED(__half, __half);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    err = APEX_FD_TYPED(float, __nv_bfloat16);
  } else if (q_dtype == 0 && kv_dtype == 2) {
    err = APEX_FD_TYPED(float, __half);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef APEX_FD_TYPED
  return static_cast<int>(err);
}
