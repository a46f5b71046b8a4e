// Flash attention forward and backward in bf16 and fp16 on Hopper's tensor
// cores (sm_90a), at head dims 32, 64, 96, 128 and 256.
//
// Replaces: apex_tpu/ops/flash_attention.py, the TPU kernels _fwd_kernel
// (launched by _fwd, :390) and _bwd_dq_kernel / _bwd_dkv_kernel (launched by
// _bwd, :673), for bf16 and fp16 inputs (one template, the element type T a
// template argument); fp32 inputs keep the CUDA-core kernels of
// flash_attention.cu, whose entry points call launch_tc below. The
// arithmetic is that file's (see its header): scores from round(q * scale),
// plus the additive bias in fp32, then the causal, kv-mask and segment masks
// as -1e30, everything at or below -5e29 counted masked, the murmur3 dropout
// bit keep_bit(seed, b * n + h, q, k), lse in natural log, o = 0 and lse =
// -1e30 for a fully masked row (a -1e30 folded into the bias included).
//
// Numerics. The TPU kernels make every product a dot_general of 16-bit
// operands with fp32 accumulation: s = round(q * scale) . k^T, o += T(p)
// . v (p after the dropout scale), dp = do . v^T, dq += T(ds) . k, dv +=
// T(p_dropped)^T . do, dk += T(ds)^T . round(q * scale). mma.sync
// m16n8k16 with bf16 or fp16 operands and fp32 accumulators computes exactly
// those products; only the order of the sums differs. The softmax's
// exponentials are exp2f of scores times log2(e) (a few fp32 ulps).
//
// What bounds it on the H100: the tensor cores. At the GPT-2 345M shape
// ([8, 16, 1024, 64] causal) the forward's ~17 GFLOP take 0.017 ms at 989
// TFLOP/s against ~0.02 ms for its ~68 MB; the backward's ~43 GFLOP
// (five products) 0.043 ms. These kernels use mma.sync, whose rate on
// Hopper is below wgmma's, and seven products in the backward (the two
// launches each recompute the scores), so they stay well above that bound.
// A bias adds its bytes (read once by the forward, twice by the backward)
// and, with its gradient, the fp32 dbias that the dq launch writes.
//
// Design. One block of four warps owns 64 rows; each warp owns 16 of them,
// one m16 slice of every product, and walks the other operand's tiles
// through a two-stage cp.async ring in shared memory (rows past the end
// zero-filled). Each fragment element takes its bias and mask from its own
// coordinates (row grp or grp + 8 of its warp's slice, column 2 tig or
// 2 tig + 1 of its n tile); tiles that need no mask skip the test. A bias
// broadcast over query rows (a key-padding bias [b, 1, 1, s_k]) is read once
// a tile into shared memory by the query-major launches and once a block
// into registers by the key-major one; any other bias is read per element
// (each row's elements of a tile are neighbours). Segment ids are
// non-decreasing, so the keys a query tile can see are one contiguous range,
// bounded by the ids of its first and last rows (block_count_below): every
// launch walks only the tiles of that range, and packed sequences cost about
// the sum of their squared lengths rather than the square of the total.
// Each kernel is built twice, with that code (kX) and without it: the
// bias and segment checks cost a plain causal batch 5-12% of its time
// when they were runtime branches (H100 80GB HBM3, 700 W; PERF.md).
// - forward: query-major. s = Q K^T in registers, the online softmax across
//   the four lanes of a quad, P rounded to T in registers as the A operand
//   of O += P V (V through ldmatrix.trans). Causal blocks stop at the
//   diagonal; the longest rows go first.
// - backward, dq: query-major, the same walk; s = Q K^T and dp = dO V^T,
//   p = exp(s - lse), ds = p (dp - delta), dQ += T(ds) K (K through
//   ldmatrix.trans). It computes delta = rowsum(do * o) in fp32 and writes
//   it for the next launch; with a bias gradient it writes ds (fp32, no
//   scale) into dbias, each element once, as the TPU dq kernel does.
// - backward, dk/dv: key-major, walking query tiles with their lse and
//   delta. It computes s^T = K Q^T and dp^T = V dO^T directly, so P^T and
//   dS^T land in the accumulator layout that dV += T(P^T) dO and dK +=
//   T(dS^T) Q take as A (dO and Q through ldmatrix.trans); the bias, the
//   masks, the dropout bit and the dead test use the transposed coordinates.
// Two launches, no atomics: every output element is summed (and every dbias
// element written) by one thread in a fixed order, so the backward is
// deterministic.
//
// Tiles. The accumulators of a warp's 16 rows take D / 2 floats a thread per
// output, a score tile (its width) / 2. The forward walks 64 keys a tile (32
// at D = 256); dq walks 32 keys and dk/dv 32 queries a tile at D >= 64 (64
// at D = 32). Two m16 slices a warp (reusing each K and V fragment twice)
// took the forward from 128 to 252 registers and ran slower; other tile
// widths measured within 3% (PERF.md). At D = 256 dK and dV together
// would need 256 floats a thread, so the dk/dv kernel walks the query tiles
// twice: dV first (s^T and P^T), then dK (s^T again, dp^T); one more product
// (six instead of five in that launch).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "hash_dropout.cuh"  // keep_bit, the dropout hash
#include "mma_bf16.cuh"

namespace apex_flash {
namespace {

using mma_bf16::bf16;
using mma_bf16::c_to_a;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::f16;
using mma_bf16::load_a;
using mma_bf16::load_b_kn;
using mma_bf16::load_b_nk;
using mma_bf16::mma;
using mma_bf16::pack;
using mma_bf16::to_f32;
using mma_bf16::unpack;

constexpr int kThreads = 128;  // four warps, 16 rows each
constexpr int kRows = 64;      // the rows a block owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

template <int D>
struct Geo {
  static constexpr int kFwdKeys = D == 256 ? 32 : 64;  // forward's k/v tile
  static constexpr int kDqKeys = D >= 64 ? 32 : 64;    // dq's k/v tile
  static constexpr int kQueries = D >= 64 ? 32 : 64;   // dk/dv's q/do tile
  static constexpr bool kTwoPass = D == 256;           // dk/dv: dV, then dK
  static constexpr int kLd = mma_bf16::ld<D>();
  // q, k and v rings, then a tile's key bias (fp32), key ids and live flags
  static constexpr int kFwdSmem = (kRows + 4 * kFwdKeys) * kLd * 2 +
                                  kFwdKeys * (4 + 4 + 1);
  static constexpr int kDqSmem =
      (2 * kRows + 4 * kDqKeys) * kLd * 2 + kDqKeys * (4 + 4 + 1);
  // k, v, the q and do rings, then a tile's lse, delta and query ids
  static constexpr int kDkvSmem =
      (2 * kRows + 4 * kQueries) * kLd * 2 + 3 * kQueries * 4;
};

// Rows [r0, r0 + R) of a [rows, D] matrix into a shared tile by cp.async;
// rows past the end are zero-filled.
template <int R, int D, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int r0,
                                          int rows) {
  constexpr int kChunks = D / 8, kLd = mma_bf16::ld<D>();
  static_assert(R * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = r0 + r < rows;
    const T* from =
        ok ? src + static_cast<long long>(r0 + r) * D + ch * 8 : src;
    mma_bf16::cp_async_16(dst + r * kLd + ch * 8, from, ok);
  }
}

// x -> round_T(x * scale) over a shared tile of R rows, in place: the TPU
// kernel's _scaled_q (the scale applied in fp32, rounded to the dtype).
template <int R, int D, typename T>
__device__ __forceinline__ void scale_tile(T* tile, float scale) {
  constexpr int kChunks = D / 8, kLd = mma_bf16::ld<D>();
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    uint4* p = reinterpret_cast<uint4*>(tile + (c / kChunks) * kLd +
                                        (c % kChunks) * 8);
    uint4 v = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack<T>(w[j]);
      w[j] = pack<T>(f.x * scale, f.y * scale);
    }
    *p = v;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The 16 x D accumulator of a warp's rows [r0, r0 + 16), times mul, rounded
// into rows below `rows` of a [rows, D] matrix of T.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&acc)[D / 8][4],
                                           int r0, int rows, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    T* row = dst + static_cast<long long>(r) * D + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          pack<T>(acc[dt][2 * h] * mul, acc[dt][2 * h + 1] * mul);
    }
  }
}

// What a block knows of its (batch, head) beyond q, k and v: the offset of
// its bias plane, its rows of segment ids.
struct Plane {
  long long bias;    // ib * bias_sb + ih * bias_sh
  const int* seg_q;  // this batch row's ids, or null
  const int* seg_k;
};

template <bool kX>
__device__ __forceinline__ Plane plane_of(const Args& a, int bh) {
  if (!kX) return Plane{0, nullptr, nullptr};
  const int ib = bh / a.n, ih = bh % a.n;
  Plane p;
  p.bias = ib * a.bias_sb + ih * a.bias_sh;
  p.seg_q = a.seg_q ? a.seg_q + ib * a.seg_sb_q : nullptr;
  p.seg_k = a.seg_k ? a.seg_k + ib * a.seg_sb_k : nullptr;
  return p;
}

// Adds the bias to the 16 x (8 NT) score tile of a warp. Row r of the tile
// is r0 + r of the warp's own operand, column c is c0 + c of the walked one;
// kKeyMajor: rows are keys, columns queries. col_bias (shared, per column)
// and row_bias (registers, per row) hold a bias broadcast over query rows;
// otherwise each element reads its own.
template <int NT, bool kKeyMajor>
__device__ __forceinline__ void add_bias(float (&s)[NT][4], const Args& a,
                                         long long plane, int r0, int c0,
                                         const float* col_bias,
                                         const float (&row_bias)[2]) {
  const int lane = threadIdx.x % 32;
  const bool bcast = a.bias_sq == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (lane >> 2) + 8 * (e >> 1);
      const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
      const int qi = kKeyMajor ? c0 + c : r, kj = kKeyMajor ? r : c0 + c;
      if (bcast) {
        s[nt][e] += kKeyMajor ? row_bias[e >> 1] : col_bias[c];
      } else if (qi < a.s_q && kj < a.s_k) {
        s[nt][e] += bias_at(a, plane + qi * a.bias_sq + kj);
      }
    }
  }
}

// Masks the 16 x (8 NT) score tile of a warp whose element (row, column)
// pairs query qi with key kj: causal kj > qi, a dead key (live == false:
// past s_k or kv_mask 0), a query past s_q, a query and key of different
// segments (col_seg non-null: the ids of the walked operand's tile, row_seg
// those of the thread's two rows). Coordinates as add_bias.
template <int NT, bool kKeyMajor>
__device__ __forceinline__ void mask_tile(float (&s)[NT][4], const Args& a,
                                          int r0, int c0, const uint8_t* live,
                                          const bool (&row_live)[2],
                                          const int* col_seg,
                                          const int (&row_seg)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (lane >> 2) + 8 * (e >> 1);
      const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
      bool ok;
      if (kKeyMajor) {  // rows are keys, columns queries
        const int qi = c0 + c;
        ok = row_live[e >> 1] && qi < a.s_q && !(a.causal && r > qi);
      } else {  // rows are queries, columns keys
        const int kj = c0 + c;
        ok = kj < a.s_k && (a.kv_mask == nullptr || live[c]) &&
             !(a.causal && kj > r);
      }
      if (col_seg != nullptr) ok = ok && col_seg[c] == row_seg[e >> 1];
      if (!ok) s[nt][e] = kNegInf;
    }
  }
}

// The key tiles [j0, j0 + n) of width BN that the query rows [q0, q0 +
// kRows) visit: up to the causal diagonal, within the range of keys whose
// segment can match. Every thread of the block calls it.
template <int BN, bool kX>
__device__ __forceinline__ void key_tiles(const Args& a, const Plane& pl,
                                          int q0, int* j0, int* n) {
  int k_begin = 0;
  int k_end = a.causal ? min(a.s_k, q0 + kRows) : a.s_k;
  if (kX && pl.seg_q != nullptr) {
    int lo, hi;
    segment_range(pl.seg_q, q0, min(q0 + kRows, a.s_q), pl.seg_k, a.s_k, &lo,
                  &hi);
    k_begin = lo;
    k_end = min(k_end, hi);
  }
  *j0 = k_begin / BN;
  *n = k_end > *j0 * BN ? (k_end - *j0 * BN + BN - 1) / BN : 0;
}

// The segment ids of a warp's two rows per thread (r0 + lane / 4 + 8 h), or
// -1 past the end or without ids.
__device__ __forceinline__ void row_ids(const int* seg, int r0, int rows,
                                        int (&out)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    out[h] = seg != nullptr && r < rows ? seg[r] : -1;
  }
}

// One thread per key of the tile at k0 (threads below BN): the key's live
// flag, segment id and (for a bias broadcast over query rows) bias.
template <int BN, bool kX>
__device__ __forceinline__ void stage_keys(const Args& a, const Plane& pl,
                                           int k0, uint8_t* live, int* kseg,
                                           float* kbias) {
  if (threadIdx.x >= BN) return;
  const int kj = k0 + threadIdx.x;
  const bool in = kj < a.s_k;
  const int ib = blockIdx.y / a.n;
  if (a.kv_mask != nullptr)
    live[threadIdx.x] =
        in && a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0;
  if (!kX) return;
  if (pl.seg_k != nullptr) kseg[threadIdx.x] = in ? pl.seg_k[kj] : -2;
  if (a.bias != nullptr && a.bias_sq == 0)
    kbias[threadIdx.x] = in ? bias_at(a, pl.bias + kj) : 0.f;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D, bool kX>
__global__ void __launch_bounds__(kThreads) flash_fwd_tc_kernel(Args a) {
  using G = Geo<D>;
  constexpr int BN = G::kFwdKeys, LD = G::kLd, NT = BN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kRows * LD;  // two stages
  T* vs = ks + 2 * BN * LD;
  float* kbias = reinterpret_cast<float*>(vs + 2 * BN * LD);
  int* kseg = reinterpret_cast<int*>(kbias + BN);
  uint8_t* live = reinterpret_cast<uint8_t*>(kseg + BN);

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * kRows, w0 = q0 + warp * 16;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;
  const Plane pl = plane_of<kX>(a, bh);
  int j0, n_tiles;
  key_tiles<BN, kX>(a, pl, q0, &j0, &n_tiles);
  const bool need_mask = a.kv_mask != nullptr || pl.seg_q != nullptr;

  copy_tile<kRows, D>(qs, static_cast<const T*>(a.q) + qbase, q0, a.s_q);
  cp_async_commit();
  if (n_tiles > 0) {
    copy_tile<BN, D>(ks, k, j0 * BN, a.s_k);
    copy_tile<BN, D>(vs, v, j0 * BN, a.s_k);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  scale_tile<kRows, D>(qs, a.scale);  // the first tile's barrier publishes it

  const bool no_live[2] = {true, true};
  const float no_bias[2] = {0.f, 0.f};
  int rseg[2];
  row_ids(pl.seg_q, w0, a.s_q, rseg);
  float o[DT][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (j0 + j) * BN;
    const T* kt = ks + (j & 1) * BN * LD;
    const T* vt = vs + (j & 1) * BN * LD;
    if (j + 1 < n_tiles) {
      copy_tile<BN, D>(ks + ((j + 1) & 1) * BN * LD, k, k0 + BN, a.s_k);
      copy_tile<BN, D>(vs + ((j + 1) & 1) * BN * LD, v, k0 + BN, a.s_k);
    }
    cp_async_commit();
    stage_keys<BN, kX>(a, pl, k0, live, kseg, kbias);
    cp_async_wait<1>();
    __syncthreads();

    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      load_a<LD>(qa, qs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        load_b_nk<LD>(kb, kt, np * 16, kk * 16, lane);
        mma<T>(s[2 * np], qa, kb[0], kb[1]);
        mma<T>(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
    if (kX && a.bias != nullptr)
      add_bias<NT, false>(s, a, pl.bias, w0, k0, kbias, no_bias);
    if (k0 + BN > a.s_k || need_mask || (a.causal && k0 + BN - 1 > w0)) {
      mask_tile<NT, false>(s, a, w0, k0, live, no_live,
                           pl.seg_q != nullptr ? kseg : nullptr, rseg);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = m[h] <= kDead ? 0.f : exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
      const float mb = m_new * kLog2e;
      const int qi = w0 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * h + e];
          const float p = x <= kDead ? 0.f : exp2f(fmaf(x, kLog2e, -mb));
          l[h] += p;  // the normaliser takes the undropped p
          x = p;
          if (a.dropout) {
            const int kj = k0 + nt * 8 + 2 * (lane & 3) + e;
            x = keep_bit(a.seed, bh, qi, kj, a.threshold) ? p * a.drop_scale
                                                           : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      c_to_a<T>(pa, s, kk);  // p rounded to T after the dropout scale
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        load_b_kn<LD>(vb, vt, kk * 16, dp * 16, lane);
        mma<T>(o[2 * dp], pa, vb[0], vb[1]);
        mma<T>(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(a.out) + qbase;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    const int qi = w0 + (lane >> 2) + 8 * h;
    if (qi >= a.s_q) continue;
    const bool dead = lh == 0.f;
    const float safe_l = dead ? 1.f : lh;
    T* row = out + static_cast<long long>(qi) * D + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          pack<T>(o[dt][2 * h] / safe_l, o[dt][2 * h + 1] / safe_l);
    }
    if ((lane & 3) == 0) {
      a.lse[static_cast<long long>(bh) * a.s_q + qi] =
          dead ? kNegInf : m[h] + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq (and delta, and dbias)
// ---------------------------------------------------------------------------

template <typename T, int D, bool kX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(Args a) {
  using G = Geo<D>;
  constexpr int BN = G::kDqKeys, LD = G::kLd, NT = BN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kRows * LD;
  T* ks = dos + kRows * LD;  // two stages
  T* vs = ks + 2 * BN * LD;
  float* kbias = reinterpret_cast<float*>(vs + 2 * BN * LD);
  int* kseg = reinterpret_cast<int*>(kbias + BN);
  uint8_t* live = reinterpret_cast<uint8_t*>(kseg + BN);

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * kRows, w0 = q0 + warp * 16;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const T* k = static_cast<const T*>(a.k) + kbase;
  const T* v = static_cast<const T*>(a.v) + kbase;
  const T* dout = static_cast<const T*>(a.dout) + qbase;
  const Plane pl = plane_of<kX>(a, bh);
  int j0, n_tiles;
  key_tiles<BN, kX>(a, pl, q0, &j0, &n_tiles);
  const bool need_mask = a.kv_mask != nullptr || pl.seg_q != nullptr;
  float* dbias = kX && a.dbias != nullptr
                     ? a.dbias + static_cast<long long>(bh) * a.s_q * a.s_k
                     : nullptr;

  copy_tile<kRows, D>(qs, static_cast<const T*>(a.q) + qbase, q0, a.s_q);
  copy_tile<kRows, D>(dos, dout, q0, a.s_q);
  cp_async_commit();
  if (n_tiles > 0) {
    copy_tile<BN, D>(ks, k, j0 * BN, a.s_k);
    copy_tile<BN, D>(vs, v, j0 * BN, a.s_k);
  }
  cp_async_commit();

  // delta = rowsum(do * o) in fp32 for the warp's rows, written for the
  // dk/dv launch; lse of the thread's two rows, in log2 units
  const T* o = static_cast<const T*>(a.o) + qbase;
  float delta[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int qi = w0 + r;
    float part = 0.f;
    if (qi < a.s_q) {
      for (int d = lane; d < D; d += 32) {
        const long long at = static_cast<long long>(qi) * D + d;
        part += to_f32(dout[at]) * to_f32(o[at]);
      }
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, x);
    if (r == (lane >> 2)) delta[0] = part;
    if (r == (lane >> 2) + 8) delta[1] = part;
    if (lane == 0 && qi < a.s_q)
      a.delta[static_cast<long long>(bh) * a.s_q + qi] = part;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = w0 + (lane >> 2) + 8 * h;
    if (qi < a.s_q)
      lse2[h] = a.lse_in[static_cast<long long>(bh) * a.s_q + qi] * kLog2e;
  }
  cp_async_wait<1>();
  __syncthreads();
  scale_tile<kRows, D>(qs, a.scale);

  const bool no_live[2] = {true, true};
  const float no_bias[2] = {0.f, 0.f};
  int rseg[2];
  row_ids(pl.seg_q, w0, a.s_q, rseg);
  float acc[DT][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (j0 + j) * BN;
    const T* kt = ks + (j & 1) * BN * LD;
    const T* vt = vs + (j & 1) * BN * LD;
    if (j + 1 < n_tiles) {
      copy_tile<BN, D>(ks + ((j + 1) & 1) * BN * LD, k, k0 + BN, a.s_k);
      copy_tile<BN, D>(vs + ((j + 1) & 1) * BN * LD, v, k0 + BN, a.s_k);
    }
    cp_async_commit();
    stage_keys<BN, kX>(a, pl, k0, live, kseg, kbias);
    cp_async_wait<1>();
    __syncthreads();

    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, qs, warp * 16, kk * 16, lane);
      load_a<LD>(da, dos, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4], vb[4];
        load_b_nk<LD>(kb, kt, np * 16, kk * 16, lane);
        load_b_nk<LD>(vb, vt, np * 16, kk * 16, lane);
        mma<T>(s[2 * np], qa, kb[0], kb[1]);
        mma<T>(s[2 * np + 1], qa, kb[2], kb[3]);
        mma<T>(dp[2 * np], da, vb[0], vb[1]);
        mma<T>(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    if (kX && a.bias != nullptr)
      add_bias<NT, false>(s, a, pl.bias, w0, k0, kbias, no_bias);
    if (k0 + BN > a.s_k || need_mask || (a.causal && k0 + BN - 1 > w0)) {
      mask_tile<NT, false>(s, a, w0, k0, live, no_live,
                           pl.seg_q != nullptr ? kseg : nullptr, rseg);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qi = w0 + (lane >> 2) + 8 * h;
        const int kj = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const float x = s[nt][e];
        const float p = x <= kDead ? 0.f : exp2f(fmaf(x, kLog2e, -lse2[h]));
        float d = dp[nt][e];
        if (a.dropout) {
          d = keep_bit(a.seed, bh, qi, kj, a.threshold) ? d * a.drop_scale
                                                         : 0.f;
        }
        const float ds = p * (d - delta[h]);
        s[nt][e] = ds;
        if (dbias != nullptr && qi < a.s_q && kj < a.s_k)
          dbias[static_cast<long long>(qi) * a.s_k + kj] = ds;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t sa[4];
      c_to_a<T>(sa, s, kk);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kb[4];
        load_b_kn<LD>(kb, kt, kk * 16, dd * 16, lane);
        mma<T>(acc[2 * dd], sa, kb[0], kb[1]);
        mma<T>(acc[2 * dd + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<D>(static_cast<T*>(a.dq) + qbase, acc, w0, a.s_q, a.scale);
}

// ---------------------------------------------------------------------------
// backward, dk and dv
// ---------------------------------------------------------------------------

// A warp's key rows, per thread (w0 + lane / 4 + 8 h): alive (inside s_k,
// kv_mask set), their segment ids and, for a bias broadcast over query rows,
// their bias.
struct KeyRows {
  bool live[2];
  int seg[2];
  float bias[2];
};

// One walk of the dk/dv kernel over the query tiles [q_begin, q_end): adds
// T(P^T dropped) dO into dv when kDV, T(dS^T) Q into dk when kDK.
template <int D, bool kDV, bool kDK, bool kX, typename T>
__device__ __forceinline__ void dkv_walk(const Args& a, int bh,
                                         const Plane& pl, int w0,
                                         const KeyRows& kr, int q_begin,
                                         int q_end, const T* ks, const T* vs,
                                         T* qs, T* dos, float* lse2_s,
                                         float* delta_s, int* qseg_s,
                                         float (&dv)[D / 8][4],
                                         float (&dk)[D / 8][4]) {
  using G = Geo<D>;
  constexpr int BQ = G::kQueries, LD = G::kLd, NT = BQ / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const T* q = static_cast<const T*>(a.q) + qbase;
  const T* dout = static_cast<const T*>(a.dout) + qbase;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  // rows that need a mask whatever the query tile
  const bool rows_masked = a.kv_mask != nullptr || pl.seg_q != nullptr ||
                           w0 + 16 > a.s_k;

  if (n_tiles > 0) {
    copy_tile<BQ, D>(qs, q, q_begin, a.s_q);
    copy_tile<BQ, D>(dos, dout, q_begin, a.s_q);
  }
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * BQ;
    T* qt = qs + (j & 1) * BQ * LD;
    const T* dt = dos + (j & 1) * BQ * LD;
    if (j + 1 < n_tiles) {
      copy_tile<BQ, D>(qs + ((j + 1) & 1) * BQ * LD, q, q0 + BQ, a.s_q);
      copy_tile<BQ, D>(dos + ((j + 1) & 1) * BQ * LD, dout, q0 + BQ, a.s_q);
    }
    cp_async_commit();
    if (threadIdx.x < BQ) {
      const int qi = q0 + threadIdx.x;
      const bool ok = qi < a.s_q;
      const long long r = static_cast<long long>(bh) * a.s_q + qi;
      lse2_s[threadIdx.x] = ok ? a.lse_in[r] * kLog2e : 0.f;
      delta_s[threadIdx.x] = ok ? a.delta[r] : 0.f;
      if (kX && pl.seg_q != nullptr)
        qseg_s[threadIdx.x] = ok ? pl.seg_q[qi] : -2;
    }
    cp_async_wait<1>();
    __syncthreads();
    scale_tile<BQ, D>(qt, a.scale);
    __syncthreads();

    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, ks, warp * 16, kk * 16, lane);
      if (kDK) load_a<LD>(va, vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t qb[4];
        load_b_nk<LD>(qb, qt, np * 16, kk * 16, lane);
        mma<T>(s[2 * np], ka, qb[0], qb[1]);
        mma<T>(s[2 * np + 1], ka, qb[2], qb[3]);
        if (kDK) {
          uint32_t db[4];
          load_b_nk<LD>(db, dt, np * 16, kk * 16, lane);
          mma<T>(dp[2 * np], va, db[0], db[1]);
          mma<T>(dp[2 * np + 1], va, db[2], db[3]);
        }
      }
    }
    if (kX && a.bias != nullptr)
      add_bias<NT, true>(s, a, pl.bias, w0, q0, nullptr, kr.bias);
    if (rows_masked || q0 + BQ > a.s_q || (a.causal && w0 + 15 > q0)) {
      mask_tile<NT, true>(s, a, w0, q0, nullptr, kr.live,
                          pl.seg_q != nullptr ? qseg_s : nullptr, kr.seg);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
        const float x = s[nt][e];
        const float p = x <= kDead ? 0.f : exp2f(fmaf(x, kLog2e, -lse2_s[c]));
        float pd = p, d = dp[nt][e];
        if (a.dropout) {
          const int kj = w0 + (lane >> 2) + 8 * (e >> 1);
          const bool keep = keep_bit(a.seed, bh, q0 + c, kj, a.threshold);
          pd = keep ? p * a.drop_scale : 0.f;
          d = keep ? d * a.drop_scale : 0.f;
        }
        s[nt][e] = pd;
        dp[nt][e] = p * (d - delta_s[c]);  // ds^T
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      if (kDV) c_to_a<T>(pa, s, kk);
      if (kDK) c_to_a<T>(sa, dp, kk);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        if (kDV) {
          uint32_t ob[4];
          load_b_kn<LD>(ob, dt, kk * 16, dd * 16, lane);
          mma<T>(dv[2 * dd], pa, ob[0], ob[1]);
          mma<T>(dv[2 * dd + 1], pa, ob[2], ob[3]);
        }
        if (kDK) {
          uint32_t qb[4];
          load_b_kn<LD>(qb, qt, kk * 16, dd * 16, lane);
          mma<T>(dk[2 * dd], sa, qb[0], qb[1]);
          mma<T>(dk[2 * dd + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <typename T, int D, bool kX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(Args a) {
  using G = Geo<D>;
  constexpr int BQ = G::kQueries, LD = G::kLd, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kRows * LD;
  T* qs = vs + kRows * LD;  // two stages, round(q * scale)
  T* dos = qs + 2 * BQ * LD;
  float* lse2_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);
  float* delta_s = lse2_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);

  const int ik = blockIdx.x;  // low key tiles see the most queries: first
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = ik * kRows, w0 = k0 + warp * 16;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const Plane pl = plane_of<kX>(a, bh);
  copy_tile<kRows, D>(ks, static_cast<const T*>(a.k) + kbase, k0, a.s_k);
  copy_tile<kRows, D>(vs, static_cast<const T*>(a.v) + kbase, k0, a.s_k);
  cp_async_commit();

  KeyRows kr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = w0 + (lane >> 2) + 8 * h;
    const bool in = kj < a.s_k;
    kr.live[h] = in && (a.kv_mask == nullptr ||
                        a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] !=
                            0);
    kr.seg[h] = kX && pl.seg_k != nullptr && in ? pl.seg_k[kj] : -1;
    kr.bias[h] = kX && a.bias != nullptr && a.bias_sq == 0 && in
                     ? bias_at(a, pl.bias + kj)
                     : 0.f;
  }
  // causal: query qi sees key kj only when qi >= kj; segments: only the
  // queries whose ids can match the block's keys
  int q_begin = a.causal ? (k0 / BQ) * BQ : 0, q_end = a.s_q;
  if (kX && pl.seg_q != nullptr) {
    int lo, hi;
    segment_range(pl.seg_k, k0, min(k0 + kRows, a.s_k), pl.seg_q, a.s_q, &lo,
                  &hi);
    q_begin = max(q_begin, lo);
    q_end = hi;
  }
  T* dk_out = static_cast<T*>(a.dk) + kbase;
  T* dv_out = static_cast<T*>(a.dv) + kbase;
  if (G::kTwoPass) {
    {
      float dv[DT][4] = {};
      dkv_walk<D, true, false, kX>(a, bh, pl, w0, kr, q_begin, q_end, ks, vs, qs,
                               dos, lse2_s, delta_s, qseg_s, dv, dv);
      store_rows<D>(dv_out, dv, w0, a.s_k, 1.f);
    }
    float dk[DT][4] = {};
    dkv_walk<D, false, true, kX>(a, bh, pl, w0, kr, q_begin, q_end, ks, vs, qs,
                             dos, lse2_s, delta_s, qseg_s, dk, dk);
    store_rows<D>(dk_out, dk, w0, a.s_k, 1.f);
  } else {
    float dk[DT][4] = {}, dv[DT][4] = {};
    dkv_walk<D, true, true, kX>(a, bh, pl, w0, kr, q_begin, q_end, ks, vs, qs,
                            dos, lse2_s, delta_s, qseg_s, dv, dk);
    store_rows<D>(dv_out, dv, w0, a.s_k, 1.f);
    store_rows<D>(dk_out, dk, w0, a.s_k, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB is refused at launch unless allowed,
// once per kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, int device, bool* ready) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) ready[device] = true;
  return e;
}

template <typename T, int D, bool kX>
cudaError_t launch_fwd(const Args& a, int bn, int device, cudaStream_t s) {
  static bool ready[kMaxDevices];
  constexpr int kSmem = Geo<D>::kFwdSmem;
  cudaError_t e =
      allow_smem(flash_fwd_tc_kernel<T, D, kX>, kSmem, device, ready);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s_q + kRows - 1) / kRows, bn);
  flash_fwd_tc_kernel<T, D, kX><<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kX>
cudaError_t launch_bwd(const Args& a, int bn, int device, cudaStream_t s) {
  static bool ready_dq[kMaxDevices], ready_dkv[kMaxDevices];
  constexpr int kDq = Geo<D>::kDqSmem, kDkv = Geo<D>::kDkvSmem;
  cudaError_t e =
      allow_smem(flash_bwd_dq_tc_kernel<T, D, kX>, kDq, device, ready_dq);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dkv_tc_kernel<T, D, kX>, kDkv, device,
                 ready_dkv);
  if (e != cudaSuccess) return e;
  // dq first: it writes delta, which the dk/dv launch reads
  const dim3 gq((a.s_q + kRows - 1) / kRows, bn);
  flash_bwd_dq_tc_kernel<T, D, kX><<<gq, kThreads, kDq, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.s_k == 0) return e;
  const dim3 gk((a.s_k + kRows - 1) / kRows, bn);
  flash_bwd_dkv_tc_kernel<T, D, kX><<<gk, kThreads, kDkv, s>>>(a);
  return cudaGetLastError();
}

// The kernels with the bias and segment code (kX) where the call has a
// bias, segment ids or a dbias to write, else the kernels without it, so
// the attention of a plain causal or padded batch runs none of it.
template <typename T, int D>
cudaError_t launch(bool fwd, const Args& a, int bn, int device,
                   cudaStream_t s) {
  const bool x = a.bias != nullptr || a.seg_q != nullptr ||
                 a.dbias != nullptr;
  if (fwd)
    return x ? launch_fwd<T, D, true>(a, bn, device, s)
             : launch_fwd<T, D, false>(a, bn, device, s);
  return x ? launch_bwd<T, D, true>(a, bn, device, s)
           : launch_bwd<T, D, false>(a, bn, device, s);
}

template <typename T>
cudaError_t launch_typed(bool fwd, const Args& a, int bn, int d, int device,
                         cudaStream_t s) {
  // the instantiated head dims (KERNEL_HEAD_DIMS of the wrapper)
  switch (d) {
#define APEX_FLASH_D(D) \
  case D:               \
    return launch<T, D>(fwd, a, bn, device, s);
    APEX_FLASH_D(32)
    APEX_FLASH_D(64)
    APEX_FLASH_D(96)
    APEX_FLASH_D(128)
    APEX_FLASH_D(256)
#undef APEX_FLASH_D
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_tc(bool fwd, const Args& a, int bn, int d, int dtype,
                      int device, cudaStream_t stream) {
  switch (dtype) {
    case kBF16: return launch_typed<bf16>(fwd, a, bn, d, device, stream);
    case kF16: return launch_typed<f16>(fwd, a, bn, d, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace apex_flash
