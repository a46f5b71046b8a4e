// Flash attention forward and backward in bf16 on Hopper's tensor cores
// (sm_90a), at head dims 32, 64, 96, 128 and 256.
//
// Replaces: apex_tpu/ops/flash_attention.py, the TPU kernels _fwd_kernel
// (launched by _fwd, :390) and _bwd_dq_kernel / _bwd_dkv_kernel (launched by
// _bwd, :673), for bf16 inputs; fp32 inputs keep the CUDA-core kernels of
// flash_attention.cu, whose entry points call launch_bf16 below. The
// arithmetic is that file's (see its header): scores from round(q * scale),
// -1e30 for masked scores and everything at or below -5e29 counted masked,
// the murmur3 dropout bit keep_bit(seed, b * n + h, q, k), lse in natural
// log, o = 0 and lse = -1e30 for a fully masked row.
//
// Numerics. The TPU kernels make every product a dot_general of bf16
// operands with fp32 accumulation: s = round(q * scale) . k^T, o += bf16(p)
// . v (p after the dropout scale), dp = do . v^T, dq += bf16(ds) . k, dv +=
// bf16(p_dropped)^T . do, dk += bf16(ds)^T . round(q * scale). mma.sync
// m16n8k16 with bf16 operands and fp32 accumulators computes exactly those
// products; only the order of the sums differs. The softmax's exponentials
// are exp2f of scores times log2(e) (a few fp32 ulps).
//
// What bounds it on the H100: the tensor cores. At the GPT-2 345M shape
// ([8, 16, 1024, 64] causal) the forward's ~17 GFLOP take 0.017 ms at 989
// TFLOP/s against ~0.02 ms for its ~68 MB; the backward's ~43 GFLOP
// (five products) 0.043 ms. These kernels use mma.sync, whose rate on
// Hopper is below wgmma's, and seven products in the backward (the two
// launches each recompute the scores), so they stay well above that bound.
//
// Design. One block of four warps owns 64 rows; each warp owns 16 of them,
// one m16 slice of every product, and walks the other operand's tiles
// through a two-stage cp.async ring in shared memory (rows past the end
// zero-filled). Each fragment element takes its mask from its own
// coordinates (row grp or grp + 8 of its warp's slice, column 2 tig or
// 2 tig + 1 of its n tile); tiles that need no mask skip the test.
// - forward: query-major. s = Q K^T in registers, the online softmax across
//   the four lanes of a quad, P rounded to bf16 in registers as the A
//   operand of O += P V (V through ldmatrix.trans). Causal blocks stop at
//   the diagonal; the longest rows go first.
// - backward, dq: query-major, the same walk; s = Q K^T and dp = dO V^T,
//   p = exp(s - lse), ds = p (dp - delta), dQ += bf16(ds) K (K through
//   ldmatrix.trans). It computes delta = rowsum(do * o) in fp32 and writes
//   it for the next launch.
// - backward, dk/dv: key-major, walking query tiles with their lse and
//   delta. It computes s^T = K Q^T and dp^T = V dO^T directly, so P^T and
//   dS^T land in the accumulator layout that dV += bf16(P^T) dO and dK +=
//   bf16(dS^T) Q take as A (dO and Q through ldmatrix.trans); the masks, the
//   dropout bit and the dead test use the transposed coordinates.
// Two launches, no atomics: every output element is summed by one thread in
// a fixed order, so the backward is deterministic.
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
using mma_bf16::load_a;
using mma_bf16::load_b_kn;
using mma_bf16::load_b_nk;
using mma_bf16::mma;
using mma_bf16::pack;

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
  static constexpr int kFwdSmem =  // q, k and v rings, live flags
      (kRows + 4 * kFwdKeys) * kLd * 2 + kFwdKeys;
  static constexpr int kDqSmem =
      (2 * kRows + 4 * kDqKeys) * kLd * 2 + kDqKeys;
  static constexpr int kDkvSmem =
      (2 * kRows + 4 * kQueries) * kLd * 2 + 2 * kQueries * 4;
};

// Rows [r0, r0 + R) of a [rows, D] bf16 matrix into a shared tile by
// cp.async; rows past the end are zero-filled.
template <int R, int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int r0,
                                          int rows) {
  constexpr int kChunks = D / 8, kLd = mma_bf16::ld<D>();
  static_assert(R * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = r0 + r < rows;
    const bf16* from =
        ok ? src + static_cast<long long>(r0 + r) * D + ch * 8 : src;
    mma_bf16::cp_async_16(dst + r * kLd + ch * 8, from, ok);
  }
}

// x -> round_bf16(x * scale) over a shared tile of R rows, in place: the TPU
// kernel's _scaled_q (the scale applied in fp32, rounded to the dtype).
template <int R, int D>
__device__ __forceinline__ void scale_tile(bf16* tile, float scale) {
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
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      w[j] = pack(f.x * scale, f.y * scale);
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
// into rows below `rows` of a [rows, D] bf16 matrix.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[D / 8][4],
                                           int r0, int rows, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    bf16* row = dst + static_cast<long long>(r) * D + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          pack(acc[dt][2 * h] * mul, acc[dt][2 * h + 1] * mul);
    }
  }
}

// Masks the 16 x (8 NT) score tile of a warp whose element (row, column)
// pairs query qi with key kj: causal kj > qi, a dead key (live == false:
// past s_k or kv_mask 0), a query past s_q. Row r of the tile is r0 + r of
// the warp's own operand; column c is c0 + c of the walked one.
template <int NT, bool kKeyMajor>
__device__ __forceinline__ void mask_tile(float (&s)[NT][4], const Args& a,
                                          int r0, int c0, const uint8_t* live,
                                          const bool (&row_live)[2]) {
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
      if (!ok) s[nt][e] = kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_tc_kernel(Args a) {
  using G = Geo<D>;
  constexpr int BN = G::kFwdKeys, LD = G::kLd, NT = BN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * LD;  // two stages
  bf16* vs = ks + 2 * BN * LD;
  uint8_t* live = reinterpret_cast<uint8_t*>(vs + 2 * BN * LD);

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * kRows, w0 = q0 + warp * 16;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const bf16* k = static_cast<const bf16*>(a.k) + kbase;
  const bf16* v = static_cast<const bf16*>(a.v) + kbase;
  const int k_end = a.causal ? min(a.s_k, q0 + kRows) : a.s_k;
  const int n_tiles = (k_end + BN - 1) / BN;

  copy_tile<kRows, D>(qs, static_cast<const bf16*>(a.q) + qbase, q0, a.s_q);
  cp_async_commit();
  if (n_tiles > 0) {
    copy_tile<BN, D>(ks, k, 0, a.s_k);
    copy_tile<BN, D>(vs, v, 0, a.s_k);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  scale_tile<kRows, D>(qs, a.scale);  // the first tile's barrier publishes it

  const bool no_live[2] = {true, true};
  float o[DT][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    const bf16* kt = ks + (j & 1) * BN * LD;
    const bf16* vt = vs + (j & 1) * BN * LD;
    if (j + 1 < n_tiles) {
      copy_tile<BN, D>(ks + ((j + 1) & 1) * BN * LD, k, k0 + BN, a.s_k);
      copy_tile<BN, D>(vs + ((j + 1) & 1) * BN * LD, v, k0 + BN, a.s_k);
    }
    cp_async_commit();
    if (a.kv_mask != nullptr && threadIdx.x < BN) {
      const int kj = k0 + threadIdx.x;
      live[threadIdx.x] =
          kj < a.s_k &&
          a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0;
    }
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
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
    if (k0 + BN > a.s_k || a.kv_mask != nullptr ||
        (a.causal && k0 + BN - 1 > w0)) {
      mask_tile<NT, false>(s, a, w0, k0, live, no_live);
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
      c_to_a(pa, s, kk);  // p rounded to bf16 after the dropout scale
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        load_b_kn<LD>(vb, vt, kk * 16, dp * 16, lane);
        mma(o[2 * dp], pa, vb[0], vb[1]);
        mma(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out) + qbase;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    const int qi = w0 + (lane >> 2) + 8 * h;
    if (qi >= a.s_q) continue;
    const bool dead = lh == 0.f;
    const float safe_l = dead ? 1.f : lh;
    bf16* row = out + static_cast<long long>(qi) * D + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          pack(o[dt][2 * h] / safe_l, o[dt][2 * h + 1] / safe_l);
    }
    if ((lane & 3) == 0) {
      a.lse[static_cast<long long>(bh) * a.s_q + qi] =
          dead ? kNegInf : m[h] + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq (and delta)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(Args a) {
  using G = Geo<D>;
  constexpr int BN = G::kDqKeys, LD = G::kLd, NT = BN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * LD;
  bf16* ks = dos + kRows * LD;  // two stages
  bf16* vs = ks + 2 * BN * LD;
  uint8_t* live = reinterpret_cast<uint8_t*>(vs + 2 * BN * LD);

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = iq * kRows, w0 = q0 + warp * 16;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  const bf16* k = static_cast<const bf16*>(a.k) + kbase;
  const bf16* v = static_cast<const bf16*>(a.v) + kbase;
  const bf16* dout = static_cast<const bf16*>(a.dout) + qbase;
  const int k_end = a.causal ? min(a.s_k, q0 + kRows) : a.s_k;
  const int n_tiles = (k_end + BN - 1) / BN;

  copy_tile<kRows, D>(qs, static_cast<const bf16*>(a.q) + qbase, q0, a.s_q);
  copy_tile<kRows, D>(dos, dout, q0, a.s_q);
  cp_async_commit();
  if (n_tiles > 0) {
    copy_tile<BN, D>(ks, k, 0, a.s_k);
    copy_tile<BN, D>(vs, v, 0, a.s_k);
  }
  cp_async_commit();

  // delta = rowsum(do * o) in fp32 for the warp's rows, written for the
  // dk/dv launch; lse of the thread's two rows, in log2 units
  const bf16* o = static_cast<const bf16*>(a.o) + qbase;
  float delta[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int qi = w0 + r;
    float part = 0.f;
    if (qi < a.s_q) {
      for (int d = lane; d < D; d += 32) {
        const long long at = static_cast<long long>(qi) * D + d;
        part += __bfloat162float(dout[at]) * __bfloat162float(o[at]);
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
  float acc[DT][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    const bf16* kt = ks + (j & 1) * BN * LD;
    const bf16* vt = vs + (j & 1) * BN * LD;
    if (j + 1 < n_tiles) {
      copy_tile<BN, D>(ks + ((j + 1) & 1) * BN * LD, k, k0 + BN, a.s_k);
      copy_tile<BN, D>(vs + ((j + 1) & 1) * BN * LD, v, k0 + BN, a.s_k);
    }
    cp_async_commit();
    if (a.kv_mask != nullptr && threadIdx.x < BN) {
      const int kj = k0 + threadIdx.x;
      live[threadIdx.x] =
          kj < a.s_k &&
          a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0;
    }
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
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
        mma(dp[2 * np], da, vb[0], vb[1]);
        mma(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    if (k0 + BN > a.s_k || a.kv_mask != nullptr ||
        (a.causal && k0 + BN - 1 > w0)) {
      mask_tile<NT, false>(s, a, w0, k0, live, no_live);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = s[nt][e];
        const float p = x <= kDead ? 0.f : exp2f(fmaf(x, kLog2e, -lse2[h]));
        float d = dp[nt][e];
        if (a.dropout) {
          const int qi = w0 + (lane >> 2) + 8 * h;
          const int kj = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          d = keep_bit(a.seed, bh, qi, kj, a.threshold) ? d * a.drop_scale
                                                         : 0.f;
        }
        s[nt][e] = p * (d - delta[h]);  // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, s, kk);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kb[4];
        load_b_kn<LD>(kb, kt, kk * 16, dd * 16, lane);
        mma(acc[2 * dd], sa, kb[0], kb[1]);
        mma(acc[2 * dd + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<D>(static_cast<bf16*>(a.dq) + qbase, acc, w0, a.s_q, a.scale);
}

// ---------------------------------------------------------------------------
// backward, dk and dv
// ---------------------------------------------------------------------------

// One walk of the dk/dv kernel over the query tiles [q_begin, s_q): adds
// bf16(P^T dropped) dO into dv when kDV, bf16(dS^T) Q into dk when kDK.
template <int D, bool kDV, bool kDK>
__device__ __forceinline__ void dkv_walk(const Args& a, int bh, int w0,
                                         const bool (&row_live)[2],
                                         int q_begin, const bf16* ks,
                                         const bf16* vs, bf16* qs, bf16* dos,
                                         float* lse2_s, float* delta_s,
                                         float (&dv)[D / 8][4],
                                         float (&dk)[D / 8][4]) {
  using G = Geo<D>;
  constexpr int BQ = G::kQueries, LD = G::kLd, NT = BQ / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long qbase = static_cast<long long>(bh) * a.s_q * D;
  const bf16* q = static_cast<const bf16*>(a.q) + qbase;
  const bf16* dout = static_cast<const bf16*>(a.dout) + qbase;
  const int n_tiles = a.s_q > q_begin ? (a.s_q - q_begin + BQ - 1) / BQ : 0;
  // rows that need a mask whatever the query tile
  const bool rows_masked = a.kv_mask != nullptr || w0 + 16 > a.s_k;

  if (n_tiles > 0) {
    copy_tile<BQ, D>(qs, q, q_begin, a.s_q);
    copy_tile<BQ, D>(dos, dout, q_begin, a.s_q);
  }
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * BQ;
    bf16* qt = qs + (j & 1) * BQ * LD;
    const bf16* dt = dos + (j & 1) * BQ * LD;
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
        mma(s[2 * np], ka, qb[0], qb[1]);
        mma(s[2 * np + 1], ka, qb[2], qb[3]);
        if (kDK) {
          uint32_t db[4];
          load_b_nk<LD>(db, dt, np * 16, kk * 16, lane);
          mma(dp[2 * np], va, db[0], db[1]);
          mma(dp[2 * np + 1], va, db[2], db[3]);
        }
      }
    }
    if (rows_masked || q0 + BQ > a.s_q || (a.causal && w0 + 15 > q0)) {
      mask_tile<NT, true>(s, a, w0, q0, nullptr, row_live);
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
      if (kDV) c_to_a(pa, s, kk);
      if (kDK) c_to_a(sa, dp, kk);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        if (kDV) {
          uint32_t ob[4];
          load_b_kn<LD>(ob, dt, kk * 16, dd * 16, lane);
          mma(dv[2 * dd], pa, ob[0], ob[1]);
          mma(dv[2 * dd + 1], pa, ob[2], ob[3]);
        }
        if (kDK) {
          uint32_t qb[4];
          load_b_kn<LD>(qb, qt, kk * 16, dd * 16, lane);
          mma(dk[2 * dd], sa, qb[0], qb[1]);
          mma(dk[2 * dd + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(Args a) {
  using G = Geo<D>;
  constexpr int BQ = G::kQueries, LD = G::kLd, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kRows * LD;
  bf16* qs = vs + kRows * LD;  // two stages, round(q * scale)
  bf16* dos = qs + 2 * BQ * LD;
  float* lse2_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);
  float* delta_s = lse2_s + BQ;

  const int ik = blockIdx.x;  // low key tiles see the most queries: first
  const int bh = blockIdx.y;
  const int ib = bh / a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = ik * kRows, w0 = k0 + warp * 16;
  const long long kbase = static_cast<long long>(bh) * a.s_k * D;
  copy_tile<kRows, D>(ks, static_cast<const bf16*>(a.k) + kbase, k0, a.s_k);
  copy_tile<kRows, D>(vs, static_cast<const bf16*>(a.v) + kbase, k0, a.s_k);
  cp_async_commit();

  bool row_live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = w0 + (lane >> 2) + 8 * h;
    row_live[h] = kj < a.s_k &&
                  (a.kv_mask == nullptr ||
                   a.kv_mask[static_cast<long long>(ib) * a.s_k + kj] != 0);
  }
  // causal: query qi sees key kj only when qi >= kj
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
  bf16* dk_out = static_cast<bf16*>(a.dk) + kbase;
  bf16* dv_out = static_cast<bf16*>(a.dv) + kbase;
  if (G::kTwoPass) {
    {
      float dv[DT][4] = {};
      dkv_walk<D, true, false>(a, bh, w0, row_live, q_begin, ks, vs, qs, dos,
                               lse2_s, delta_s, dv, dv);
      store_rows<D>(dv_out, dv, w0, a.s_k, 1.f);
    }
    float dk[DT][4] = {};
    dkv_walk<D, false, true>(a, bh, w0, row_live, q_begin, ks, vs, qs, dos,
                             lse2_s, delta_s, dk, dk);
    store_rows<D>(dk_out, dk, w0, a.s_k, 1.f);
  } else {
    float dk[DT][4] = {}, dv[DT][4] = {};
    dkv_walk<D, true, true>(a, bh, w0, row_live, q_begin, ks, vs, qs, dos,
                            lse2_s, delta_s, dv, dk);
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

template <int D>
cudaError_t launch_fwd(const Args& a, int bn, int device, cudaStream_t s) {
  static bool ready[kMaxDevices];
  constexpr int kSmem = Geo<D>::kFwdSmem;
  cudaError_t e = allow_smem(flash_fwd_tc_kernel<D>, kSmem, device, ready);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.s_q + kRows - 1) / kRows, bn);
  flash_fwd_tc_kernel<D><<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const Args& a, int bn, int device, cudaStream_t s) {
  static bool ready_dq[kMaxDevices], ready_dkv[kMaxDevices];
  constexpr int kDq = Geo<D>::kDqSmem, kDkv = Geo<D>::kDkvSmem;
  cudaError_t e = allow_smem(flash_bwd_dq_tc_kernel<D>, kDq, device, ready_dq);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dkv_tc_kernel<D>, kDkv, device, ready_dkv);
  if (e != cudaSuccess) return e;
  // dq first: it writes delta, which the dk/dv launch reads
  const dim3 gq((a.s_q + kRows - 1) / kRows, bn);
  flash_bwd_dq_tc_kernel<D><<<gq, kThreads, kDq, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.s_k == 0) return e;
  const dim3 gk((a.s_k + kRows - 1) / kRows, bn);
  flash_bwd_dkv_tc_kernel<D><<<gk, kThreads, kDkv, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(bool fwd, const Args& a, int bn, int device,
                   cudaStream_t s) {
  return fwd ? launch_fwd<D>(a, bn, device, s)
             : launch_bwd<D>(a, bn, device, s);
}

}  // namespace

cudaError_t launch_bf16(bool fwd, const Args& a, int bn, int d, int device,
                        cudaStream_t stream) {
  // the instantiated head dims (KERNEL_HEAD_DIMS of the wrapper)
  switch (d) {
    case 32: return launch<32>(fwd, a, bn, device, stream);
    case 64: return launch<64>(fwd, a, bn, device, stream);
    case 96: return launch<96>(fwd, a, bn, device, stream);
    case 128: return launch<128>(fwd, a, bn, device, stream);
    case 256: return launch<256>(fwd, a, bn, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace apex_flash
