// Tile primitives for 16-bit tensor-core kernels on Hopper (sm_90a): the warp
// matrix product mma.sync m16n8k16 (bf16 or fp16 operands, fp32
// accumulation; the element type T is a template argument, bf16 by default),
// ldmatrix from shared memory (plain and transposed), 16-byte cp.async copies
// with zero fill, and a padded shared-memory tile layout.
//
// Fragments of mma.m16n8k16 (lane = 4 * grp + tig, grp = lane / 4, tig =
// lane % 4; each 32-bit register holds two 16-bit values, the lower column
// first; ldmatrix and cp.async move bits, so they serve both types):
//   A 16x16, row-major: a0 (grp, 2tig..+1), a1 (grp+8, 2tig..+1),
//                       a2 (grp, 2tig+8..+9), a3 (grp+8, 2tig+8..+9);
//   B 16x8, k by n:     b0 (k 2tig..+1, n grp), b1 (k 2tig+8..+9, n grp);
//   C 16x8, fp32:       c0, c1 (grp, 2tig..+1), c2, c3 (grp+8, 2tig..+1).
// So a C fragment of two neighbouring n tiles, rounded to T, is the A
// fragment of the next product: the softmax probabilities stay in registers.
//
// Layout. A tile of R rows by D values is stored with a row stride of D + 8
// elements: D / 8 + 1 sixteen-byte chunks, an odd number at every head dim
// (5, 9, 13, 17, 33). The eight row addresses of one ldmatrix 8x8 matrix
// (eight rows, one chunk column) then fall in eight different 16-byte bank
// groups, so ldmatrix is free of bank conflicts at D = 32 and 96 as well,
// where a 128-byte XOR swizzle does not tile the row. It costs 16 bytes a
// row (3% at D = 256).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;
using f16 = __half;

// the row stride, in elements, of a shared tile of head dim D
template <int D>
__host__ __device__ constexpr int ld() {
  return D + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; when !valid,
// the source size is 0 and the 16 bytes are zero-filled (rows past the end).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 16-bit matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a * b on the tensor cores: T products (bf16 or fp16), fp32 sums
template <typename T = bf16>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<bf16>(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<f16>(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to T (to nearest even), lo in the low half
template <typename T = bf16>
__device__ __forceinline__ uint32_t pack(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two T values of a 32-bit register as floats, the low half first
template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t w);
template <>
__device__ __forceinline__ float2 unpack<bf16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
template <>
__device__ __forceinline__ float2 unpack<f16>(uint32_t w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

// The A fragment at rows r0..r0+15, columns c0..c0+15 of a row-major tile
// (stride LD): the 16x16 block as it is stored.
template <int LD, typename T>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const T* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(r, tile + (r0 + (lane & 15)) * LD + c0 + 8 * (lane >> 4));
}

// B fragments of two n tiles (r0, r1: n r0..r0+7; r2, r3: n r0+8..+15) for
// the k slice c0..c0+15, from a tile stored n-major (row n holds the k
// values): the right operand of X . T^T, with T's rows the n index.
template <int LD, typename T>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const T* tile,
                                          int r0, int c0, int lane) {
  ldmatrix_x4(r, tile + (r0 + (lane & 7) + 8 * (lane >> 4)) * LD + c0 +
                     8 * ((lane >> 3) & 1));
}

// B fragments of two n tiles (r0, r1: n c0..c0+7; r2, r3: n c0+8..+15) for
// the k slice r0..r0+15, from a tile stored k-major (row k holds the n
// values), transposed by ldmatrix: the right operand of X . T.
template <int LD, typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const T* tile,
                                          int r0, int c0, int lane) {
  ldmatrix_x4_trans(r, tile + (r0 + (lane & 15)) * LD + c0 + 8 * (lane >> 4));
}

// The A fragment of k slice kk (columns 16kk..16kk+15) from a C
// accumulator of n tiles of 8, each value rounded to T.
template <typename T = bf16, int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NT][4], int kk) {
  a[0] = pack<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

}  // namespace mma_bf16
