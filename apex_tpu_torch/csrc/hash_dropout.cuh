// The counter-hash dropout bit shared by the port's kernels.
//
// Replaces the keep mask of apex_tpu/ops/flash_attention.py (_keep_mask /
// _hash_keep_bits), which apex_tpu/ops/fused_block.py (_tile_keep) reuses:
// a murmur3-finalised hash of (seed, bh, qi, ki) in uint32 arithmetic,
// compared unsigned against round(p_drop * 2^32) (the TPU code's sign-flip
// compare is the same order). Flash attention keys it on (batch * heads +
// head, query, key); the fused block tails on (0, global row, column). One
// definition keeps every kernel and the plain PyTorch versions
// (ops/flash_attention.py::_hash_keep_bits) on the same bits.
#pragma once

#include <stdint.h>

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
