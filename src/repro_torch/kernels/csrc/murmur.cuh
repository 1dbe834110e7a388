// murmur3 32-bit fold and finaliser: the device functions of the flow
// hash, shared by the hash grid (flowhash/csrc/flowhash.cu) and the
// sequential placement chain (placement/csrc/placement.cu), so both
// hash exactly as the JAX package's murmur_fold / murmur_fmix do.
#pragma once

#include <cstdint>

namespace murmur {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The field's own mixing, which depends on the field alone: a chain that
// hashes one flow's fields many times mixes them once.
__device__ __forceinline__ uint32_t mix_k(uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  return k * 0x1B873593u;
}

// One fold of an already mixed field into the running hash.
__device__ __forceinline__ uint32_t fold_mixed(uint32_t h, uint32_t k) {
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t k) {
  return fold_mixed(h, mix_k(k));
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

}  // namespace murmur
