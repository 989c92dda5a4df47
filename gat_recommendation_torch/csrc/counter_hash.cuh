// Counter-based random bits shared by the port's kernels (attention dropout,
// stochastic rounding of bf16 optimizer moments). The same function as
// ops/rounding.py::counter_hash, so a kernel and its plain PyTorch version
// draw the same bits from the same (seed, counter) and agree bit for bit.
//
//   counter_hash(seed, idx) = mix32(mix32(lo(idx) ^ lo(seed)) ^ hi(seed) ^ hi(idx))
//
// mix32 is a two-round multiply-xorshift integer hash; both multipliers are
// below 2^31, so the plain version can compute it in signed 64-bit integers.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 15;
  x *= 0x2c1b3c6du;
  x ^= x >> 12;
  x *= 0x297a2d39u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t counter_hash(unsigned long long seed, unsigned long long idx) {
  const uint32_t inner = mix32(static_cast<uint32_t>(idx) ^ static_cast<uint32_t>(seed));
  return mix32(inner ^ static_cast<uint32_t>(seed >> 32) ^ static_cast<uint32_t>(idx >> 32));
}
