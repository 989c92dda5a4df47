// Loads and stores of four consecutive table or moment values, shared by the
// AdamW kernels (embedding_adamw.cu, lazy_adamw.cu). A float32 buffer moves
// one float4; a bf16 buffer one uint2, widened exactly on load. A bf16 store
// rounds to nearest, or stochastically: add 16 random bits to the float32
// pattern and truncate, the bits being counter_hash(seed, idx + t) for
// element t, as ops/rounding.py::stochastic_round_bf16 draws them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "counter_hash.cuh"

__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half
  out[0] = __uint_as_float(raw.x << 16);
  out[1] = __uint_as_float(raw.x & 0xffff0000u);
  out[2] = __uint_as_float(raw.y << 16);
  out[3] = __uint_as_float(raw.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4], int = 0,
                                       unsigned long long = 0ULL, unsigned long long = 0ULL) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4], int sr,
                                       unsigned long long seed, unsigned long long idx) {
  uint32_t half[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (sr) {
      const uint32_t r = counter_hash(seed, idx + t) & 0xffffu;
      half[t] = (__float_as_uint(v[t]) + r) >> 16;
    } else {
      half[t] = __bfloat16_as_ushort(__float2bfloat16_rn(v[t]));
    }
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(half[0] | (half[1] << 16), half[2] | (half[3] << 16));
}
