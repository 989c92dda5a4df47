// Node dropout for Hopper (sm_90a): inverted dropout over a float32 tensor whose
// keep bits come from the counter hash, in one pass. Plain C interface for ctypes.
//
// Stands for the JAX package's ops/masked.py::dropout (jax.random.bernoulli
// and a select, which XLA fuses; there is no Pallas kernel). The port draws its
// bits from the counter hash instead, with the seed read from device memory (a
// layer's field of the step block, ops/step_block.py), so that a CUDA graph of
// the train step replays every step with its own mask:
//
//     out[i] = (counter_hash(seed, i) >> 8) < threshold ? x[i] * scale : 0
//
// i the linear index, threshold = (1 - rate) * 2^24 and scale = 1 / (1 - rate)
// rounded to float32 by the host (ops/rounding.py: keep_threshold, keep_scale).
// The plain version (ops/masked.py::dropout) computes the same bits, and the
// product with __fmul_rn is the plain version's float32 multiply. The gradient
// of the function is the function itself applied to the output gradient, so the
// backward launches the same kernel.
//
// Bound on an H100 SXM: bytes. One read and one write of the tensor: at the
// training batch's [512, 56, 256] that is 58.7 MB, 0.0175 ms at 3.35 TB/s; the
// two rounds of the integer hash are about 20 integer instructions an element
// (0.0088 ms at 64 integer lanes an SM and clock). One thread per float4,
// 16-byte loads and stores; nothing is kept between elements.

#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
node_dropout_kernel(const float4* __restrict__ x, float4* __restrict__ out, long long n4,
                    const long long* __restrict__ seed_ptr, uint32_t threshold, float scale) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const unsigned long long seed = static_cast<unsigned long long>(__ldg(seed_ptr));
  const float4 v = x[i];
  float r[4] = {v.x, v.y, v.z, v.w};
  const unsigned long long base = 4ULL * static_cast<unsigned long long>(i);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool keep = (counter_hash(seed, base + t) >> 8) < threshold;
    r[t] = keep ? __fmul_rn(r[t], scale) : 0.0f;
  }
  out[i] = make_float4(r[0], r[1], r[2], r[3]);
}

}  // namespace

// x and out: n float32 values (n % 4 == 0), contiguous and 16-byte aligned,
// checked by the Python wrapper; seed: the device address of an int64 holding
// the 64-bit seed. Returns cudaGetLastError().
extern "C" int node_dropout(const void* x, void* out, long long n, const void* seed,
                            unsigned threshold, float scale, void* stream) {
  const long long n4 = n / 4;
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 0) {
    node_dropout_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(out), n4,
        static_cast<const long long*>(seed), threshold, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
