// One row of the per-step parameter block (ops/step_block.py): what changes
// from one train step to the next, held in device memory so that a kernel
// captured in a CUDA graph reads each replayed step's own values. The host
// builds the rows with the functions the by-value arguments came from, so a
// kernel reads the same bits it was passed before.
//
// Every field is a 64-bit integer: the step count (the step number after this
// update), the float32 bit patterns of the bias denominators 1 - b^count and of
// their reciprocals in the low 32 bits, the two stochastic-rounding seeds, then
// per layer the attention-dropout and the node-dropout seed.
#pragma once

namespace step_block {

constexpr int kCount = 0;
constexpr int kBc1 = 1, kBc2 = 2;    // 1 - b1^count, 1 - b2^count
constexpr int kIbc1 = 3, kIbc2 = 4;  // 1 / (1 - b^count), float32 on the host
constexpr int kSeedMu = 5, kSeedNu = 6;

__device__ __forceinline__ int count(const long long* row) { return static_cast<int>(row[kCount]); }

__device__ __forceinline__ float as_float(const long long* row, int field) {
  return __int_as_float(static_cast<int>(row[field]));
}

__device__ __forceinline__ unsigned long long as_seed(const long long* row, int field) {
  return static_cast<unsigned long long>(row[field]);
}

}  // namespace step_block
