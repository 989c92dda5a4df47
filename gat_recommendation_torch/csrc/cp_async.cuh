// Asynchronous 16-byte copies from device memory to shared memory (cp.async,
// sm_80 and later), shared by the port's tiled kernels. A thread issues its
// copies, closes them into a group with cp_async_commit(), and later waits
// until at most `kPending` of its newest groups are still in flight; a
// __syncthreads() after the wait makes every thread's copies visible to all.
#pragma once

#include <stdint.h>

// Both addresses must be 16-byte aligned. `.cg` keeps the line out of L1:
// a staged tile is read from device memory once and then from shared memory.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

// Copies 16 bytes when `valid`, else writes 16 zero bytes and reads nothing
// (source size 0): the ragged edge of a tile is filled in the kernel.
// `gmem_src` must be a mapped address either way.
__device__ __forceinline__ void cp_async16_or_zero(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int n_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(n_bytes)
               : "memory");
}

// An 8-byte copy (four bfloat16 values); `.ca`, the only cache mode for
// fewer than 16 bytes. Both addresses must be 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
