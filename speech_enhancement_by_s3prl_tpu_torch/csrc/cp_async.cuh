// Asynchronous copies global -> shared (cp.async), shared by the tile kernels
// that stage their operands through two buffers: the copy of tile i + 1 runs
// while tile i is worked on.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// `bytes` of the 16 (or 4) are read, the rest of the destination is
// zero-filled (bytes = 0: all zeros; the source must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are still in
// flight: the oldest ones have landed (a ring of N + 1 groups).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
