// Shared by flash_attn.cu (kernel B3 fwd) and flash_attn_bwd.cu (B3 bwd): the
// tile geometry and the attention-dropout hash.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// Query rows and keys of one tile; 256 threads as a 16 x 16 grid, thread
// (ty, tx) owning rows ty + 16 i and columns tx + 16 j, i, j < 4.
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
// Shared-memory rows of 64 entries are padded to 65, so that lanes walking
// down a column hit different banks.
constexpr int kPad = kBK + 1;

constexpr uint32_t kPhi1 = 2654435761u;
constexpr uint32_t kPhi2 = 2246822519u;
constexpr uint32_t kPhi3 = 3266489917u;
constexpr uint32_t kPhi4 = 40503u;

// The keep bit of attention-probability dropout at (absolute head index
// bn = (batch0 + b) * N + n, query qi, key ki): bit for bit the JAX
// package's _dropout_mask (ops/pallas/attention_kernel.py:71-95). uint32_t
// arithmetic wraps modulo 2^32 as jnp.uint32 does.
__device__ __forceinline__ bool keep_bit(uint32_t bn, uint32_t qi, uint32_t ki,
                                         uint32_t s0, uint32_t s1, uint32_t thresh) {
  uint32_t h = (qi * kPhi1) ^ (ki * kPhi2) ^ (bn * kPhi4) ^ s0;
  h ^= h >> 16;
  h *= kPhi3;
  h ^= h >> 13;
  h ^= s1;
  h *= kPhi1;
  h ^= h >> 16;
  return h < thresh;
}

// Sum or max over the 16 lanes (tx = 0..15) that share one ty: they are one
// half of a warp, and xor offsets below 16 stay inside it.
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace flash
