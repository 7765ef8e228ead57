// JAX's threefry2x32 PRNG on the device (jax/_src/prng.py with
// jax_threefry_partitionable on, as jax 0.9 sets it): the 20-round block,
// fold_in, and the 32 random bits of a flat index. Shared by D1
// (threefry_dropout.cu) and B3's flax mask form (flash_attn_common.cuh);
// utils/prng.py is the same arithmetic in PyTorch.
#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Four rounds: x0 += x1; x1 = rotl(x1, r) ^ x0.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// threefry2x32 of the counter (x0, x1) under the key (k0, k1); uint32
// arithmetic wraps modulo 2^32 as jnp.uint32 does.
__device__ __forceinline__ uint2 block(uint2 key, uint32_t x0, uint32_t x1) {
  const uint32_t k0 = key.x, k1 = key.y, k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// jax.random.fold_in(key, data) (and split(key, n)[data]).
__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t data) { return block(key, 0u, data); }

// The random bits of flat index i of a draw from `key`: the block of
// (hi, lo) of i, its two words XORed.
__device__ __forceinline__ uint32_t bits(uint2 key, unsigned long long i) {
  const uint2 y = block(key, (uint32_t)(i >> 32), (uint32_t)i);
  return y.x ^ y.y;
}

// jax.random.bernoulli's keep test: uniform < p in float32 is the top 23 bits
// below thresh23 = ceil(float32(p) * 2^23) (utils/prng.keep_threshold23).
__device__ __forceinline__ bool keep(uint2 key, unsigned long long i, uint32_t thresh23) {
  return (bits(key, i) >> 9) < thresh23;
}

}  // namespace threefry
