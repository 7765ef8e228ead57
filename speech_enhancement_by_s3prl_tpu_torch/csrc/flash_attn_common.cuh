// Shared by flash_attn.cu (kernel B3 fwd) and flash_attn_bwd.cu (B3 bwd): the
// tile geometry, the attention-dropout hash and the staging of tiles from
// device memory into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace flash {

// A tile kernel's block is 4 warps; a warp owns 16 rows of the block's
// resident 64-row tile (kBQ queries or kBK keys), and the other operand is
// walked kWalk rows at a time. kThreads is the block of the row-dot pre-pass.
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kTileThreads = 128;
constexpr int kWalk = 32;

constexpr uint32_t kPhi1 = 2654435761u;
constexpr uint32_t kPhi2 = 2246822519u;
constexpr uint32_t kPhi3 = 3266489917u;
constexpr uint32_t kPhi4 = 40503u;

// Where a launch's heads lie in the whole batch of heads: its row b is row
// batch0 + b of the global batch (a data-parallel rank's rows) and its head n
// is head head0 + n of n_total (a tensor-parallel rank's heads). The mask of
// (b, n) keys on the absolute head index bn = (batch0 + b) * n_total + head0
// + n; batch0 = head0 = 0 and n_total = N is the launch on its own.
struct HeadKey {
  int batch0, head0, n_total;
  __device__ __forceinline__ uint32_t bn(int b, int n) const {
    return (uint32_t)((batch0 + b) * n_total + head0 + n);
  }
};

// The keep bit of attention-probability dropout at (absolute head index
// bn = HeadKey::bn(b, n), query qi, key ki): bit for bit the JAX
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

// The block's resident 64-row tile of a (., T, .) operand at time rows t0 ..
// t0 + 63 into dst[64][D + 4], times mul, rows >= T as zeros. 16 bytes a load
// where the pointers and strides allow it (vec).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int t0, int T, float mul, int vec) {
  constexpr int LD = D + 4;
  if (vec) {
    constexpr int C4 = D / 4;
    for (int i = threadIdx.x; i < 64 * C4; i += kTileThreads) {
      const int r = i / C4, c = (i % C4) * 4, t = t0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) x = *reinterpret_cast<const float4*>(src + (long long)t * row_stride + c);
      x.x *= mul, x.y *= mul, x.z *= mul, x.w *= mul;
      *reinterpret_cast<float4*>(dst + r * LD + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < 64 * D; i += kTileThreads) {
      const int r = i / D, c = i % D, t = t0 + r;
      dst[r * LD + c] = t < T ? src[(long long)t * row_stride + c] * mul : 0.f;
    }
  }
}

// Start the copy of a walked tile: time rows t0 .. t0 + W - 1 (W = kWalk, or
// 16 where D = 256 leaves shared memory for no more) of two (., T, .)
// operands into a[W][D + 4] and b[W][D + 4] and of two per-row vectors into
// ra[W] and rb[W] (rows >= T: zeros; where rb is null, ra is the key bias
// and its rows >= T are -inf). The copies are asynchronous where 16-byte
// loads are possible and land before the next cp_async_wait_all; otherwise
// plain loads and stores.
template <int D, int W = kWalk>
__device__ __forceinline__ void start_walk_tile(float* a, const float* a_src, long long a_stride,
                                                float* b, const float* b_src, long long b_stride,
                                                float* ra, const float* ra_src, float* rb,
                                                const float* rb_src, int t0, int T, int vec) {
  constexpr int LD = D + 4;
  if (vec) {
    constexpr int C4 = D / 4;
    for (int i = threadIdx.x; i < W * C4; i += kTileThreads) {
      const int r = i / C4, c = (i % C4) * 4, t = t0 + r;
      const int bytes = t < T ? 16 : 0;
      const long long row = t < T ? t : T - 1;  // a valid address either way
      cp_async16(a + r * LD + c, a_src + row * a_stride + c, bytes);
      cp_async16(b + r * LD + c, b_src + row * b_stride + c, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < W * D; i += kTileThreads) {
      const int r = i / D, c = i % D, t = t0 + r;
      a[r * LD + c] = t < T ? a_src[(long long)t * a_stride + c] : 0.f;
      b[r * LD + c] = t < T ? b_src[(long long)t * b_stride + c] : 0.f;
    }
  }
  if (threadIdx.x < W) {
    const int t = t0 + threadIdx.x;
    if (rb != nullptr) {
      cp_async4(ra + threadIdx.x, ra_src + (t < T ? t : T - 1), t < T ? 4 : 0);
      cp_async4(rb + threadIdx.x, rb_src + (t < T ? t : T - 1), t < T ? 4 : 0);
    } else {
      ra[threadIdx.x] = t < T ? ra_src[t] : -INFINITY;  // keys >= T: bias -inf
    }
  }
  cp_async_commit();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace flash
