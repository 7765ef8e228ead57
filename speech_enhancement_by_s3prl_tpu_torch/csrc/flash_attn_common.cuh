// Shared by flash_attn.cu (kernel B3 fwd) and flash_attn_bwd.cu (B3 bwd): the
// tile geometry, the attention-dropout masks and the staging of tiles from
// device memory into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "threefry.cuh"

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

// B3's mask forms (ops/cuda/attention_kernel.py, MASK_FORMS): the JAX flash
// kernel's hash of (head, query, key); flax nn.Dropout's threefry draw over
// the global (B, N, Tq, T) probabilities; the JAX hidden-state hash
// (_hash_mask_apply) of the same tensor.
enum MaskForm { kMaskHash = 0, kMaskFlax = 1, kMaskHiddenHash = 2 };

// A launch's mask: the two words w0, w1 (the hash's salt; the flax form's key;
// the hidden hash's salt; with chunk > 0 the chunked path's key, from which
// chunk c's key fold_in(key, c) and, for the hidden hash, its salt
// bits(fold_in(key, c), (2,)) derive), the keep threshold (32 bits for the
// hashes, 23 for the flax form), chunk (0: one draw over all T queries; else
// the queries a chunk, Tq = chunk), T keys and where the heads lie (HeadKey).
struct Mask {
  uint32_t w0, w1, thresh;
  int chunk, T;
  HeadKey key;
};

// The mask of one query row qi of head (b, n) in form FORM: keep(ki) for key
// ki. The row's part of each form is computed once (the hash's row term, the
// flax counter's row base, the hidden hash's row term).
template <int FORM>
struct MaskRow;

template <>
struct MaskRow<kMaskHash> {
  uint32_t row, s1, thresh;
  __device__ __forceinline__ MaskRow(const Mask& m, uint2, int b, int n, int qi, int)
      : row(((uint32_t)qi * kPhi1) ^ (m.key.bn(b, n) * kPhi4) ^ m.w0), s1(m.w1),
        thresh(m.thresh) {}
  // the JAX kernel's _dropout_mask (ops/pallas/attention_kernel.py:71-95),
  // the row's term once; uint32_t arithmetic wraps as jnp.uint32 does
  __device__ __forceinline__ bool keep(int ki) const {
    uint32_t h = row ^ ((uint32_t)ki * kPhi2);
    h ^= h >> 16;
    h *= kPhi3;
    h ^= h >> 13;
    h ^= s1;
    h *= kPhi1;
    h ^= h >> 16;
    return h < thresh;
  }
};

template <>
struct MaskRow<kMaskFlax> {
  uint2 k;
  unsigned long long base;
  uint32_t thresh;
  // words: the draw's key (the chunk's); ql: the query within its chunk
  __device__ __forceinline__ MaskRow(const Mask& m, uint2 words, int b, int n, int qi, int ql)
      : k(words), thresh(m.thresh) {
    const unsigned long long tq = m.chunk ? m.chunk : m.T;
    const unsigned long long bn =
        (unsigned long long)(m.key.batch0 + b) * m.key.n_total + m.key.head0 + n;
    base = (bn * tq + (unsigned long long)ql) * (unsigned long long)m.T;
  }
  __device__ __forceinline__ bool keep(int ki) const {
    return threefry::keep(k, base + (unsigned long long)ki, thresh);
  }
};

template <>
struct MaskRow<kMaskHiddenHash> {
  uint32_t rb, rx, s1, thresh;
  // words: the salt (the chunk's); the flat index within x[0] of the
  // (N, Tq, T) probabilities, (n Tq + ql) T + ki, wraps modulo 2^32 as the
  // JAX hash's uint32 iota
  __device__ __forceinline__ MaskRow(const Mask& m, uint2 words, int b, int n, int, int ql)
      : s1(words.y), thresh(m.thresh) {
    const uint32_t tq = m.chunk ? m.chunk : m.T;
    rb = (((uint32_t)(m.key.head0 + n) * tq + (uint32_t)ql) * (uint32_t)m.T) * kPhi1;
    rx = ((uint32_t)(m.key.batch0 + b) * kPhi4) ^ words.x;
  }
  __device__ __forceinline__ bool keep(int ki) const {
    uint32_t h = (rb + (uint32_t)ki * kPhi1) ^ rx;
    h ^= h >> 16;
    h *= kPhi2;
    h ^= h >> 13;
    h ^= s1;
    h *= kPhi3;
    h ^= h >> 16;
    return h < thresh;
  }
};

// The rows of one head (b, n): at(qi) is query qi's MaskRow. A chunked form
// derives its chunk's words once a chunk and keeps them while the queries
// asked for stay in that chunk.
template <int FORM>
struct MaskRows {
  const Mask m;
  int b, n, chunk_at;
  uint2 words;
  __device__ __forceinline__ MaskRows(const Mask& mask, int b_, int n_)
      : m(mask), b(b_), n(n_), chunk_at(-1), words(make_uint2(mask.w0, mask.w1)) {}
  __device__ __forceinline__ MaskRow<FORM> at(int qi) {
    if (FORM == kMaskHash || m.chunk == 0) return MaskRow<FORM>(m, words, b, n, qi, qi);
    const int c = qi / m.chunk;
    if (c != chunk_at) {
      chunk_at = c;
      const uint2 key = threefry::fold_in(make_uint2(m.w0, m.w1), (uint32_t)c);
      words = FORM == kMaskFlax ? key
                                : make_uint2(threefry::bits(key, 0ull), threefry::bits(key, 1ull));
    }
    return MaskRow<FORM>(m, words, b, n, qi, qi - c * m.chunk);
  }
};

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
