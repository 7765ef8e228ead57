// bf16 tile products on the tensor cores, for Hopper's mma.sync.m16n8k16, and
// the staging of bf16 tiles into shared memory: the arithmetic of B3's bf16
// kernels (flash_attn.cu, flash_attn_bwd.cu under compute_dtype bf16).
//
// A bf16 operand is what the tensor core multiplies exactly: one pass a
// product, f32 accumulators, no split operands (mma_tf32x3.cuh needs three
// passes for f32 accuracy; a bf16 kernel is held to bf16 roundings, and its
// operands are rounded to bf16 where the JAX kernel rounds them).
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// with g = lane / 4 and t = lane % 4; a 32-bit register holds two bf16, the
// lower column (or k) index in its low half:
//   A (16 x 16): a0 (g, 2t..2t+1)  a1 (g + 8, 2t..2t+1)
//                a2 (g, 2t+8..2t+9)  a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8):  b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// Two neighbouring C tiles (columns 0-7 and 8-15) are, rounded to bf16 and
// packed in pairs, the A fragment of a 16-deep contraction over those
// columns (`frag_a_from_acc`): a product's result feeds the next product
// without a trip through shared memory.
//
// Shared-memory tiles are row-major bf16 with a leading dimension of D + 8
// elements (a pad of 16 bytes a row): the 8 rows an ldmatrix reads then lie in
// 8 different 16-byte bank groups. Rows start 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace bf16mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The A fragment of the 16 x 16 tile at `s` of a row-major [m][k] array: the
// four 8 x 8 blocks (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15) are a0 .. a3; lane l names row l % 8 of block l / 8.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, s + (r + 8 * (m & 1)) * ld + 8 * (m >> 1));
}

// B fragments (16 deep) of two neighbouring n tiles (b0: n 0-7, b1: n 8-15) at
// `s` of a row-major [n][k] array: the operands of c[m][n] += sum_k a[m][k]
// b[n][k].
__device__ __forceinline__ void load_b_nk_x2(uint32_t b0[2], uint32_t b1[2], const bf16* s,
                                             int ld, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldmatrix_x4(x, s + (r + 8 * (m >> 1)) * ld + 8 * (m & 1));
  b0[0] = x[0], b0[1] = x[1], b1[0] = x[2], b1[1] = x[3];
}

// B fragments (16 deep) of two neighbouring n tiles at `s` of a row-major
// [k][n] array, transposed by ldmatrix on the way: the operands of
// c[m][n] += sum_k a[m][k] b[k][n].
__device__ __forceinline__ void load_b_kn_x2(uint32_t b0[2], uint32_t b1[2], const bf16* s,
                                             int ld, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldmatrix_x4_trans(x, s + (r + 8 * (m & 1)) * ld + 8 * (m >> 1));
  b0[0] = x[0], b0[1] = x[1], b1[0] = x[2], b1[1] = x[3];
}

// Two f32 values rounded to bf16 (to nearest, ties to even) in one register.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator tiles c0 (columns 0-7) and c1 (columns 8-15), rounded to bf16,
// as the A fragment of a contraction over those 16 columns.
__device__ __forceinline__ void frag_a_from_acc(uint32_t a[4], const float c0[4],
                                                const float c1[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// `rows` rows of a (., T, .) bf16 operand at time rows t0 .. into dst[rows][D +
// 8], each value times mul and rounded to bf16 (mul = 1 copies), rows >= T as
// zeros. 16 bytes a load where the pointers and strides allow it (vec).
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int t0, int T, int rows, float mul, int vec,
                                          int threads) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int C8 = D / 8;
    for (int i = threadIdx.x; i < rows * C8; i += threads) {
      const int r = i / C8, c = (i % C8) * 8, t = t0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (t < T) x = *reinterpret_cast<const uint4*>(src + (long long)t * row_stride + c);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
      }
      *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += threads) {
      const int r = i / D, c = i % D, t = t0 + r;
      const float x = t < T ? __bfloat162float(src[(long long)t * row_stride + c]) : 0.f;
      dst[r * LD + c] = __float2bfloat16_rn(x * mul);
    }
  }
}

// Start the copy of `rows` time rows t0 .. of NOPS (., T, .) bf16 operands into
// dst[o][rows][D + 8] (rows >= T: zeros). Asynchronous (cp.async, landing
// before the next cp_async_wait) where 16-byte copies are possible, plain
// loads and stores otherwise. The caller commits the group.
template <int D, int NOPS>
__device__ __forceinline__ void start_walk(bf16* const (&dst)[NOPS],
                                           const bf16* const (&src)[NOPS],
                                           const long long (&stride)[NOPS], int t0, int T,
                                           int rows, int vec, int threads) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int C8 = D / 8;
    for (int i = threadIdx.x; i < rows * C8; i += threads) {
      const int r = i / C8, c = (i % C8) * 8, t = t0 + r;
      const int bytes = t < T ? 16 : 0;
      const long long row = t < T ? t : T - 1;  // a valid address either way
#pragma unroll
      for (int o = 0; o < NOPS; ++o)
        cp_async16(reinterpret_cast<float*>(dst[o] + r * LD + c),
                   reinterpret_cast<const float*>(src[o] + row * stride[o] + c), bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += threads) {
      const int r = i / D, c = i % D, t = t0 + r;
#pragma unroll
      for (int o = 0; o < NOPS; ++o)
        dst[o][r * LD + c] =
            t < T ? src[o][(long long)t * stride[o] + c] : __float2bfloat16_rn(0.f);
    }
  }
}

}  // namespace bf16mma
