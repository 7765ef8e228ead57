// f32 tile products on the tensor cores with error-compensated split-TF32
// operands ("3xTF32"), for Hopper's mma.sync.m16n8k8.
//
// A TF32 operand keeps 10 mantissa bits, so one TF32 product is good to about
// 1e-3: not enough for a kernel held to f32 limits. Each f32 operand x is
// split once in registers into hi, x rounded to TF32, and lo = x - hi, which
// is exact in f32. The tensor core reads the upper 19 bits of an operand
// register (sign, exponent, 10 mantissa bits) and drops the rest, and the
// split leans on that twice. hi is rounded to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds, by adding half a unit (0x1000) to x's bits and
// leaving the cut to the core: cvt itself expands to five machine operations
// with its guards for infinities, which made the splits a third of everything
// issued and the kernels issue-bound. lo goes in as it
// is, truncated by the core where a second conversion would round it; hi +
// lo as the core sees them still carry 21 of x's 24 significant bits.
// Operands must be finite.
//
// A product is then three tensor-core passes with one f32 accumulator,
//   c += a_lo b_hi;  c += a_hi b_lo;  c += a_hi b_hi
// (small terms first); the dropped a_lo b_lo is ~2^-22 of the product. That
// is f32-level accuracy at a third of the TF32 rate, which is still above
// the f32 rate of the CUDA cores.
//
// One more thing costs accuracy: the tensor core's accumulator truncates
// where f32 addition rounds, so a sum chained through many mma drifts
// towards zero by about half a unit in the last place a step (on an H100:
// 1.3e-5 of the largest value after 384 chained passes). Callers keep chains
// short: a sum over many tiles goes tile by tile through a fresh accumulator
// and is added up with f32 additions on the CUDA cores.
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k = t, n = g)           b1 (k = t + 4, n = g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// The order of the 8 contraction indices is free as long as A and B agree.
// With logical k = t <-> physical 2t and k = t + 4 <-> physical 2t + 1, an
// accumulator tile is an A fragment as it stands, (a0, a1, a2, a3) =
// (c0, c2, c1, c3): a product's result feeds the next product without a trip
// through shared memory. `frag_a_from_acc` and `load_b_kn` use that order.
//
// Shared-memory tiles are row-major with a leading dimension ld = 4 (mod 32)
// in floats (a pad of 4 on a width of 32, 64 or 128) and 16-byte aligned
// rows: the 8 rows of an ldmatrix block then lie in 8 different 16-byte bank
// groups, and the 32 words of a `load_b_kn` in 32 different banks. The two
// loaders that read a [k][.] tile in the plain contraction order (`load_a_km`,
// `load_b_kn_std`: rows t and t + 4) want ld = 8 (mod 32) instead: word
// t * 8 + g is then a different bank for each of the 32 lanes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// Three operations (add, and, subtract) for finite x; hi comes back with its
// low 13 bits set to whatever the addition left, which the tensor core drops.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// Four 8 x 4 blocks of 32-bit words in one ldmatrix: lane l names the row
// l % 8 of block l / 8 (16 bytes, 16-byte aligned); afterwards r[m] of lane l
// is word l % 4 of row l / 4 of block m: the (g, t) entry the fragments want.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const float* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void split_bits(uint32_t x, uint32_t& hi, uint32_t& lo) {
  split(__uint_as_float(x), hi, lo);
}

// A fragment of the 16 x 8 tile at `s` of a row-major [m][k] array, with one
// ldmatrix: blocks (rows 0-7, k 0-3), (rows 8-15, k 0-3), (rows 0-7, k 4-7),
// (rows 8-15, k 4-7) are a0 .. a3.
__device__ __forceinline__ void load_a(FragA& f, const float* s, int ld, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldmatrix_x4(x, s + (r + 8 * (m & 1)) * ld + 4 * (m >> 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_bits(x[i], f.hi[i], f.lo[i]);
}

// B fragments (k x n = 8 x 8 each) of two neighbouring n tiles (f0: rows 0-7,
// f1: rows 8-15) at `s` of a row-major [n][k] array, with one ldmatrix: the
// operands of c[m][n] += sum_k a[m][k] b[n][k].
__device__ __forceinline__ void load_b_nk_x2(FragB& f0, FragB& f1, const float* s, int ld,
                                             int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t x[4];
  ldmatrix_x4(x, s + (r + 8 * (m >> 1)) * ld + 4 * (m & 1));
  split_bits(x[0], f0.hi[0], f0.lo[0]);
  split_bits(x[1], f0.hi[1], f0.lo[1]);
  split_bits(x[2], f1.hi[0], f1.lo[0]);
  split_bits(x[3], f1.hi[1], f1.lo[1]);
}

// B fragment at `s` of a row-major [k][n] array, in the contraction order of
// an accumulator used as A (rows 2t and 2t + 1): the operand of
// c[m][n] += sum_k acc[m][k] b[k][n].
__device__ __forceinline__ void load_b_kn(FragB& f, const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split(s[(2 * t) * ld + g], f.hi[0], f.lo[0]);
  split(s[(2 * t + 1) * ld + g], f.hi[1], f.lo[1]);
}

// A fragment of the 16 x 8 tile whose transpose lies at `s` of a row-major
// [k][m] array, in the plain contraction order (ld = 8 mod 32): the operand
// of c[m][n] += sum_k a[k][m] b[k][n] together with `load_b_kn_std`.
__device__ __forceinline__ void load_a_km(FragA& f, const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split(s[t * ld + g], f.hi[0], f.lo[0]);
  split(s[t * ld + g + 8], f.hi[1], f.lo[1]);
  split(s[(t + 4) * ld + g], f.hi[2], f.lo[2]);
  split(s[(t + 4) * ld + g + 8], f.hi[3], f.lo[3]);
}

// B fragment at `s` of a row-major [k][n] array in the plain contraction
// order (rows t and t + 4; ld = 8 mod 32), for an A fragment that `load_a` or
// `load_a_km` read from shared memory.
__device__ __forceinline__ void load_b_kn_std(FragB& f, const float* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  split(s[t * ld + g], f.hi[0], f.lo[0]);
  split(s[(t + 4) * ld + g], f.hi[1], f.lo[1]);
}

// The 16 x 8 accumulator tile `c` as the A fragment of the next product.
__device__ __forceinline__ void frag_a_from_acc(FragA& f, const float c[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void mma_m16n8k8(float c[4], const uint32_t a[4],
                                            const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] (16 x 8, f32) += a (16 x 8) b[i] (8 x 8), i < N, to f32 accuracy: three
// passes, pass by pass over the N tiles, so that consecutive mma write
// different accumulators and none waits for the one before it. The
// tensor core adds into c itself and truncates: keep the chain through one c
// short (one tile's depth).
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const FragA& a, const FragB* b) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_m16n8k8(c[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_m16n8k8(c[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_m16n8k8(c[i], a.hi, b[i].hi);
}

}  // namespace tf32x3
