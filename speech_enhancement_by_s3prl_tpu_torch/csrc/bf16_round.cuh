// Rounding to bf16 for the bf16-h forms of the LSTM kernels (B1, B2 fwd, B2
// bwd, and the bf16 dW_hh^T of lstm_tm_bwd.cu): the one-direction layer of
// the JAX package in bf16 is a lax.scan cell that rounds h to bf16 for its
// step product and keeps h and c in f32.
#pragma once

#include <cuda_bf16.h>

// x rounded to the nearest bf16 (ties to even, as astype(bfloat16) rounds),
// held in f32. A bf16 value is exact in f32 and in TF32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a and b rounded as bf16_round rounds them, in one conversion instruction
// (cvt.rn.bf16x2.f32).
__device__ __forceinline__ float2 bf16_round2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}
