// Rounding to bf16 for the bf16-h forms of the LSTM kernels (B1, B2 fwd, B2
// bwd): the one-direction layer of
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

// The stream forms of the LSTM kernels read xw, hs, cs or dhs as bf16 and
// write hs, cs or dxw as bf16: an element widened where it is read (exact),
// or rounded as astype(bfloat16) rounds where it is stored. The f32
// overloads are the identity, so one body serves both dtypes.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive bf16 elements (8 bytes, one load) widened.
__device__ __forceinline__ float4 widen4(uint2 raw) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The bf16 element in the low (hi false) or high half of a 4-byte word held
// in a float's bits, widened to f32 (a bf16 is the top half of its f32).
__device__ __forceinline__ float bf16_half(float word, bool hi) {
  const unsigned int w = __float_as_uint(word);
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}
