// flax nn.Dropout with JAX's threefry mask (kernel D1), f32 and bf16.
//
// Replaces no Pallas kernel: the JAX package computes this in XLA (flax's
// nn.Dropout at the encoder's 13 hidden-state sites, its default
// SE_HIDDEN_DROPOUT_IMPL=flax). D1 fuses the draw, the keep test and the
// select into one pass over x:
//   y[i] = (bits(key, offset + i) >> 9) < thresh23 ? x[i] / keep : 0
// with bits() the threefry2x32 of the element's global flat index (hi, lo)
// under the site's key (threefry.cuh), thresh23 = ceil(float32(1 - rate) *
// 2^23) and keep the divisor flax divides by (float32(1 - rate), or in bf16
// bf16(1 - rate): the division is IEEE in f32, rounded once to bf16). The
// same kernel on the cotangent is the backward (the mask recomputed from the
// key; x is not read again). offset places a data-parallel rank's rows in the
// global draw.
//
// What bounds it on this card: about as much the bytes (x read and y written
// once: 8 bytes an element in f32, 4 in bf16) as the operations (a 20-round
// threefry block, ~80 integer operations an element, on the CUDA cores).
// Design: a thread takes 4 consecutive elements (one 16-byte load in f32, 8
// in bf16, where the pointers and the count allow), over a grid-stride loop of
// enough blocks to fill the card; no shared memory, no synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// 4 elements of T as one vector load / store
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
threefry_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                        unsigned long long offset, uint2 key, uint32_t thresh23, float keep,
                        int vec) {
  using V = typename Vec4<T>::type;
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const long long i0 = 4 * g;
    const bool whole = vec && i0 + 4 <= n;
    alignas(sizeof(V)) T v[4];
    if (whole) {
      *reinterpret_cast<V*>(v) = *reinterpret_cast<const V*>(x + i0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = i0 + e < n ? x[i0 + e] : x[0];
    }
    alignas(sizeof(V)) T out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool kept = threefry::keep(key, offset + (unsigned long long)(i0 + e), thresh23);
      from_f32(kept ? __fdiv_rn(to_f32(v[e]), keep) : 0.f, out + e);
    }
    if (whole) {
      *reinterpret_cast<V*>(y + i0) = *reinterpret_cast<const V*>(out);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e < n) y[i0 + e] = out[e];
    }
  }
}

template <typename T>
int launch(const T* x, T* y, long long n, long long offset, unsigned k0, unsigned k1,
           unsigned thresh23, float keep, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(y) % (4 * sizeof(T)) == 0;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  threefry_dropout_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      x, y, n, (unsigned long long)offset, make_uint2(k0, k1), thresh23, keep, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = dropout of x (n elements, contiguous) under the key (k0, k1): element i
// keyed on the global flat index offset + i; thresh23 and keep (the divisor,
// already in x's dtype) computed by the caller. Returns a cudaError_t.
int threefry_dropout_f32(const void* x, void* y, long long n, long long offset, unsigned k0,
                         unsigned k1, unsigned thresh23, float keep, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch(static_cast<const float*>(x), static_cast<float*>(y), n, offset, k0, k1,
                thresh23, keep, device, static_cast<cudaStream_t>(stream));
}

int threefry_dropout_bf16(const void* x, void* y, long long n, long long offset, unsigned k0,
                          unsigned k1, unsigned thresh23, float keep, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, offset,
                k0, k1, thresh23, keep, device, static_cast<cudaStream_t>(stream));
}

const char* threefry_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
