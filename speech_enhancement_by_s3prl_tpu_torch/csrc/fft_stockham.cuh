// Mixed-radix Stockham FFT passes of one warp over an M-point complex
// sequence in shared memory, shared by the fused STFT (stft_fft.cu, kernel B4)
// and the fused decode (decode_fft.cu, kernel B5).
//
// One pass per radix of the plan (2, 3, 4 or 5; the product is M),
// ping-ponging between two buffers: butterfly b = p * s + q reads b + k * M / r
// (unit stride across lanes) and writes q + s * (r * p + j) times the twiddle
// exp(-2 pi i p s j / M), so the result is in natural order with no digit
// reversal. Apart from the first pass (stride r: the plan puts an odd radix
// there when it has one) stores are unit-stride too. Real and imaginary parts
// live in separate arrays; the callers keep them 16 (mod 32) floats apart so
// that de-interleaving a frame's samples into or out of them is conflict-free.
//
// The passes compute the forward transform (e^{-i}). The inverse is the same
// passes on swapped data: with swap(a + i b) = b + i a,
// sum_k Z[k] e^{+2 pi i k n / M} = swap(DFT(swap(Z)))[n], so a caller that
// stores Re Z in the imaginary array and Im Z in the real array reads the
// inverse's real part from the imaginary array and its imaginary part from
// the real one.
//
// The Python model of these passes is ops/cuda/stft_kernel._stockham, index
// for index.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPasses = 12;

struct Plan {
  int n;
  int r[kMaxPasses];
};

// The r-point forward DFT of (ar, ai) in place.
template <int R>
__device__ __forceinline__ void butterfly(float* ar, float* ai);

template <>
__device__ __forceinline__ void butterfly<2>(float* ar, float* ai) {
  const float r0 = ar[0] + ar[1], i0 = ai[0] + ai[1];
  ar[1] = ar[0] - ar[1], ai[1] = ai[0] - ai[1];
  ar[0] = r0, ai[0] = i0;
}

template <>
__device__ __forceinline__ void butterfly<3>(float* ar, float* ai) {
  constexpr float kS3 = 0.8660254037844386f;  // sin(2 pi / 3)
  const float tr = ar[1] + ar[2], ti = ai[1] + ai[2];
  const float mr = ar[0] - 0.5f * tr, mi = ai[0] - 0.5f * ti;
  const float nr = kS3 * (ar[1] - ar[2]), ni = kS3 * (ai[1] - ai[2]);
  ar[0] += tr, ai[0] += ti;
  ar[1] = mr + ni, ai[1] = mi - nr;  // m - i n
  ar[2] = mr - ni, ai[2] = mi + nr;  // m + i n
}

template <>
__device__ __forceinline__ void butterfly<4>(float* ar, float* ai) {
  const float t0r = ar[0] + ar[2], t0i = ai[0] + ai[2], t1r = ar[0] - ar[2], t1i = ai[0] - ai[2];
  const float t2r = ar[1] + ar[3], t2i = ai[1] + ai[3], t3r = ar[1] - ar[3], t3i = ai[1] - ai[3];
  ar[0] = t0r + t2r, ai[0] = t0i + t2i;
  ar[1] = t1r + t3i, ai[1] = t1i - t3r;  // t1 - i t3
  ar[2] = t0r - t2r, ai[2] = t0i - t2i;
  ar[3] = t1r - t3i, ai[3] = t1i + t3r;  // t1 + i t3
}

template <>
__device__ __forceinline__ void butterfly<5>(float* ar, float* ai) {
  // cos and sin of 2 pi / 5 and 4 pi / 5
  constexpr float kC1 = 0.30901699437494745f, kC2 = -0.8090169943749475f;
  constexpr float kS1 = 0.9510565162951535f, kS2 = 0.5877852522924731f;
  const float t1r = ar[1] + ar[4], t1i = ai[1] + ai[4], t2r = ar[2] + ar[3], t2i = ai[2] + ai[3];
  const float t3r = ar[1] - ar[4], t3i = ai[1] - ai[4], t4r = ar[2] - ar[3], t4i = ai[2] - ai[3];
  const float m1r = ar[0] + kC1 * t1r + kC2 * t2r, m1i = ai[0] + kC1 * t1i + kC2 * t2i;
  const float m2r = ar[0] + kC2 * t1r + kC1 * t2r, m2i = ai[0] + kC2 * t1i + kC1 * t2i;
  const float n1r = kS1 * t3r + kS2 * t4r, n1i = kS1 * t3i + kS2 * t4i;
  const float n2r = kS2 * t3r - kS1 * t4r, n2i = kS2 * t3i - kS1 * t4i;
  ar[0] += t1r + t2r, ai[0] += t1i + t2i;
  ar[1] = m1r + n1i, ai[1] = m1i - n1r;  // m1 - i n1
  ar[2] = m2r + n2i, ai[2] = m2i - n2r;  // m2 - i n2
  ar[3] = m2r - n2i, ai[3] = m2i + n2r;  // m2 + i n2
  ar[4] = m1r - n1i, ai[4] = m1i + n1r;  // m1 + i n1
}

// One Stockham pass of radix R over a warp's M-point sequence: s sequences of
// length M / s are interleaved in x; afterwards s * R of length M / (s * R)
// in y. twr / twi hold exp(-2 pi i t / M).
template <int R>
__device__ __forceinline__ void fft_pass(const float* xr, const float* xi, float* yr, float* yi,
                                         const float* twr, const float* twi, int M, int s,
                                         int lane) {
  const int nb = M / R;  // butterflies, and the stride between their inputs
  for (int b = lane; b < nb; b += 32) {
    const int q = b % s, ps = b - q;  // ps = p * s
    float ar[R], ai[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ar[k] = xr[b + k * nb];
      ai[k] = xi[b + k * nb];
    }
    butterfly<R>(ar, ai);
    const int o = q + ps * R;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float wr = twr[ps * j], wi = twi[ps * j];
      yr[o + s * j] = ar[j] * wr - ai[j] * wi;
      yi[o + s * j] = ar[j] * wi + ai[j] * wr;
    }
  }
}

// Every pass of the plan over the sequence in (ar, ai), with (br, bi) as the
// other buffer. The whole warp calls it after a __syncwarp(); on return
// (ar, ai) name the buffers that hold the transform, (br, bi) the free ones.
__device__ __forceinline__ void fft_passes(float*& ar, float*& ai, float*& br, float*& bi,
                                           const float* twr, const float* twi, int M,
                                           const Plan& plan, int lane) {
  int s = 1;
  for (int pass = 0; pass < plan.n; ++pass) {
    const int r = plan.r[pass];
    switch (r) {
      case 2: fft_pass<2>(ar, ai, br, bi, twr, twi, M, s, lane); break;
      case 3: fft_pass<3>(ar, ai, br, bi, twr, twi, M, s, lane); break;
      case 4: fft_pass<4>(ar, ai, br, bi, twr, twi, M, s, lane); break;
      default: fft_pass<5>(ar, ai, br, bi, twr, twi, M, s, lane); break;
    }
    __syncwarp();
    float* tr = ar; ar = br; br = tr;
    float* ti = ai; ai = bi; bi = ti;
    s *= r;
  }
}

// The host's check of a plan: n_passes radices, each 2 .. 5, whose product is
// M. Fills `plan`; false where the radices are not such a plan.
inline bool make_plan(const int* radices, int n_passes, int M, Plan* plan) {
  if (n_passes <= 0 || n_passes > kMaxPasses) return false;
  plan->n = n_passes;
  long product = 1;
  for (int i = 0; i < n_passes; ++i) {
    if (radices[i] < 2 || radices[i] > 5) return false;
    plan->r[i] = radices[i];
    product *= radices[i];
  }
  return product == M;
}

}  // namespace
