// Fused decode: magnitude from the predicted spectrum, phase carrier rescaled
// to it, window-folded inverse real DFT and overlap-add in one kernel, f32,
// for Hopper.
//
// Replaces decode_ola_pallas / _kernel in
// speech_enhancement_by_s3prl_tpu/ops/pallas/decode_kernel.py (kernel B5) for
// an n_fft whose half has a prime factor above 5 (e.g. 254 = 2 * 127);
// decode_fft.cu, an inverse FFT, takes every other.
//
// Computes, for pred (B, T, F) and the packed carrier uph (B, T, 2F) = [re | im]:
//   mag = pred ^ (1 / power)            (sqrt at power 2, pred itself at 1)
//   |z| = sqrt(re^2 + im^2);  spec = mag * (re, im) / |z|, and mag * (1, 0)
//         where |z| = 0 (the phase-0 carrier)
//   frame[t, n] = sum_{c < 2F} spec[t, c] * winv[c, n]      (n < n_fft)
//   out[b, r * hop + s] = sum_{j < K} frame[r - j, j * hop + s]
// with winv the (2F, n_fft) inverse real-DFT matrix times the synthesis window,
// K = ceil(n_fft / hop), hop-rows r = 0 .. T + K - 2, and frames outside
// [0, T) contributing nothing. out (B, (T + K - 1) * hop) is the raw
// overlap-add: the caller trims the centre padding and divides by the
// window-square envelope. f32 operands, f32 accumulation.
//
// What bounds it on this card: operations (a 10 s row is about 0.32 GFLOP of
// live products against 3 MB moved); one row alone sits near launch latency.
//
// Design: output-stationary. Blocks on this card run in no order, so nothing
// can be carried from one time block to the next as the TPU kernel's scratch
// does. Instead the overlap-add is folded into the product: out[r, s] is one
// dot product of length K * 2F between the spectra of frames r, r-1, .., r-K+1
// and the matching column slices of winv. A block owns kR hop-rows of one
// batch row, stages the rescaled spectra of its kR + K - 1 frames in shared
// memory (a halo of K - 1 frames is rescaled again by the neighbour; no frame
// is synthesized twice), walks winv in slabs of kKT rows through shared
// memory, and writes every output sample exactly once: no carry, no atomics,
// the same sums in the same order on every run. winv (643 KB at 402 x 400)
// does not fit shared memory, hence the slabs. F = 201 is odd, so the im half
// of uph starts at no vector-aligned address: it is read with scalar loads at
// column offset F. Slab columns past n_fft (slot K - 1 holds only
// n_fft - (K - 1) * hop live samples) load as zeros, and a column tile that
// lies wholly past n_fft skips the slot.

#include <cuda_runtime.h>

#include "launch_setup.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kR = 16;     // output hop-rows a block
constexpr int kRW = kR / (kThreads / 32);  // hop-rows a warp: 4
constexpr int kCL = 5;     // columns a lane
constexpr int kCT = 32 * kCL;  // columns a block: 160
constexpr int kKT = 16;    // winv rows a slab

KernelSetup g_setup[kMaxDevices];

// mode: 1 -> mag = pred, 2 -> sqrt(pred), 0 -> pred ^ inv_power
__global__ void __launch_bounds__(kThreads)
decode_ola_kernel(const float* __restrict__ pred, const float* __restrict__ uph,
                  const float* __restrict__ winv, float* __restrict__ out, int T, int F,
                  int n_fft, int hop, int K, int mode, float inv_power, int row_tiles) {
  extern __shared__ float smem[];
  const int F2 = 2 * F;
  const int staged = kR + K - 1;
  float* spec_s = smem;                // [kR + K - 1][2F] rescaled spectra
  float* w_s = smem + staged * F2;     // [kKT][kCT] slab of winv

  const int b = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * kR;
  const int s0 = blockIdx.y * kCT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rows_total = T + K - 1;

  // frames r0 - K + 1 .. r0 + kR - 1, rescaled; zeros outside [0, T)
  for (int idx = tid; idx < staged * F; idx += kThreads) {
    const int lt = idx / F, c = idx % F;
    const int t = r0 - (K - 1) + lt;
    float re = 0.0f, im = 0.0f;
    if (t >= 0 && t < T) {
      const float p = pred[((size_t)b * T + t) * F + c];
      const float* z = uph + ((size_t)b * T + t) * F2;
      const float zr = z[c], zi = z[F + c];
      const float mag = mode == 1 ? p : (mode == 2 ? sqrtf(p) : powf(p, inv_power));
      const float zmag = sqrtf(zr * zr + zi * zi);
      const bool pos = zmag > 0.0f;
      const float inv_z = 1.0f / (pos ? zmag : 1.0f);
      re = mag * (pos ? zr * inv_z : 1.0f);
      im = mag * (pos ? zi * inv_z : 0.0f);
    }
    spec_s[lt * F2 + c] = re;
    spec_s[lt * F2 + F + c] = im;
  }

  float acc[kRW][kCL];
#pragma unroll
  for (int i = 0; i < kRW; ++i)
#pragma unroll
    for (int q = 0; q < kCL; ++q) acc[i][q] = 0.0f;

  for (int j = 0; j < K; ++j) {
    if (j * hop + s0 >= n_fft) continue;  // this slot has no live column here
    // local row i of this warp reads frame r - j: staged row lr + i + K-1 - j
    const float* a0 = spec_s + (warp * kRW + K - 1 - j) * F2;
    for (int c0 = 0; c0 < F2; c0 += kKT) {
      __syncthreads();  // spec_s is staged; the previous slab is no longer read
      for (int idx = tid; idx < kKT * kCT; idx += kThreads) {
        const int c = c0 + idx / kCT, s = s0 + idx % kCT;
        const int n = j * hop + s;
        w_s[idx] = (c < F2 && s < hop && n < n_fft) ? winv[(size_t)c * n_fft + n] : 0.0f;
      }
      __syncthreads();
      const int kmax = min(kKT, F2 - c0);
#pragma unroll 4
      for (int kk = 0; kk < kmax; ++kk) {
        float w[kCL];
#pragma unroll
        for (int q = 0; q < kCL; ++q) w[q] = w_s[kk * kCT + lane * kCL + q];
#pragma unroll
        for (int i = 0; i < kRW; ++i) {
          const float a = a0[i * F2 + c0 + kk];
#pragma unroll
          for (int q = 0; q < kCL; ++q) acc[i][q] = fmaf(a, w[q], acc[i][q]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int r = r0 + warp * kRW + i;
    if (r >= rows_total) continue;
    float* o = out + ((size_t)b * rows_total + r) * hop;
#pragma unroll
    for (int q = 0; q < kCL; ++q) {
      const int s = s0 + lane * kCL + q;
      if (s < hop) o[s] = acc[i][q];
    }
  }
}

}  // namespace

extern "C" {

// Kernel B5, product route. pred (B, T, F), uph (B, T, 2F), winv (2F, n_fft) and out
// (B, (T + K - 1) * hop), K = ceil(n_fft / hop), are contiguous f32 device
// pointers on `device`. Launches on `stream`, does not synchronise; returns
// the first non-zero CUDA status, 0 on success.
int decode_ola_f32(const void* pred, const void* uph, const void* winv, void* out, int B,
                   int T, int F, int n_fft, int hop, float linear_power, int device,
                   void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || n_fft <= 0 || hop <= 0 || !(linear_power > 0.0f))
    return (int)cudaErrorInvalidValue;
  const KernelSetup* setup;
  cudaError_t err = setup_on(device, g_setup, decode_ola_kernel, &setup);
  if (err != cudaSuccess) return (int)err;
  const int K = (n_fft + hop - 1) / hop;
  const int row_tiles = (T + K - 1 + kR - 1) / kR;
  const size_t smem = sizeof(float) * ((size_t)(kR + K - 1) * 2 * F + kKT * kCT);
  if (smem > (size_t)setup->smem_optin || (long)B * row_tiles > 2147483647L)
    return (int)cudaErrorInvalidValue;
  const int mode = linear_power == 1.0f ? 1 : (linear_power == 2.0f ? 2 : 0);
  const dim3 grid(B * row_tiles, (hop + kCT - 1) / kCT);
  decode_ola_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)uph, (const float*)winv, (float*)out, T, F, n_fft,
      hop, K, mode, 1.0f / linear_power, row_tiles);
  return (int)cudaGetLastError();
}

const char* decode_ola_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
