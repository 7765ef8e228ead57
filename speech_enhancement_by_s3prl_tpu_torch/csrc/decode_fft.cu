// Fused decode as an in-kernel inverse FFT: magnitude from the predicted
// spectrum, phase carrier rescaled to it, a mixed-radix inverse real FFT of
// every frame, synthesis window and overlap-add in one kernel, f32, for
// Hopper.
//
// Replaces decode_ola_pallas / _kernel in
// speech_enhancement_by_s3prl_tpu/ops/pallas/decode_kernel.py (kernel B5) for
// every n_fft whose half factors into 2, 3, 4 and 5; decode_ola.cu (the TPU
// kernel's design: spectra times the window-folded inverse-DFT matrix) keeps
// the rest.
//
// Computes, for pred (B, T, F) and the packed carrier uph (B, T, 2F) = [re | im]
// (F = n_fft / 2 + 1):
//   mag = pred ^ (1 / power)            (sqrt at power 2, pred itself at 1)
//   X[k] = mag * (re, im) / |z|, and mag * (1, 0) where |z| = 0
//   frame[t, n] = w[n] irfft(X)[n]      (n < n_fft; irfft reads no imaginary
//                                        part at bins 0 and n_fft / 2)
//   out[b, r * hop + s] = sum_{j < K} frame[r - j, j * hop + s]
// with K = ceil(n_fft / hop), hop-rows r = 0 .. T + K - 2, and frames outside
// [0, T) contributing nothing. out (B, (T + K - 1) * hop) is the raw
// overlap-add: the caller trims the centre padding and divides by the
// window-square envelope. f32 throughout.
//
// What bounds it on this card: bytes. The product design of decode_ola.cu
// spends 2 * 402 * 400 = 322 k operations a frame on the inverse DFT; the
// FFT of the same frame costs about 13 k, and then the 603 floats read and
// 160 written a frame are what is left (3.06 MB a 10 s row). One row alone is
// so little work that launch latency shows.
//
// Design. The inverse of stft_fft.cu's: the rescaled spectrum X[0..M]
// (M = n_fft / 2) is packed into the M-point sequence
//   Z[k] = E[k] + i O[k],  E[k] = (X[k] + conj X[M - k]) / 2,
//                          O[k] = (X[k] - conj X[M - k]) exp(+2 pi i k / n_fft) / 2,
// whose inverse transform is z[n] = x[2n] + i x[2n + 1], M times over. The
// imaginary parts of X[0] and X[M] are zeroed first: the carrier is
// normalised, so they are as large as mag there, and the inverse real DFT
// does not read them (sin 0 = sin pi n = 0) while the packing would fold them
// into Z[0]. The inverse transform is fft_stockham.cuh's forward passes on
// swapped real and imaginary parts. The window table carries the 1 / M.
//
// Output-stationary. Blocks run in no order, so no block carries an overlap
// into the next, as the TPU kernel's scratch does. A block owns tf
// consecutive output hop-rows [r0, r0 + tf) of one batch row and synthesizes
// the kWarps * fpw windowed frames r0 - K + 1 .. r0 + tf - 1 into shared
// memory, one warp a frame at a time (its K - 1 leading frames are the
// neighbour's last, synthesized again there), then writes each of its
// samples once, summing the K overlapping slots in j order. No atomics and
// no second pass: every output is the same sums in the same order on every
// run and under any tiling, so a row's bits do not depend on how many rows
// share its launch. tf is picked by grid size: one frame a warp (8 a block,
// tf = 6 at the flagship's K = 3, a quarter of the frames done twice) while
// such blocks fit the card in about one wave, so that one row of 1001 frames
// spreads over the SMs; two (16 a block, tf = 14, an eighth done twice) from
// a few rows up. Four would leave 82 KB of shared memory a block and so two
// blocks a SM: on the card they were slower than two at every size, and one
// was slower than two from 12 rows up (chip_smoke.py times each). Window,
// twiddles and unpack factors come from
// one table built on the host in float64 (ops/cuda/decode_kernel.
// decode_fft_tables); the kernel evaluates no sine. F = 201 is odd, so the
// im half of uph starts at no vector-aligned address: scalar loads. The
// Python model decode_fft_model runs these steps on the same tables, index
// for index.

#include <cuda_runtime.h>

#include "fft_stockham.cuh"
#include "launch_setup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

KernelSetup g_setup[kMaxDevices];

// mode: 1 -> mag = pred, 2 -> sqrt(pred), 0 -> pred ^ inv_power
__global__ void __launch_bounds__(kThreads)
decode_fft_kernel(const float* __restrict__ pred, const float* __restrict__ uph,
                  const float* __restrict__ tables, float* __restrict__ out, int T,
                  int n_fft, int hop, int K, int mode, float inv_power, int row_tiles,
                  int fpw, int tab_pad, int mpad, Plan plan) {
  extern __shared__ float smem[];
  const int M = n_fft / 2, F = M + 1;
  const int nf = kWarps * fpw;    // frames a block synthesizes
  const int tf = nf - (K - 1);    // output hop-rows a block writes
  const float* win = smem;        // synthesis window / M
  const float* twr = win + n_fft;
  const float* twi = twr + M;
  const float* spr = twi + M;     // exp(+2 pi i k / n_fft)
  const float* spi = spr + M + 1;
  float* frames = smem + tab_pad;  // [nf][n_fft] windowed frames
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* buf = frames + nf * n_fft + warp * 4 * mpad;  // this warp's two (re, im) buffers

  const int b = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * tf;
  const int t0 = r0 - (K - 1);  // the frame in local slot 0

  for (int i = tid; i < 3 * n_fft + 2; i += kThreads) smem[i] = tables[i];
  __syncthreads();

  for (int i = 0; i < fpw; ++i) {
    const int fl = warp * fpw + i, t = t0 + fl;
    if (t < 0 || t >= T) continue;  // the whole warp: such a frame is never read
    float* ar = buf;
    float* ai = buf + mpad;
    float* br = buf + 2 * mpad;
    float* bi = buf + 3 * mpad;
    // 1. the rescaled spectrum X[0..M] into (br, bi)
    const float* p = pred + ((size_t)b * T + t) * F;
    const float* z = uph + ((size_t)b * T + t) * 2 * F;
    for (int k = lane; k <= M; k += 32) {
      const float pk = p[k], zr = z[k], zi = z[F + k];
      const float mag = mode == 1 ? pk : (mode == 2 ? sqrtf(pk) : powf(pk, inv_power));
      const float zmag = sqrtf(zr * zr + zi * zi);
      const bool pos = zmag > 0.0f;
      const float inv_z = 1.0f / (pos ? zmag : 1.0f);
      br[k] = mag * (pos ? zr * inv_z : 1.0f);
      bi[k] = (k == 0 || k == M) ? 0.0f : mag * (pos ? zi * inv_z : 0.0f);
    }
    __syncwarp();
    // 2. pack Z[k], k < M, swapped: Re Z into the imaginary array, Im Z into
    // the real one (k = 0 pairs with X[M])
    for (int k = lane; k < M; k += 32) {
      const float xr = br[k], xi = bi[k], yr = br[M - k], yi = bi[M - k];
      const float er = 0.5f * (xr + yr), ei = 0.5f * (xi - yi);
      const float dr = 0.5f * (xr - yr), di = 0.5f * (xi + yi);
      const float o_r = dr * spr[k] - di * spi[k], o_i = dr * spi[k] + di * spr[k];
      ai[k] = er - o_i;
      ar[k] = ei + o_r;
    }
    __syncwarp();
    fft_passes(ar, ai, br, bi, twr, twi, M, plan, lane);
    // 3. x[2n] = Re z[n] (the imaginary array), x[2n + 1] = Im z[n] (the real
    // one), times the window / M, into the frame store
    float* f = frames + fl * n_fft;
    for (int n = lane; n < n_fft; n += 32) f[n] = win[n] * ((n & 1) ? ar : ai)[n >> 1];
    __syncwarp();  // the buffers are free for the next frame
  }
  __syncthreads();

  // 4. overlap-add: hop-row r0 + i reads frame r0 + i - j from local slot
  // i + K - 1 - j; the block's rows are one contiguous run of out
  const int rows_total = T + K - 1;
  const int rows = min(tf, rows_total - r0);
  float* o = out + ((size_t)b * rows_total + r0) * hop;
  for (int idx = tid; idx < rows * hop; idx += kThreads) {
    const int i = idx / hop, s = idx - i * hop;
    float acc = 0.0f;
    for (int j = 0; j < K; ++j) {
      const int t = r0 + i - j, n = j * hop + s;
      if (t >= 0 && t < T && n < n_fft) acc += frames[(i + K - 1 - j) * n_fft + n];
    }
    o[idx] = acc;
  }
}

}  // namespace

extern "C" {

// Kernel B5, FFT route. pred (B, T, F), uph (B, T, 2F), tables (3 * n_fft + 2:
// window / M, twiddles, unpack factors) and out (B, (T + K - 1) * hop),
// K = ceil(n_fft / hop), are contiguous f32 device pointers on `device`;
// radices (host memory) are the n_passes radices, each 2 .. 5, whose product
// is n_fft / 2. fpw, the frames a warp synthesizes, is 0 for the kernel's
// own choice (the wrapper's call), or a count to force (a measurement).
// Launches on `stream`, does not synchronise; returns the first non-zero CUDA
// status, 0 on success (cudaErrorInvalidValue where the shapes or the
// shared memory do not fit).
int decode_fft_f32(const void* pred, const void* uph, const void* tables, void* out, int B,
                   int T, int n_fft, int hop, float linear_power, const int* radices,
                   int n_passes, int fpw, int device, void* stream) {
  Plan plan;
  if (B <= 0 || T <= 0 || hop <= 0 || n_fft < 4 || n_fft % 2 || !(linear_power > 0.0f) ||
      fpw < 0 || !make_plan(radices, n_passes, n_fft / 2, &plan))
    return (int)cudaErrorInvalidValue;
  const KernelSetup* setup;
  cudaError_t err = setup_on(device, g_setup, decode_fft_kernel, &setup);
  if (err != cudaSuccess) return (int)err;

  const int K = (n_fft + hop - 1) / hop;
  const int M = n_fft / 2;
  const int mpad = (M + 16) / 32 * 32 + 16;  // >= M + 1 and 16 (mod 32)
  const int tab_pad = (3 * n_fft + 2 + 3) / 4 * 4;
  const long rows_total = (long)T + K - 1;
  auto smem_bytes = [&](int f) {
    return sizeof(float) * ((size_t)tab_pad + (size_t)kWarps * f * n_fft +
                            (size_t)kWarps * 4 * mpad);
  };
  auto tiles = [&](int f) { return (rows_total + kWarps * f - K) / (kWarps * f - K + 1); };
  if (fpw == 0) {
    // the fewest frames a warp that keep the re-synthesized halo under half
    // of a block's frames; twice that once such blocks would outnumber four
    // a SM, unless the shared memory does not fit
    int least = 1;
    while (kWarps * least <= 2 * (K - 1)) least *= 2;
    fpw = (long)B * tiles(least) > 4L * setup->sms ? 2 * least : least;
    if (fpw > least && smem_bytes(fpw) > (size_t)setup->smem_optin) fpw = least;
  }
  if (kWarps * fpw <= K - 1 || smem_bytes(fpw) > (size_t)setup->smem_optin)
    return (int)cudaErrorInvalidValue;
  const long row_tiles = tiles(fpw);
  if ((long)B * row_tiles > 2147483647L) return (int)cudaErrorInvalidValue;
  const int mode = linear_power == 1.0f ? 1 : (linear_power == 2.0f ? 2 : 0);
  decode_fft_kernel<<<(int)(B * row_tiles), kThreads, smem_bytes(fpw),
                      (cudaStream_t)stream>>>(
      (const float*)pred, (const float*)uph, (const float*)tables, (float*)out, T, n_fft, hop,
      K, mode, 1.0f / linear_power, (int)row_tiles, fpw, tab_pad, mpad, plan);
  return (int)cudaGetLastError();
}

const char* decode_fft_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
