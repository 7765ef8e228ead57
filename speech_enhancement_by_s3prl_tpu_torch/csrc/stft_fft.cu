// Fused STFT as an in-kernel FFT: reflect-padded framing, Hann window and a
// mixed-radix real FFT of every frame in one kernel, f32, for Hopper.
//
// Replaces stft_pallas / _kernel in
// speech_enhancement_by_s3prl_tpu/ops/pallas/stft_kernel.py (kernel B4), for
// every n_fft whose half factors into 2, 3, 4 and 5; stft_fused.cu (the TPU
// kernel's design: frames times the window-folded DFT matrix) keeps the rest.
//
// Computes, for each row of wav (N, time) and each frame f = 0 .. n_frames-1
// (n_frames = 1 + time / hop, torch.stft's center=True framing), with xpad
// the row reflect-padded by n_fft / 2 at both ends and w the padded window:
//   X[k] = sum_{n < n_fft} w[n] xpad[f * hop + n] exp(-2 pi i n k / n_fft)
//   out[row, f, k] = Re X[k],  out[row, f, n_freq + k] = Im X[k],
//   k = 0 .. n_fft / 2,  n_freq = n_fft / 2 + 1.
//
// What bounds it on this card: bytes. The matrix product costs 2 * 400 * 402
// = 322 k operations a frame at the flagship's 400 points, which bound the
// product kernel on the CUDA cores; an FFT costs about 17 k, and then the
// 0.64 MB in and 1.61 MB out of a 10 s row are what is left. One row alone is
// so little work that launch latency shows.
//
// Design. Which decomposition: the real frame is packed as the M = n_fft / 2
// point complex sequence z[n] = x[2n] + i x[2n + 1], transformed, and split
// (X[k] = E[k] + exp(-2 pi i k / n_fft) O[k], with E and O the transforms of
// the even and odd samples, recovered from Z[k] and conj(Z[M - k])). That
// halves the butterflies against a 400-point complex transform with half its
// outputs dropped, and unlike a four-step 16 x 25 decomposition in registers
// it needs no code per n_fft: the radix list is an argument, so one kernel
// serves every geometry a configuration may name. The transform is the
// Stockham autosort FFT of fft_stockham.cuh (shared with the fused decode,
// decode_fft.cu), one pass per radix, ping-ponging between two buffers in
// shared memory, results in natural order. Real and imaginary parts live in
// separate arrays whose offset is 16 (mod 32) floats, so that de-interleaving
// a frame's samples into them is conflict-free.
//
// One warp transforms one frame; a block of 8 warps stages the contiguous
// samples of its 8 or 32 frames in shared memory once (frames overlap: n_fft
// = 2.5 hops), reflecting at the two edges by index, so no padded waveform
// and no frame matrix ever exists in device memory, and the 1001 frames of
// one row spread over all SMs. Window, twiddles and split factors come from
// one table built on the host in float64 (ops/cuda/stft_kernel.fft_tables);
// the kernel evaluates no sine. A frame's 402 outputs are stored as two
// coalesced runs. The Python model stft_fft_model runs these passes on the
// same tables, index for index.

#include <cuda_runtime.h>

#include "fft_stockham.cuh"
#include "launch_setup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

KernelSetup g_setup[kMaxDevices];

__global__ void __launch_bounds__(kThreads)
stft_fft_kernel(const float* __restrict__ wav, const float* __restrict__ tables,
                float* __restrict__ out, int time, int n_frames, int n_fft, int hop,
                int frame_tiles, int fpw, int tab_pad, int span_pad, int mpad, Plan plan) {
  extern __shared__ float smem[];
  const int M = n_fft / 2, n_freq = M + 1;
  const float* win = smem;
  const float* twr = win + n_fft;
  const float* twi = twr + M;
  const float* spr = twi + M;
  const float* spi = spr + M + 1;
  float* x_s = smem + tab_pad;  // the samples of this block's frames
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* buf = x_s + span_pad + warp * 4 * mpad;  // this warp's two (re, im) buffers

  const int tf = kWarps * fpw;  // frames a block
  const int row = blockIdx.x / frame_tiles;
  const int f0 = (blockIdx.x % frame_tiles) * tf;

  for (int i = tid; i < 3 * n_fft + 2; i += kThreads) smem[i] = tables[i];
  const float* x = wav + (size_t)row * time;
  const int span = (tf - 1) * hop + n_fft;
  const long first = (long)f0 * hop - n_fft / 2;  // index into wav of x_s[0]
  for (int q = tid; q < span; q += kThreads) {
    long j = first + q;
    if (j < 0) j = -j;                               // reflect at the start
    else if (j >= time) j = 2L * (time - 1) - j;     // and at the end
    // frames past n_frames (the ragged last tile) may reach further: zeros
    x_s[q] = (j >= 0 && j < time) ? x[j] : 0.0f;
  }
  __syncthreads();

  for (int i = 0; i < fpw; ++i) {
    const int fl = warp * fpw + i, f = f0 + fl;
    if (f >= n_frames) break;  // the whole warp leaves: frames past the end are never stored
    float* ar = buf;
    float* ai = buf + mpad;
    float* br = buf + 2 * mpad;
    float* bi = buf + 3 * mpad;
    // window; even samples to the real, odd samples to the imaginary part
    const float* xs = x_s + fl * hop;
    for (int idx = lane; idx < n_fft; idx += 32)
      ((idx & 1) ? ai : ar)[idx >> 1] = xs[idx] * win[idx];
    __syncwarp();

    fft_passes(ar, ai, br, bi, twr, twi, M, plan, lane);

    // split pass: bins 0 and M both read Z[0] (Z[M] = Z[0])
    float* o = out + ((size_t)row * n_frames + f) * (2 * n_freq);
    for (int k = lane; k <= M; k += 32) {
      const int ka = k == M ? 0 : k, kb = k == 0 ? 0 : M - k;
      const float zra = ar[ka], zia = ai[ka], zrb = ar[kb], zib = ai[kb];
      const float er = 0.5f * (zra + zrb), ei = 0.5f * (zia - zib);
      const float o_r = 0.5f * (zia + zib), o_i = -0.5f * (zra - zrb);
      o[k] = er + spr[k] * o_r - spi[k] * o_i;
      o[n_freq + k] = ei + spr[k] * o_i + spi[k] * o_r;
    }
    __syncwarp();  // the buffers are free for the next frame
  }
}

}  // namespace

extern "C" {

// Kernel B4, FFT route. wav (n_rows, time), tables (3 * n_fft + 2: window,
// twiddles, split factors) and out (n_rows, 1 + time / hop, n_fft + 2) are
// contiguous f32 device pointers on `device`; radices (host memory) are the
// n_passes radices, each 2 .. 5, whose product is n_fft / 2; time > n_fft / 2
// (one reflection). Launches on `stream`, does not synchronise; returns the
// first non-zero CUDA status, 0 on success.
int stft_fft_f32(const void* wav, const void* tables, void* out, int n_rows, int time,
                 int n_fft, int hop, const int* radices, int n_passes, int device,
                 void* stream) {
  Plan plan;
  if (n_rows <= 0 || hop <= 0 || n_fft < 4 || n_fft % 2 || time <= n_fft / 2 ||
      !make_plan(radices, n_passes, n_fft / 2, &plan))
    return (int)cudaErrorInvalidValue;
  const KernelSetup* setup;
  cudaError_t err = setup_on(device, g_setup, stft_fft_kernel, &setup);
  if (err != cudaSuccess) return (int)err;
  const int smem_optin = setup->smem_optin, sms = setup->sms;

  const int n_frames = 1 + time / hop;
  const int M = n_fft / 2;
  const int mpad = (M + 15) / 32 * 32 + 16;  // >= M and 16 (mod 32)
  const int tab_pad = (3 * n_fft + 2 + 3) / 4 * 4;
  auto smem_bytes = [&](int fpw, int* span_pad) {
    *span_pad = ((kWarps * fpw - 1) * hop + n_fft + 3) / 4 * 4;
    return sizeof(float) * ((size_t)tab_pad + *span_pad + (size_t)kWarps * 4 * mpad);
  };
  // one frame a warp while that leaves at most eight blocks a SM, else four,
  // which stage the tables and the frames' overlap less often
  int fpw = (long)n_rows * ((n_frames + kWarps - 1) / kWarps) <= 8L * sms ? 1 : 4;
  int span_pad;
  if (smem_bytes(fpw, &span_pad) > (size_t)smem_optin) fpw = 1;
  const size_t smem = smem_bytes(fpw, &span_pad);
  const int tf = kWarps * fpw;
  const int frame_tiles = (n_frames + tf - 1) / tf;
  if (smem > (size_t)smem_optin || (long)n_rows * frame_tiles > 2147483647L)
    return (int)cudaErrorInvalidValue;
  stft_fft_kernel<<<n_rows * frame_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)tables, (float*)out, time, n_frames, n_fft, hop,
      frame_tiles, fpw, tab_pad, span_pad, mpad, plan);
  return (int)cudaGetLastError();
}

const char* stft_fft_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
