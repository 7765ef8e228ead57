// Fused STFT: reflect-padded framing, Hann window and real DFT in one kernel,
// f32, for Hopper.
//
// Replaces stft_pallas / _kernel in
// speech_enhancement_by_s3prl_tpu/ops/pallas/stft_kernel.py (kernel B4).
//
// Computes, for each row of wav (N, time) and each frame f = 0 .. n_frames-1
// (n_frames = 1 + time / hop, torch.stft's center=True framing):
//   out[row, f, c] = sum_{k < n_fft} xpad[row, f * hop + k] * fwd[k, c]
// where xpad is wav reflect-padded by n_fft / 2 at both ends and fwd is the
// (n_fft, n_out) window-folded real-DFT matrix, n_out = 2 * n_freq packed
// [re | im]. f32 operands, f32 accumulation.
//
// What bounds it on this card: operations. A 10 s row is 2 * 1001 * 400 * 402
// = 0.32 GFLOP against 2.25 MB moved, so the f32 FMA rate is the limit, not the
// memory; one row alone is so little work that launch latency shows.
//
// Design: frames overlap (n_fft = 2.5 hops), so a block stages the
// (kTF - 1) * hop + n_fft contiguous samples its kTF frames cover in shared
// memory once, reflecting at the two edges by index: no padded copy of the
// waveform and no frame matrix ever exists in device memory. The matrix (643
// KB at 400 x 402) does not fit one SM's shared memory, so a block owns a
// tile of kTC columns and walks the n_fft rows in slabs of kKT through shared
// memory; the next slab's loads are issued into registers before the products
// of the current one, so their latency hides behind the FMAs. A warp owns kFR
// frames and its lanes 4 columns each: the frame samples are warp-wide
// broadcasts (16 bytes at a time where hop and n_fft are multiples of 4, so
// that shared-memory loads do not outnumber what the FMAs can absorb; one
// sample at a time otherwise: the geometry comes from a configuration's
// preprocessor section, which may name any, such as the 441-sample hop of
// 10 ms at 44.1 kHz), the matrix slab is read as one float4 a lane. kFR is 4 (32 frames a block) for
// small inputs, which need many blocks to fill the card, and 8 (64 frames)
// from four blocks a SM up, where reuse of the slab counts. n_out = 402 and
// n_frames are multiples of nothing convenient: every column and frame is
// guarded at the slab load and at the store.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 128;   // columns a block
constexpr int kKT = 16;    // matrix rows a slab
constexpr int kPer = kKT * kTC / kThreads;  // slab elements a thread loads: 8

template <int kFR>  // frames a warp
__global__ void __launch_bounds__(kThreads)
stft_fused_kernel(const float* __restrict__ wav, const float* __restrict__ fwd,
                  float* __restrict__ out, int time, int n_frames, int n_fft, int hop,
                  int n_out, int frame_tiles, int span_pad, int vec) {
  constexpr int kTF = kFR * kWarps;  // frames a block
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // the samples of this block's frames
  float* w_s = x_s + span_pad;                   // [kKT][kTC] slab of fwd

  const int row = blockIdx.x / frame_tiles;
  const int f0 = (blockIdx.x % frame_tiles) * kTF;
  const int c0 = blockIdx.y * kTC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  float wreg[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = tid + p * kThreads;
    const int k = idx / kTC, c = c0 + idx % kTC;
    wreg[p] = (k < n_fft && c < n_out) ? fwd[(size_t)k * n_out + c] : 0.0f;
  }

  const float* x = wav + (size_t)row * time;
  const int span = (kTF - 1) * hop + n_fft;
  const long first = (long)f0 * hop - n_fft / 2;  // index into wav of x_s[0]
  for (int q = tid; q < span; q += kThreads) {
    long j = first + q;
    if (j < 0) j = -j;                               // reflect at the start
    else if (j >= time) j = 2L * (time - 1) - j;     // and at the end
    // frames past n_frames (the ragged last tile) may reach further: zeros
    x_s[q] = (j >= 0 && j < time) ? x[j] : 0.0f;
  }

  float acc[kFR][4];
#pragma unroll
  for (int i = 0; i < kFR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  const float* a0 = x_s + warp * kFR * hop;

  for (int k0 = 0; k0 < n_fft; k0 += kKT) {
    __syncthreads();  // x_s is staged; the previous slab is no longer read
#pragma unroll
    for (int p = 0; p < kPer; ++p) w_s[tid + p * kThreads] = wreg[p];
    __syncthreads();
    if (k0 + kKT < n_fft) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int idx = tid + p * kThreads;
        const int k = k0 + kKT + idx / kTC, c = c0 + idx % kTC;
        wreg[p] = (k < n_fft && c < n_out) ? fwd[(size_t)k * n_out + c] : 0.0f;
      }
    }
    const int kmax = min(kKT, n_fft - k0);
    if (vec) {
      // hop and n_fft are multiples of 4: kmax is one too, and every group of
      // 4 samples of a frame is 16-byte aligned in x_s
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 4) {
        if (kk < kmax) {
          float4 w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[u] = *reinterpret_cast<const float4*>(w_s + (kk + u) * kTC + lane * 4);
#pragma unroll
          for (int i = 0; i < kFR; ++i) {
            const float4 a4 = *reinterpret_cast<const float4*>(a0 + i * hop + k0 + kk);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][0] = fmaf(a[u], w[u].x, acc[i][0]);
              acc[i][1] = fmaf(a[u], w[u].y, acc[i][1]);
              acc[i][2] = fmaf(a[u], w[u].z, acc[i][2]);
              acc[i][3] = fmaf(a[u], w[u].w, acc[i][3]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        if (kk < kmax) {
          const float4 w = *reinterpret_cast<const float4*>(w_s + kk * kTC + lane * 4);
#pragma unroll
          for (int i = 0; i < kFR; ++i) {
            const float a = a0[i * hop + k0 + kk];
            acc[i][0] = fmaf(a, w.x, acc[i][0]);
            acc[i][1] = fmaf(a, w.y, acc[i][1]);
            acc[i][2] = fmaf(a, w.z, acc[i][2]);
            acc[i][3] = fmaf(a, w.w, acc[i][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFR; ++i) {
    const int f = f0 + warp * kFR + i;
    if (f >= n_frames) continue;
    float* o = out + ((size_t)row * n_frames + f) * n_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + lane * 4 + j;
      if (c < n_out) o[c] = acc[i][j];
    }
  }
}

template <int kFR>
int launch(const float* wav, const float* fwd, float* out, int n_rows, int time, int n_fft,
           int hop, int n_out, int smem_optin, cudaStream_t stream) {
  constexpr int kTF = kFR * kWarps;
  const int n_frames = 1 + time / hop;
  const int frame_tiles = (n_frames + kTF - 1) / kTF;
  const int span_pad = (((kTF - 1) * hop + n_fft) + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)span_pad + kKT * kTC);
  if (smem > (size_t)smem_optin || (long)n_rows * frame_tiles > 2147483647L)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stft_fused_kernel<kFR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_rows * frame_tiles, (n_out + kTC - 1) / kTC);
  stft_fused_kernel<kFR><<<grid, kThreads, smem, stream>>>(
      wav, fwd, out, time, n_frames, n_fft, hop, n_out, frame_tiles, span_pad,
      hop % 4 == 0 && n_fft % 4 == 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B4. wav (n_rows, time), fwd (n_fft, n_out) and out (n_rows,
// 1 + time / hop, n_out) are contiguous f32 device pointers on `device`;
// time > n_fft / 2 (one reflection). Launches on `stream`, does not
// synchronise; returns the first non-zero CUDA status, 0 on success.
int stft_fused_f32(const void* wav, const void* fwd, void* out, int n_rows, int time,
                   int n_fft, int hop, int n_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || hop <= 0 || n_fft <= 0 || n_out <= 0 || time <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  int smem_optin = 0, sms = 0;
  if ((err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)))
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
    return (int)err;
  // 32 frames a block while that leaves at most four blocks a SM, else 64
  const long blocks32 =
      (long)n_rows * ((1 + time / hop + 31) / 32) * ((n_out + kTC - 1) / kTC);
  if (blocks32 <= 4L * sms)
    return launch<4>((const float*)wav, (const float*)fwd, (float*)out, n_rows, time, n_fft,
                     hop, n_out, smem_optin, (cudaStream_t)stream);
  return launch<8>((const float*)wav, (const float*)fwd, (float*)out, n_rows, time, n_fft,
                   hop, n_out, smem_optin, (cudaStream_t)stream);
}

const char* stft_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
