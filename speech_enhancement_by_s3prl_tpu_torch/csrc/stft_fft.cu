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
// serves every geometry a configuration may name. The transform is a
// Stockham autosort FFT, one pass per radix, ping-ponging between two
// buffers in shared memory: butterfly b = p * s + q reads b + k * M / r
// (unit stride across lanes) and writes q + s * (r * p + j), so the result
// is in natural order with no digit reversal, and apart from the first pass
// (stride r: the plan puts an odd radix there when it has one) stores are
// unit-stride too. Real and imaginary parts live in separate arrays whose
// offset is 16 (mod 32) floats, so that de-interleaving a frame's samples
// into them is conflict-free.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || hop <= 0 || n_fft < 4 || n_fft % 2 || time <= n_fft / 2 ||
      n_passes <= 0 || n_passes > kMaxPasses)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.n = n_passes;
  int product = 1;
  for (int i = 0; i < n_passes; ++i) {
    if (radices[i] < 2 || radices[i] > 5) return (int)cudaErrorInvalidValue;
    plan.r[i] = radices[i];
    product *= radices[i];
    if (product > n_fft / 2) return (int)cudaErrorInvalidValue;
  }
  if (product != n_fft / 2) return (int)cudaErrorInvalidValue;
  int smem_optin = 0, sms = 0;
  if ((err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)))
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
    return (int)err;

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
  if ((err = cudaFuncSetAttribute(stft_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)))
    return (int)err;
  stft_fft_kernel<<<n_rows * frame_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)tables, (float*)out, time, n_frames, n_fft, hop,
      frame_tiles, fpw, tab_pad, span_pad, mpad, plan);
  return (int)cudaGetLastError();
}

const char* stft_fft_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
