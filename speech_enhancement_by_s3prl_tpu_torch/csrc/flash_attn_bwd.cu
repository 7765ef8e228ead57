// Flash attention backward with the same in-kernel hash dropout (kernel B3
// bwd), f32, for Hopper.
//
// Replaces, in speech_enhancement_by_s3prl_tpu/ops/pallas/attention_kernel.py,
// _bwd_impl / _bwd_kernel (the pallas_call at :314): the gradient of every
// attention call of the Mockingjay joint finetune.
//
// With p = exp(s - lse) recomputed from q, k and the forward's lse, the keep
// bits recomputed from the same salt, do' = do / keep and Di = rowsum(do * out):
//   dv += (keep_bits ? p : 0)^T do'
//   dp  = keep_bits ? do' v^T : 0
//   ds  = p (dp - Di)
//   dq  = scale ds k,     dk += ds^T (scale q)
// as the JAX kernel computes them (:220-245; its keep * rowsum(do' * out) is
// rowsum(do * out)).
//
// What bounds it on this card: as in the forward, K, V and the (T, T)
// intermediates of a head do not fit one SM, and blocks cannot carry sums
// from one to the next as the TPU grid does. The JAX kernel sums dk and dv in
// VMEM scratch over its sequential query blocks; here that sum is a loop
// inside the block. Three launches, deterministic, without atomics:
//   1. flash_bwd_dot_kernel: Di (B, N, T) = rowsum(do * out), one warp a row;
//   2. flash_bwd_dkdv_kernel: one block per (64-key tile, head, batch) walks
//      every query tile and sums dk and dv for its keys in registers;
//   3. flash_bwd_dq_kernel: one block per (64-query tile, head, batch) walks
//      every key tile and sums dq for its queries in registers.
// Both tile kernels recompute p, the keep bits and dp, which costs two more
// 64 x 64 x D products a tile pair than one kernel with atomic dq would; the
// products are f32 FMAs on the CUDA cores, as in the forward.
//
// q, k and v share the batch stride sb and time stride st (unit stride in a
// row); out, do, dq, dk and dv are contiguous (B, T, N * D) f32; lse and Di
// are contiguous (B, N, T) f32; kbias is (B, T) f32.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                     float* __restrict__ di, int B, int T, int N, int D) {
  const int warps = kThreads / 32;
  const long long row = (long long)blockIdx.x * warps + threadIdx.x / 32;  // (b, t, n)
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * T * N) return;
  const float* a = dout + row * D;
  const float* o = out + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(a[d], o[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long n = row % N, bt = row / N, t = bt % T, b = bt / T;
    di[(b * N + n) * T + t] = acc;
  }
}

// Loads of a 64-row tile of an (B, T, .) operand at time rows t0 .. t0 + 63,
// rows >= T as zeros. Row-major into dst[64][ld] (times mul), or transposed
// into dst[D][ld].
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long st,
                                          int t0, int T, float mul) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    dst[r * ld + d] = t < T ? src[(long long)t * st + d] * mul : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_rows_t(float* dst, const float* src, long long st,
                                            int t0, int T) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    dst[d * kPad + r] = t < T ? src[(long long)t * st + d] : 0.f;
  }
}

// The shared work of both tile kernels for one (query tile q0, key tile k0)
// pair: s = q_s . kt_s and dp = do_s . vt_s for this thread's 4 x 4 entries
// (query rows ty + 16 i, keys tx + 16 j), then p, the keep bits and ds.
// pd (the dropped p) and ds are left in the caller's arrays.
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* q_s, const float* do_s,
                                          const float* kt_s, const float* vt_s,
                                          const float* kb_s, const float* lse_s,
                                          const float* di_s, int q0, int k0, int T,
                                          uint32_t bn, uint32_t s0, uint32_t s1,
                                          uint32_t thresh, int dropout, float pd[4][4],
                                          float ds[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = q_s[(ty + 16 * i) * (D + 1) + d];
      g[i] = do_s[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = kt_s[d * kPad + tx + 16 * j];
      vv[j] = vt_s[d * kPad + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const bool q_ok = q0 + row < T;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      // keys >= T have kb_s = -inf, so p = 0 there
      const float p = q_ok ? expf(s[i][j] + kb_s[col] - lse_s[row]) : 0.f;
      const bool kept = !dropout || keep_bit(bn, (uint32_t)(q0 + row), (uint32_t)(k0 + col),
                                             s0, s1, thresh);
      pd[i][j] = kept ? p : 0.f;
      ds[i][j] = p * ((kept ? dp[i][j] : 0.f) - di_s[row]);
    }
  }
}

// Per-row operands of a query tile: lse and Di (0 past T), into shared memory.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* di_s, const float* lse,
                                               const float* di, long long bn_row, int q0,
                                               int T) {
  if (threadIdx.x < kBQ) {
    const int t = q0 + threadIdx.x;
    lse_s[threadIdx.x] = t < T ? lse[bn_row + t] : 0.f;
    di_s[threadIdx.x] = t < T ? di[bn_row + t] : 0.f;
  }
}

__device__ __forceinline__ void load_key_bias(float* kb_s, const float* kbias, int b, int k0,
                                              int T) {
  if (threadIdx.x < kBK) {
    const int t = k0 + threadIdx.x;
    kb_s[threadIdx.x] = t < T ? kbias[(long long)b * T + t] : -INFINITY;
  }
}

// Dynamic shared memory of the dk/dv kernel, in floats:
//   kt_s, vt_s [D][kPad]        this block's keys and values, transposed
//   q_s, do_s  [kBQ][D + 1]     a query tile: scale q and do / keep
//   p_s, ds_s  [kBQ][kPad]      that tile's dropped p and ds
//   kb_s, lse_s, di_s [64]
template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * D * kPad + 2 * kBQ * (D + 1) + 2 * kBQ * kPad + 3 * 64;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ kbias,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dk,
                      float* __restrict__ dv, int T, int N, long long sb, long long st,
                      float scale, float inv_keep, uint32_t thresh, uint32_t s0, uint32_t s1,
                      int batch0, int dropout) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* kt_s = smem;
  float* vt_s = kt_s + D * kPad;
  float* q_s = vt_s + D * kPad;
  float* do_s = q_s + kBQ * (D + 1);
  float* p_s = do_s + kBQ * (D + 1);
  float* ds_s = p_s + kBQ * kPad;
  float* kb_s = ds_s + kBQ * kPad;
  float* lse_s = kb_s + 64;
  float* di_s = lse_s + 64;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK, n = blockIdx.y, b = blockIdx.z;
  const int H = N * D;
  const long long head = (long long)b * sb + (long long)n * D;
  const long long ohead = (long long)b * T * H + (long long)n * D;  // contiguous tensors
  const long long bn_row = ((long long)b * N + n) * T;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  load_rows_t<D>(kt_s, k + head, st, k0, T);
  load_rows_t<D>(vt_s, v + head, st, k0, T);
  load_key_bias(kb_s, kbias, b, k0, T);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kBQ) {
    __syncthreads();  // the last tile's readers are done
    load_rows<D>(q_s, D + 1, q + head, st, q0, T, scale);
    load_rows<D>(do_s, D + 1, dout + ohead, H, q0, T, inv_keep);
    load_row_stats(lse_s, di_s, lse, di, bn_row, q0, T);
    __syncthreads();

    float pd[4][4], ds[4][4];
    tile_p_ds<D>(q_s, do_s, kt_s, vt_s, kb_s, lse_s, di_s, q0, k0, T, bn, s0, s1, thresh,
                 dropout, pd, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty + 16 * i) * kPad + tx + 16 * j] = pd[i][j];
        ds_s[(ty + 16 * i) * kPad + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // this thread's keys are ty + 16 i, its columns tx + 16 c
#pragma unroll 8
    for (int qq = 0; qq < kBQ; ++qq) {
      float pk[4], dsk[4], g[DC], a[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = p_s[qq * kPad + ty + 16 * i];
        dsk[i] = ds_s[qq * kPad + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        g[c] = do_s[qq * (D + 1) + tx + 16 * c];
        a[c] = q_s[qq * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pk[i], g[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsk[i], a[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T) continue;
    const long long o = ohead + (long long)t * H;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[o + tx + 16 * c] = dk_acc[i][c];
      dv[o + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// Dynamic shared memory of the dq kernel, in floats:
//   q_s, do_s  [kBQ][D + 1]    this block's scale q and do / keep
//   kt_s, vt_s [D][kPad]       a key tile's keys and values, transposed
//   ds_s       [kBQ][kPad]     ds of that tile
//   kb_s, lse_s, di_s [64]
template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBQ * (D + 1) + 2 * D * kPad + kBQ * kPad + 3 * 64;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ kbias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int T, int N,
                    long long sb, long long st, float scale, float inv_keep, uint32_t thresh,
                    uint32_t s0, uint32_t s1, int batch0, int dropout) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBQ * (D + 1);
  float* kt_s = do_s + kBQ * (D + 1);
  float* vt_s = kt_s + D * kPad;
  float* ds_s = vt_s + D * kPad;
  float* kb_s = ds_s + kBQ * kPad;
  float* lse_s = kb_s + 64;
  float* di_s = lse_s + 64;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const int H = N * D;
  const long long head = (long long)b * sb + (long long)n * D;
  const long long ohead = (long long)b * T * H + (long long)n * D;
  const long long bn_row = ((long long)b * N + n) * T;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  load_rows<D>(q_s, D + 1, q + head, st, q0, T, scale);
  load_rows<D>(do_s, D + 1, dout + ohead, H, q0, T, inv_keep);
  load_row_stats(lse_s, di_s, lse, di, bn_row, q0, T);

  float dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done (and the query tile is stored)
    load_rows_t<D>(kt_s, k + head, st, k0, T);
    load_rows_t<D>(vt_s, v + head, st, k0, T);
    load_key_bias(kb_s, kbias, b, k0, T);
    __syncthreads();

    float pd[4][4], ds[4][4];
    tile_p_ds<D>(q_s, do_s, kt_s, vt_s, kb_s, lse_s, di_s, q0, k0, T, bn, s0, s1, thresh,
                 dropout, pd, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds_s[(ty + 16 * i) * kPad + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // this thread's queries are ty + 16 i, its columns tx + 16 c; k[key][c]
    // is kt_s[c][key]
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float dsq[4], kc[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsq[i] = ds_s[(ty + 16 * i) * kPad + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kc[c] = kt_s[(tx + 16 * c) * kPad + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq_acc[i][c] = fmaf(dsq[i], kc[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    const long long o = ohead + (long long)t * H;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[o + tx + 16 * c] = dq_acc[i][c] * scale;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* kbias,
           const float* out, const float* dout, const float* lse, float* di, float* dq,
           float* dk, float* dv, int B, int T, int N, long long sb, long long st, float scale,
           float inv_keep, uint32_t thresh, uint32_t s0, uint32_t s1, int batch0, int dropout,
           cudaStream_t stream) {
  cudaError_t err;
  const long long rows = (long long)B * T * N;
  const int warps = kThreads / 32;
  flash_bwd_dot_kernel<<<(unsigned)((rows + warps - 1) / warps), kThreads, 0, stream>>>(
      dout, out, di, B, T, N, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_kv = sizeof(float) * dkdv_smem_floats<D>();
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_kv)) != cudaSuccess)
    return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem_kv, stream>>>(
      q, k, v, kbias, dout, lse, di, dk, dv, T, N, sb, st, scale, inv_keep, thresh, s0, s1,
      batch0, dropout);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * dq_smem_floats<D>();
  if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_q)) != cudaSuccess)
    return (int)err;
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem_q, stream>>>(
      q, k, v, kbias, dout, lse, di, dq, T, N, sb, st, scale, inv_keep, thresh, s0, s1,
      batch0, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B3 bwd: three launches on `stream` of `device`; returns the first
// launch error (0 on success); does not synchronise. di is (B, N, T) f32
// scratch the caller allocates. D, thresh and dropout as for
// flash_attn_fwd_f32; inv_keep = 1 / (1 - rate).
int flash_attn_bwd_f32(const void* q, const void* k, const void* v, const void* kbias,
                       const void* out, const void* dout, const void* lse, void* di, void* dq,
                       void* dk, void* dv, int B, int T, int N, int D, long long sb,
                       long long st, float scale, float inv_keep, unsigned thresh,
                       unsigned s0, unsigned s1, int batch0, int dropout, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(c(q), c(k), c(v), c(kbias), c(out), c(dout), c(lse), m(di), m(dq),
                        m(dk), m(dv), B, T, N, sb, st, scale, inv_keep, thresh, s0, s1,
                        batch0, dropout, s);
    case 64:
      return launch<64>(c(q), c(k), c(v), c(kbias), c(out), c(dout), c(lse), m(di), m(dq),
                        m(dk), m(dv), B, T, N, sb, st, scale, inv_keep, thresh, s0, s1,
                        batch0, dropout, s);
    case 128:
      return launch<128>(c(q), c(k), c(v), c(kbias), c(out), c(dout), c(lse), m(di), m(dq),
                         m(dk), m(dv), B, T, N, sb, st, scale, inv_keep, thresh, s0, s1,
                         batch0, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
