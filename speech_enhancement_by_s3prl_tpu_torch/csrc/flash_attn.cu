// Flash attention forward with in-kernel hash dropout (kernel B3 fwd), f32,
// for Hopper.
//
// Replaces, in speech_enhancement_by_s3prl_tpu/ops/pallas/attention_kernel.py,
// _fwd_impl / _fwd_kernel (the pallas_call at :277): the attention of every
// transformer layer of the Mockingjay joint finetune while attention dropout
// is live.
//
// Computes, for batch b, head n and query t, with q, k, v of shape
// (B, T, N * D), head n in columns n * D .. n * D + D - 1:
//   s_k  = (scale * q_t) . k_k + kbias[b, k]        (keys k < T)
//   m = max_k s_k, l = sum_k exp(s_k - m)            (the undropped sum)
//   out_t = sum_k keep(bn, t, k) exp(s_k - m) v_k / (l * (1 - rate))
//   lse[b, n, t] = m + log l
// where keep() is the salted hash of flash_attn_common.cuh and bn the
// absolute head index (batch0 + b) * N + n, so the mask is the JAX kernel's
// bit for bit whatever the tiling.
//
// What bounds it on this card: the TPU kernel keeps whole K and V rows of a
// head group in VMEM; at T = 1001 one head's K and V are 512 KB in f32, more
// than one SM's shared memory. So this is the usual online softmax over key
// tiles: one block per (64-query tile, head, batch), 1152 blocks at B = 6,
// N = 12, T = 1001. Per key tile the block stages K (transposed) and V (16 KB
// each) in shared memory, computes its 64 x 64 logits with f32 FMAs (4 x 4 a
// thread), folds them into the running max m and sum l, draws the keep bits
// in registers, and adds the dropped probabilities times V into its (64, D)
// accumulator. Nothing of size T x T ever reaches device memory. The products
// are f32 FMAs on the CUDA cores (about 2 FMAs per shared-memory load): the
// port computes in f32 without TF32, and tensor cores (wgmma on bf16 copies)
// are later work.
//
// q, k and v may be strided views (the three thirds of the fused QKV
// projection): they share the batch stride sb and the time stride st, with
// unit stride inside a row. kbias is (B, T) f32; out is a contiguous
// (B, T, N * D) f32 tensor and lse a contiguous (B, N, T) f32 tensor.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

// Dynamic shared memory, in floats:
//   q_s  [kBQ][D + 1]   this block's queries, times scale
//   kt_s [D][kPad]      the key tile, transposed
//   v_s  [kBK][D]       the value tile
//   p_s  [kBQ][kPad]    the tile's dropped probabilities
//   kb_s [kBK]          the tile's key bias, -inf for keys >= T
template <int D>
constexpr int fwd_smem_floats() {
  return kBQ * (D + 1) + D * kPad + kBK * D + kBQ * kPad + kBK;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kbias,
                 float* __restrict__ out, float* __restrict__ lse, int T, int N,
                 long long sb, long long st, float scale, float keep, uint32_t thresh,
                 uint32_t s0, uint32_t s1, int batch0, int dropout) {
  constexpr int DC = D / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* kt_s = q_s + kBQ * (D + 1);
  float* v_s = kt_s + D * kPad;
  float* p_s = v_s + kBK * D;
  float* kb_s = p_s + kBQ * kPad;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const long long head = (long long)b * sb + (long long)n * D;
  const float* qb = q + head;
  const float* kb = k + head;
  const float* vb = v + head;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    q_s[r * (D + 1) + d] = t < T ? qb[(long long)t * st + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done (and q_s is stored)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, t = k0 + r;
      const bool ok = t < T;
      kt_s[d * kPad + r] = ok ? kb[(long long)t * st + d] : 0.f;
      v_s[r * D + d] = ok ? vb[(long long)t * st + d] : 0.f;
    }
    if (tid < kBK) {
      const int t = k0 + tid;
      kb_s[tid] = t < T ? kbias[(long long)b * T + t] : -INFINITY;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kt_s[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += kb_s[tx + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      // all keys so far at -inf (a -inf key bias): keep exp() finite
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - shift);
        rs += p;
        if (dropout && !keep_bit(bn, (uint32_t)(q0 + row), (uint32_t)(k0 + tx + 16 * j),
                                 s0, s1, thresh))
          p = 0.f;
        p_s[row * kPad + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * kPad + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  const int H = N * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    const float r = 1.f / (l[i] * keep);
    float* o = out + ((long long)b * T + t) * H + (long long)n * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[i][c] * r;
    if (tx == 0) lse[((long long)b * N + n) * T + t] = m[i] + logf(l[i]);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* kbias, float* out,
           float* lse, int B, int T, int N, long long sb, long long st, float scale,
           float keep, uint32_t thresh, uint32_t s0, uint32_t s1, int batch0, int dropout,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, kbias, out, lse, T, N, sb, st, scale, keep, thresh, s0, s1, batch0, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B3 fwd. Launches on `stream` of `device` and returns
// cudaGetLastError() (0 on success); does not synchronise. D is 32, 64 or
// 128; thresh is min(int((1 - rate) * 2^32), 2^32 - 1) and keep = 1 - rate,
// both computed by the caller; dropout = 0 skips the hash (rate 0).
int flash_attn_fwd_f32(const void* q, const void* k, const void* v, const void* kbias,
                       void* out, void* lse, int B, int T, int N, int D, long long sb,
                       long long st, float scale, float keep, unsigned thresh, unsigned s0,
                       unsigned s1, int batch0, int dropout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* bf = static_cast<const float*>(kbias);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(qf, kf, vf, bf, of, lf, B, T, N, sb, st, scale, keep, thresh, s0, s1,
                        batch0, dropout, s);
    case 64:
      return launch<64>(qf, kf, vf, bf, of, lf, B, T, N, sb, st, scale, keep, thresh, s0, s1,
                        batch0, dropout, s);
    case 128:
      return launch<128>(qf, kf, vf, bf, of, lf, B, T, N, sb, st, scale, keep, thresh, s0,
                         s1, batch0, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
