// Flash attention forward with in-kernel hash dropout (kernel B3 fwd), f32 in
// and out, on Hopper's tensor cores; and its bf16 form (B3 fwd bf16, below,
// for compute_dtype bf16).
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
// What bounds it on this card: operations. The two T x T x D products of a
// head are 18.5 GFLOP at B=6, T=1001, 12 x 64 against 0.07 GB moved. As f32
// FMAs on the CUDA cores (this kernel's first design, 21 TFLOP/s reached of
// 67, about 2 FMAs a shared-memory load) that is the whole time; the tensor
// cores do the same products to f32 accuracy in three TF32 passes
// (mma_tf32x3.cuh) at a third of 495 TFLOP/s. Single-pass TF32 (~1e-3) would
// fail the kernel's 1e-4 limit.
//
// Design. The TPU kernel keeps whole K and V rows of a head group in VMEM; at
// T = 1001 one head's K and V are 512 KB in f32, more than one SM's shared
// memory, so this is the usual online softmax over key tiles. One block of 4
// warps per (64-query tile, head, batch); a warp owns 16 query rows. The
// block's queries, times scale, stay in shared memory; K and V are walked 32
// keys at a time through two stages of shared memory: cp.async copies tile
// i + 1 while tile i is worked on, one barrier a tile. Per key tile a warp
//   - computes s = (scale q) k^T into accumulator fragments (k read as the
//     [n][k] operand by ldmatrix);
//   - adds the key bias, folds the tile into the running row max m and row
//     sum l (max and sum across the four lanes that hold a row, by shuffles;
//     l is kept as each lane's share and summed once at the end), rescales
//     its (16, D) output accumulator, and draws each element's keep bit in
//     registers from its absolute (head, query, key);
//   - multiplies the dropped probabilities by V: the s accumulator tile is
//     the A fragment of that product as it stands (frag_a_from_acc, with V
//     read as the [k][n] operand in the matching contraction order), so the
//     probabilities never pass through shared memory. The tile's p v goes
//     through a fresh accumulator (12 chained passes on the tensor core) and
//     one f32 addition into the output accumulator, because the tensor
//     core's accumulator truncates where f32 addition rounds.
// The online softmax, the hash and the rescaling stay f32 on the CUDA cores.
// Nothing of size T x T ever reaches device memory.
//
// q, k and v may be strided views (the three thirds of the fused QKV
// projection): they share the batch stride sb and the time stride st, with
// unit stride inside a row; tiles are copied 16 bytes at a time where every
// row start is 16-byte aligned, with scalar loads otherwise. kbias is (B, T)
// f32; out is a contiguous (B, T, N * D) f32 tensor and lse a contiguous
// (B, N, T) f32 tensor.

#include <math.h>

#include "flash_attn_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using namespace flash;
using namespace tf32x3;

// Dynamic shared memory, in floats: the resident [64][D + 4] query tile, two
// stages of the walked [32][D + 4] key and value tiles, and two stages of the
// 32-entry key bias.
template <int D>
constexpr int fwd_smem_floats() {
  return 64 * (D + 4) + 2 * (2 * kWalk * (D + 4) + kWalk);
}

// Max or sum over the four lanes (lane % 4 = 0 .. 3) that hold one row of an
// accumulator tile.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 3 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kbias,
                 float* __restrict__ out, float* __restrict__ lse, int T, int N,
                 long long sb, long long st, float scale, float keep, uint32_t thresh,
                 uint32_t s0, uint32_t s1, int batch0, int dropout, int vec) {
  constexpr int LD = D + 4;
  constexpr int DN = D / 8;      // 8-column tiles of out
  constexpr int CN = kWalk / 8;  // 8-key tiles of s
  constexpr int kStage = 2 * kWalk * LD + kWalk;  // floats of one walked stage
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // scale q
  float* walk_s = q_s + 64 * LD;                 // per stage: k, v, key bias

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const long long head = (long long)b * sb + (long long)n * D;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  auto start = [&](int i) {
    float* w = walk_s + (i & 1) * kStage;
    start_walk_tile<D>(w, k + head, st, w + kWalk * LD, v + head, st, w + 2 * kWalk * LD,
                       kbias + (long long)b * T, nullptr, nullptr, i * kWalk, T, vec);
  };
  start(0);
  load_tile<D>(q_s, q + head, st, q0, T, scale, vec);
  // this thread's accumulator rows: queries q_a and q_a + 8 (entries e < 2
  // and e >= 2 of a fragment); its columns of tile j: 8 j + 2 t4 and the next
  const int q_a = q0 + warp * 16 + g;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[DN][4];
#pragma unroll
  for (int c = 0; c < DN; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  const float* qa_s = q_s + warp * 16 * LD;
  const int n_walk = (T + kWalk - 1) / kWalk;

  for (int i = 0; i < n_walk; ++i) {
    // tile i has landed; every warp is done with tile i - 1, whose stage the
    // copy of tile i + 1 may now overwrite while tile i is worked on
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const float* k_s = walk_s + (i & 1) * kStage;
    const float* v_s = k_s + kWalk * LD;
    const float* kb_s = v_s + kWalk * LD;
    const int k0 = i * kWalk;

    // s = (scale q) k^T: 16 queries x 32 keys
    float s_acc[CN][4];
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 8) {
      FragA qa;
      FragB kf[CN];
      load_a(qa, qa_s + d0, LD, lane);
#pragma unroll
      for (int j = 0; j < CN; j += 2)
        load_b_nk_x2(kf[j], kf[j + 1], k_s + 8 * j * LD + d0, LD, lane);
      mma3<CN>(s_acc, qa, kf);
    }

    // the key bias (-inf for keys >= T) and the tile's row maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(kb_s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_acc[j][e] += (e & 1) ? kb.y : kb.x;
        mx[e >> 1] = fmaxf(mx[e >> 1], s_acc[j][e]);
      }
    }
    float shift[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      // all keys so far at -inf (a -inf key bias): keep exp() finite
      shift[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = expf(m[h] - shift[h]);
      m[h] = m_new;
    }
    // p replaces s; l sums the undropped p, the product takes the dropped
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s_acc[j][e] - shift[e >> 1]);
        rs[e >> 1] += p;
        const bool kept =
            !dropout || keep_bit(bn, (uint32_t)(q_a + 8 * (e >> 1)),
                                 (uint32_t)(k0 + 8 * j + 2 * t4 + (e & 1)), s0, s1, thresh);
        s_acc[j][e] = kept ? p : 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int c = 0; c < DN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e >> 1];

    // out += p v: contraction over the tile's keys, 8 at a time, the s tiles
    // as the A operands; per group of 4 column tiles the tile's sum in fresh
    // accumulators on the tensor core, then one f32 addition
#pragma unroll
    for (int c = 0; c < DN; c += 4) {
      float pv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[u][e] = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        FragA pa;
        frag_a_from_acc(pa, s_acc[j]);
        FragB vf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load_b_kn(vf[u], v_s + 8 * j * LD + 8 * (c + u), LD, lane);
        mma3<4>(pv, pa, vf);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c + u][e] += pv[u][e];
    }
  }

  const int H = N * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q_a + 8 * h;
    const float sum = quad_sum(l[h]);  // every lane of the warp shuffles
    if (t >= T) continue;
    const float r = 1.f / (sum * keep);
    float* o = out + ((long long)b * T + t) * H + (long long)n * D + 2 * t4;
#pragma unroll
    for (int c = 0; c < DN; ++c)
      *reinterpret_cast<float2*>(o + 8 * c) =
          make_float2(acc[c][2 * h] * r, acc[c][2 * h + 1] * r);
    if (t4 == 0) lse[((long long)b * N + n) * T + t] = m[h] + logf(sum);
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
  // 16-byte tile loads where every row start is 16-byte aligned
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && sb % 4 == 0 && st % 4 == 0;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  flash_fwd_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      q, k, v, kbias, out, lse, T, N, sb, st, scale, keep, thresh, s0, s1, batch0, dropout,
      vec);
  return (int)cudaGetLastError();
}

// ---- B3 fwd in bf16 (compute_dtype bf16) ----------------------------------
//
// The same function at the JAX kernel's bf16 roundings (attention_kernel.py
// :116-164 with bf16 q, k, v): q times the scale rounded to bf16 (the caller
// rounds the scale itself to bf16, as jnp.asarray(scale, dt) does), logits as
// f32 sums of exact bf16 products, the key bias, softmax and hash in f32, the
// dropped probabilities rounded to bf16 into the P V product, out rounded to
// bf16 from its f32 accumulator, lse f32. One difference stays: the online
// softmax rounds p = exp(s - m) against the running row maximum of the keys
// walked so far, the JAX kernel against the row's final one, so the bf16
// roundings of p (and through them out) differ by an ulp here and there.
//
// Bound on this card: operations, at one bf16 tensor-core pass a product
// (18.5 GFLOP at B=6, T=1001, 12 x 64 over 989 TFLOP/s) against 0.04 GB moved.
// The design is the f32 kernel's (a block of 4 warps per 64 queries, head and
// batch; K and V walked 32 keys at a time through a cp.async double buffer,
// which carries half the f32 kernel's bytes; the probabilities go from the
// accumulators straight into the P V product as A fragments), with each
// product one mma.m16n8k16 pass (mma_bf16.cuh) in place of three TF32 ones.

namespace bm = bf16mma;
using bm::bf16;

// Dynamic shared memory, in bytes: the resident [64][D + 8] bf16 query tile
// (scale q), and two stages of the walked [32][D + 8] bf16 key and value
// tiles and the 32-entry f32 key bias.
template <int D>
__host__ __device__ constexpr int fwd_bf16_stage_bytes() {
  return 2 * 2 * kWalk * (D + 8) + 4 * kWalk;
}

template <int D>
__host__ __device__ constexpr int fwd_bf16_smem_bytes() {
  return 2 * 64 * (D + 8) + 2 * fwd_bf16_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 3 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ kbias,
                      bf16* __restrict__ out, float* __restrict__ lse, int T, int N,
                      long long sb, long long st, float scale, float keep, uint32_t thresh,
                      uint32_t s0, uint32_t s1, int batch0, int dropout, int vec) {
  constexpr int LD = D + 8;
  constexpr int DN = D / 8;      // 8-column tiles of out
  constexpr int CN = kWalk / 8;  // 8-key tiles of s
  constexpr int kStage = fwd_bf16_stage_bytes<D>();
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);                  // bf16(scale q)
  char* walk_s = reinterpret_cast<char*>(q_s + 64 * LD);       // per stage: k, v, bias

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const long long head = (long long)b * sb + (long long)n * D;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  auto start = [&](int i) {
    char* w = walk_s + (i & 1) * kStage;
    bf16* const dst[2] = {reinterpret_cast<bf16*>(w), reinterpret_cast<bf16*>(w) + kWalk * LD};
    const bf16* const src[2] = {k + head, v + head};
    const long long stride[2] = {st, st};
    bm::start_walk<D, 2>(dst, src, stride, i * kWalk, T, kWalk, vec, kTileThreads);
    if (threadIdx.x < kWalk) {
      const int t = i * kWalk + threadIdx.x;
      reinterpret_cast<float*>(w + 4 * kWalk * LD)[threadIdx.x] =
          t < T ? kbias[(long long)b * T + t] : -INFINITY;  // keys >= T: bias -inf
    }
    cp_async_commit();
  };
  start(0);
  bm::load_tile<D>(q_s, q + head, st, q0, T, 64, scale, vec, kTileThreads);
  // this thread's accumulator rows: queries q_a and q_a + 8
  const int q_a = q0 + warp * 16 + g;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[DN][4];
#pragma unroll
  for (int c = 0; c < DN; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  const bf16* qa_s = q_s + warp * 16 * LD;
  const int n_walk = (T + kWalk - 1) / kWalk;

  for (int i = 0; i < n_walk; ++i) {
    cp_async_wait_all();  // as in the f32 kernel
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const char* w = walk_s + (i & 1) * kStage;
    const bf16* k_s = reinterpret_cast<const bf16*>(w);
    const bf16* v_s = k_s + kWalk * LD;
    const float* kb_s = reinterpret_cast<const float*>(w + 4 * kWalk * LD);
    const int k0 = i * kWalk;

    // s = bf16(scale q) k^T: 16 queries x 32 keys, one pass a 16-deep slice
    float s_acc[CN][4];
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t qa[4];
      bm::load_a(qa, qa_s + d0, LD, lane);
#pragma unroll
      for (int j = 0; j < CN; j += 2) {
        uint32_t b0[2], b1[2];
        bm::load_b_nk_x2(b0, b1, k_s + 8 * j * LD + d0, LD, lane);
        bm::mma(s_acc[j], qa, b0);
        bm::mma(s_acc[j + 1], qa, b1);
      }
    }

    // the key bias and the online softmax, in f32 as in the f32 kernel
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const float2 kb = *reinterpret_cast<const float2*>(kb_s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_acc[j][e] += (e & 1) ? kb.y : kb.x;
        mx[e >> 1] = fmaxf(mx[e >> 1], s_acc[j][e]);
      }
    }
    float shift[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      shift[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = expf(m[h] - shift[h]);
      m[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s_acc[j][e] - shift[e >> 1]);
        rs[e >> 1] += p;
        const bool kept =
            !dropout || keep_bit(bn, (uint32_t)(q_a + 8 * (e >> 1)),
                                 (uint32_t)(k0 + 8 * j + 2 * t4 + (e & 1)), s0, s1, thresh);
        s_acc[j][e] = kept ? p : 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int c = 0; c < DN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha[e >> 1];

    // out += bf16(p) v: contraction over the tile's keys, 16 at a time, two s
    // tiles rounded to bf16 as the A operand
#pragma unroll
    for (int j = 0; j < CN; j += 2) {
      uint32_t pa[4];
      bm::frag_a_from_acc(pa, s_acc[j], s_acc[j + 1]);
#pragma unroll
      for (int c = 0; c < DN; c += 2) {
        uint32_t b0[2], b1[2];
        bm::load_b_kn_x2(b0, b1, v_s + 8 * j * LD + 8 * c, LD, lane);
        bm::mma(acc[c], pa, b0);
        bm::mma(acc[c + 1], pa, b1);
      }
    }
  }

  const int H = N * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = q_a + 8 * h;
    const float sum = quad_sum(l[h]);  // every lane of the warp shuffles
    if (t >= T) continue;
    const float r = 1.f / (sum * keep);
    bf16* o = out + ((long long)b * T + t) * H + (long long)n * D + 2 * t4;
#pragma unroll
    for (int c = 0; c < DN; ++c)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * c) =
          __floats2bfloat162_rn(acc[c][2 * h] * r, acc[c][2 * h + 1] * r);
    if (t4 == 0) lse[((long long)b * N + n) * T + t] = m[h] + logf(sum);
  }
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* kbias, bf16* out,
                float* lse, int B, int T, int N, long long sb, long long st, float scale,
                float keep, uint32_t thresh, uint32_t s0, uint32_t s1, int batch0,
                int dropout, cudaStream_t stream) {
  const size_t smem = fwd_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte tile copies (8 bf16) where every row start is 16-byte aligned
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && sb % 8 == 0 && st % 8 == 0;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  flash_fwd_bf16_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      q, k, v, kbias, out, lse, T, N, sb, st, scale, keep, thresh, s0, s1, batch0, dropout,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B3 fwd. Launches on `stream` of `device` and returns
// cudaGetLastError() (0 on success); does not synchronise. D is 32, 64 or
// 128; thresh is min(int((1 - rate) * 2^32), 2^32 - 1) and keep = 1 - rate,
// both computed by the caller; dropout = 0 skips the hash (rate 0). out must
// be 8-byte aligned (it is a whole allocation).
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

// Kernel B3 fwd in bf16: q, k, v and out bf16, kbias and lse f32, the
// arguments otherwise as for flash_attn_fwd_f32; `scale` is the softmax scale
// already rounded to bf16. out must be 4-byte aligned (a whole allocation).
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* kbias,
                        void* out, void* lse, int B, int T, int N, int D, long long sb,
                        long long st, float scale, float keep, unsigned thresh, unsigned s0,
                        unsigned s1, int batch0, int dropout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto* qb = static_cast<const bf16*>(q);
  auto* kb = static_cast<const bf16*>(k);
  auto* vb = static_cast<const bf16*>(v);
  auto* bf = static_cast<const float*>(kbias);
  auto* ob = static_cast<bf16*>(out);
  auto* lf = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_bf16<32>(qb, kb, vb, bf, ob, lf, B, T, N, sb, st, scale, keep, thresh, s0,
                             s1, batch0, dropout, s);
    case 64:
      return launch_bf16<64>(qb, kb, vb, bf, ob, lf, B, T, N, sb, st, scale, keep, thresh, s0,
                             s1, batch0, dropout, s);
    case 128:
      return launch_bf16<128>(qb, kb, vb, bf, ob, lf, B, T, N, sb, st, scale, keep, thresh,
                              s0, s1, batch0, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
