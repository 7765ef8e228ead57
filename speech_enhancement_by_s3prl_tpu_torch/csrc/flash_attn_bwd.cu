// Flash attention backward with the same in-kernel hash dropout (kernel B3
// bwd), f32 in and out, on Hopper's tensor cores; and its bf16 form (B3 bwd
// bf16, below, for compute_dtype bf16).
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
// What bounds it on this card: operations. The five 64 x 64 x D tile products
// a tile pair needs are 46 GFLOP at B=6, T=1001, 12 x 64 against 0.2 GB
// moved. As f32 FMAs on the CUDA cores (this kernel's first design, ~20
// TFLOP/s reached of 67) that is the whole time; the tensor cores do the same
// products to f32 accuracy in three TF32 passes (mma_tf32x3.cuh) at a third
// of 495 TFLOP/s. Single-pass TF32 (~1e-3) would fail the kernel's 1e-4
// limit and the train step's gradient check, so it is not used.
//
// Design. K, V and the (T, T) intermediates of a head do not fit one SM, and
// blocks cannot carry sums from one to the next as the TPU grid does: the sum
// over tiles is a loop inside the block. Three launches, deterministic,
// without atomics:
//   1. flash_bwd_dot_kernel: Di (B, N, T) = rowsum(do * out), one warp a row;
//   2. flash_bwd_dkdv_kernel: one block per (64-key tile, head, batch) walks
//      the queries and sums dk and dv for its keys in registers;
//   3. flash_bwd_dq_kernel: one block per (64-query tile, head, batch) walks
//      the keys and sums dq for its queries in registers.
// Both tile kernels recompute s, dp, p and the keep bits: 7 tile products a
// tile pair where 5 define the backward. Dropping the two would need either
// float atomics on dq (not repeatable) or per-key-tile dq partials in device
// memory (B * N * T * T / 64 * D floats: 0.3 GB at B=6, 3 GB at B=64).
//
// A block is 4 warps; a warp owns 16 rows of the block's resident 64-row tile
// (keys in the dk/dv kernel, queries in the dq kernel). The other operand is
// walked 32 rows at a time through two stages of shared memory: cp.async
// copies tile i + 1 while tile i is worked on, one barrier a tile. The dk/dv
// kernel computes the *transposed* tiles s^T = k q^T and dp^T = v do^T, so
// that its keys are the accumulator rows: the dropped p^T and ds^T are then
// the A operands of dv += p^T do and dk += ds^T q as they sit in registers
// (frag_a_from_acc), with no trip through shared memory; the dq kernel does
// the same with ds for dq += ds k. Since cp.async copies the walked q and do
// as they are, the softmax scale and 1 / keep ride on the dk/dv kernel's
// resident k and v and on its p and ds. Tiles are row-major with a pad of 4
// floats a row, which makes every fragment load conflict-free ([n][k]
// operands by ldmatrix, [k][n] operands by scalar loads); each walked tile is
// read both ways. The softmax recompute, the hash (absolute head, query and
// key indices) and ds stay f32 on the CUDA cores, on the accumulator
// fragments. Sums over the walk (dk, dv, dq) go through a fresh accumulator a
// tile (12 chained passes on the tensor core) and one f32 addition, because
// the tensor core's accumulator truncates: chained through all 32 tiles the
// result was 1.3e-5 of its largest value off at T=1001 (on an H100) and
// growing with T, this way ~4e-6 at any T.
//
// q, k and v share the batch stride sb and time stride st (unit stride in a
// row); out, do, dq, dk and dv are contiguous (B, T, N * D) f32; lse and Di
// are contiguous (B, N, T) f32; kbias is (B, T) f32.

#include <math.h>

#include "flash_attn_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using namespace flash;
using namespace tf32x3;

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

// p and ds of one accumulator entry, from s and dp: query qi, key ki. Keys
// >= T come with kb = -inf and queries >= T with lse = +inf, so p = 0 there
// without a branch.
__device__ __forceinline__ void p_and_ds(float s, float dp, float kb, float lse, float di,
                                         uint32_t bn, int qi, int ki, uint32_t s0,
                                         uint32_t s1, uint32_t thresh, int dropout, float& pd,
                                         float& ds) {
  const float p = expf(s + kb - lse);
  const bool kept = !dropout || keep_bit(bn, (uint32_t)qi, (uint32_t)ki, s0, s1, thresh);
  pd = kept ? p : 0.f;
  ds = p * ((kept ? dp : 0.f) - di);
}

// Dynamic shared memory of both tile kernels, in floats: the two resident
// [64][D + 4] tiles, two stages of two walked [32][D + 4] tiles, and two
// stages of two 32-entry rows (lse and Di, or the key bias).
template <int D>
constexpr int tile_smem_floats() {
  return 2 * 64 * (D + 4) + 2 * 2 * kWalk * (D + 4) + 2 * 2 * kWalk;
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 2 : 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ kbias,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dk,
                      float* __restrict__ dv, int T, int N, long long sb, long long st,
                      float scale, float inv_keep, uint32_t thresh, uint32_t s0, uint32_t s1,
                      int batch0, int dropout, int vec) {
  constexpr int LD = D + 4;
  constexpr int DN = D / 8;      // 8-column tiles of dk / dv
  constexpr int CN = kWalk / 8;  // 8-query tiles of s^T / dp^T
  constexpr int kStage = 2 * kWalk * LD + 2 * kWalk;  // floats of one walked stage
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // scale k
  float* v_s = k_s + 64 * LD;                    // v / keep
  float* walk_s = v_s + 64 * LD;                 // per stage: q, do, lse, Di

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBK, n = blockIdx.y, b = blockIdx.z;
  const int H = N * D;
  const long long head = (long long)b * sb + (long long)n * D;
  const long long ohead = (long long)b * T * H + (long long)n * D;  // contiguous tensors
  const long long bn_row = ((long long)b * N + n) * T;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  auto start = [&](int i) {
    float* w = walk_s + (i & 1) * kStage;
    start_walk_tile<D>(w, q + head, st, w + kWalk * LD, dout + ohead, H, w + 2 * kWalk * LD,
                       lse + bn_row, w + 2 * kWalk * LD + kWalk, di + bn_row, i * kWalk, T,
                       vec);
  };
  start(0);
  // the scale and 1 / keep ride on the resident tiles: s^T = (scale k) q^T and
  // dp^T = (v / keep) do^T; the walked q and do are copied as they are
  load_tile<D>(k_s, k + head, st, k0, T, scale, vec);
  load_tile<D>(v_s, v + head, st, k0, T, inv_keep, vec);
  // this thread's accumulator rows: keys key_a and key_a + 8
  const int key_a = k0 + warp * 16 + g;
  const float kb_a = key_a < T ? kbias[(long long)b * T + key_a] : -INFINITY;
  const float kb_b = key_a + 8 < T ? kbias[(long long)b * T + key_a + 8] : -INFINITY;

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int c = 0; c < DN; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  const float* ka_s = k_s + warp * 16 * LD;
  const float* va_s = v_s + warp * 16 * LD;
  const int n_walk = (T + kWalk - 1) / kWalk;

  for (int i = 0; i < n_walk; ++i) {
    // tile i has landed; every warp is done with tile i - 1, whose stage the
    // copy of tile i + 1 may now overwrite while tile i is worked on
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const float* q_s = walk_s + (i & 1) * kStage;
    const float* do_s = q_s + kWalk * LD;
    const float* lse_s = do_s + kWalk * LD;
    const float* di_s = lse_s + kWalk;
    const int q0 = i * kWalk;

    // s^T = (scale k) q^T and dp^T = (v / keep) do^T: 16 keys x 32 queries
    float st_acc[CN][4], dpt_acc[CN][4];
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st_acc[j][e] = dpt_acc[j][e] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 8) {
      FragA ka, va;
      FragB qb[CN], ob[CN];
      load_a(ka, ka_s + d0, LD, lane);
      load_a(va, va_s + d0, LD, lane);
#pragma unroll
      for (int j = 0; j < CN; j += 2) {
        load_b_nk_x2(qb[j], qb[j + 1], q_s + 8 * j * LD + d0, LD, lane);
        load_b_nk_x2(ob[j], ob[j + 1], do_s + 8 * j * LD + d0, LD, lane);
      }
      mma3<CN>(st_acc, ka, qb);
      mma3<CN>(dpt_acc, va, ob);
    }
    // entry e of tile j: key key_a (+ 8 for e >= 2), query ql (+ 1 for odd e);
    // pd / keep and scale ds replace s^T and dp^T, so that the products below
    // take the walked do and q as they are
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int ql = 8 * j + 2 * t4;
      float2 ls = *reinterpret_cast<const float2*>(lse_s + ql);
      const float2 dd = *reinterpret_cast<const float2*>(di_s + ql);
      ls.x = q0 + ql < T ? ls.x : INFINITY;  // queries >= T: p = 0
      ls.y = q0 + ql + 1 < T ? ls.y : INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + ql + (e & 1);
        float pd, ds;
        p_and_ds(st_acc[j][e], dpt_acc[j][e], (e & 2) ? kb_b : kb_a, (e & 1) ? ls.y : ls.x,
                 (e & 1) ? dd.y : dd.x, bn, qi, key_a + ((e & 2) ? 8 : 0), s0, s1, thresh,
                 dropout, pd, ds);
        st_acc[j][e] = pd * inv_keep;
        dpt_acc[j][e] = ds * scale;
      }
    }
    // dv += (pd / keep)^T do and dk += (scale ds)^T q: contraction over the
    // tile's queries, 8 at a time, the accumulators above as the A operands
    // per group of 4 column tiles: the tile's sum in fresh accumulators on the
    // tensor core (12 chained passes), then one f32 addition into dv / dk
#pragma unroll
    for (int c = 0; c < DN; c += 4) {
      float dv_t[4][4], dk_t[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv_t[u][e] = dk_t[u][e] = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        FragA pa, dsa;
        frag_a_from_acc(pa, st_acc[j]);
        frag_a_from_acc(dsa, dpt_acc[j]);
        FragB ob[4], qb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          load_b_kn(ob[u], do_s + 8 * j * LD + 8 * (c + u), LD, lane);
          load_b_kn(qb[u], q_s + 8 * j * LD + 8 * (c + u), LD, lane);
        }
        mma3<4>(dv_t, pa, ob);
        mma3<4>(dk_t, dsa, qb);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[c + u][e] += dv_t[u][e];
          dk_acc[c + u][e] += dk_t[u][e];
        }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = key_a + 8 * half;
    if (t >= T) continue;
    const long long o = ohead + (long long)t * H + 2 * t4;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      *reinterpret_cast<float2*>(dk + o + 8 * c) =
          make_float2(dk_acc[c][2 * half], dk_acc[c][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + o + 8 * c) =
          make_float2(dv_acc[c][2 * half], dv_acc[c][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 3 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ kbias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int T, int N,
                    long long sb, long long st, float scale, float inv_keep, uint32_t thresh,
                    uint32_t s0, uint32_t s1, int batch0, int dropout, int vec) {
  constexpr int LD = D + 4;
  constexpr int DN = D / 8;
  constexpr int CN = kWalk / 8;  // 8-key tiles of s / dp
  constexpr int kStage = 2 * kWalk * LD + 2 * kWalk;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // scale q
  float* do_s = q_s + 64 * LD;                   // do / keep
  float* walk_s = do_s + 64 * LD;                // per stage: k, v, key bias

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const int H = N * D;
  const long long head = (long long)b * sb + (long long)n * D;
  const long long ohead = (long long)b * T * H + (long long)n * D;
  const long long bn_row = ((long long)b * N + n) * T;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  auto start = [&](int i) {
    float* w = walk_s + (i & 1) * kStage;
    start_walk_tile<D>(w, k + head, st, w + kWalk * LD, v + head, st, w + 2 * kWalk * LD,
                       kbias + (long long)b * T, nullptr, nullptr, i * kWalk, T, vec);
  };
  start(0);
  load_tile<D>(q_s, q + head, st, q0, T, scale, vec);
  load_tile<D>(do_s, dout + ohead, H, q0, T, inv_keep, vec);
  // this thread's accumulator rows: queries q_a and q_a + 8
  const int q_a = q0 + warp * 16 + g;
  const bool ok_a = q_a < T, ok_b = q_a + 8 < T;
  const float lse_a = ok_a ? lse[bn_row + q_a] : INFINITY;  // queries >= T: p = 0
  const float lse_b = ok_b ? lse[bn_row + q_a + 8] : INFINITY;
  const float di_a = ok_a ? di[bn_row + q_a] : 0.f;
  const float di_b = ok_b ? di[bn_row + q_a + 8] : 0.f;

  float dq_acc[DN][4];
#pragma unroll
  for (int c = 0; c < DN; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[c][e] = 0.f;

  const float* qa_s = q_s + warp * 16 * LD;
  const float* oa_s = do_s + warp * 16 * LD;
  const int n_walk = (T + kWalk - 1) / kWalk;

  for (int i = 0; i < n_walk; ++i) {
    cp_async_wait_all();  // as in the dk/dv kernel
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const float* k_s = walk_s + (i & 1) * kStage;
    const float* v_s = k_s + kWalk * LD;
    const float* kb_s = v_s + kWalk * LD;
    const int k0 = i * kWalk;

    // s = (scale q) k^T and dp = do' v^T: 16 queries x 32 keys
    float s_acc[CN][4], dp_acc[CN][4];
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = dp_acc[j][e] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 8) {
      FragA qa, oa;
      FragB kf[CN], vf[CN];
      load_a(qa, qa_s + d0, LD, lane);
      load_a(oa, oa_s + d0, LD, lane);
#pragma unroll
      for (int j = 0; j < CN; j += 2) {
        load_b_nk_x2(kf[j], kf[j + 1], k_s + 8 * j * LD + d0, LD, lane);
        load_b_nk_x2(vf[j], vf[j + 1], v_s + 8 * j * LD + d0, LD, lane);
      }
      mma3<CN>(s_acc, qa, kf);
      mma3<CN>(dp_acc, oa, vf);
    }
    // entry e of tile j: query q_a (+ 8 for e >= 2), key kl (+ 1 for odd e);
    // ds replaces dp
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kl = 8 * j + 2 * t4;
      const float2 kb = *reinterpret_cast<const float2*>(kb_s + kl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pd, ds;
        p_and_ds(s_acc[j][e], dp_acc[j][e], (e & 1) ? kb.y : kb.x, (e & 2) ? lse_b : lse_a,
                 (e & 2) ? di_b : di_a, bn, q_a + ((e & 2) ? 8 : 0), k0 + kl + (e & 1), s0,
                 s1, thresh, dropout, pd, ds);
        dp_acc[j][e] = ds;
      }
    }
    // dq += ds k: contraction over the tile's keys, 8 at a time
#pragma unroll
    for (int c = 0; c < DN; c += 4) {
      float dq_t[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_t[u][e] = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        FragA dsa;
        frag_a_from_acc(dsa, dp_acc[j]);
        FragB kf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load_b_kn(kf[u], k_s + 8 * j * LD + 8 * (c + u), LD, lane);
        mma3<4>(dq_t, dsa, kf);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[c + u][e] += dq_t[u][e];
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q_a + 8 * half;
    if (t >= T) continue;
    const long long o = ohead + (long long)t * H + 2 * t4;
#pragma unroll
    for (int c = 0; c < DN; ++c)
      *reinterpret_cast<float2*>(dq + o + 8 * c) =
          make_float2(dq_acc[c][2 * half] * scale, dq_acc[c][2 * half + 1] * scale);
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

  // 16-byte tile loads where every row start is 16-byte aligned
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
                  sb % 4 == 0 && st % 4 == 0;
  const size_t smem = sizeof(float) * tile_smem_floats<D>();
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  flash_bwd_dkdv_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      q, k, v, kbias, dout, lse, di, dk, dv, T, N, sb, st, scale, inv_keep, thresh, s0, s1,
      batch0, dropout, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  flash_bwd_dq_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      q, k, v, kbias, dout, lse, di, dq, T, N, sb, st, scale, inv_keep, thresh, s0, s1,
      batch0, dropout, vec);
  return (int)cudaGetLastError();
}

// ---- B3 bwd in bf16 (compute_dtype bf16) ----------------------------------
//
// The same function at the JAX kernel's bf16 roundings (attention_kernel.py
// :171-250 with bf16 q, k, v, out and cotangent): with do' = do / keep,
// qs = bf16(scale q) and ks = bf16(scale k) (the caller rounds the scale to
// bf16),
//   s = qs k^T + kbias, p = exp(s - lse) in f32,
//   dv = bf16( sum bf16(keep_bits ? p : 0)^T bf16(do') )
//   dp = keep_bits ? bf16(do') v^T : 0,  Di = keep * rowsum(do' * out)
//   ds = bf16( p (dp - Di) )
//   dq = bf16( ds ks ),  dk = bf16( sum ds^T qs )
// every product one bf16 tensor-core pass (mma_bf16.cuh) with f32 sums, each
// result rounded to bf16 once, from its f32 accumulator.
//
// Bound on this card: operations (the five products, 46 GFLOP at B=6,
// T=1001, 12 x 64, over 989 TFLOP/s) against 0.1 GB moved. Four launches,
// deterministic, without atomics: a pre-pass writes Di and the rounded
// operands do', qs and ks (contiguous (B, T, N * D) bf16 scratch, so that the
// tile kernels copy their walked tiles as they are and round nothing on the
// way), then the dk/dv and dq kernels of the f32 design, with the products
// as one mma.m16n8k16 pass each and the walked tiles in bf16 (half the f32
// kernels' bytes). dk and dv sum over the walk in their accumulators.

namespace bm = bf16mma;
using bm::bf16;

__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ dout, const bf16* __restrict__ out,
                           float* __restrict__ di, bf16* __restrict__ qs,
                           bf16* __restrict__ ks, bf16* __restrict__ dos, int B, int T,
                           int N, int D, long long sb, long long st, float scale,
                           float keep) {
  const int warps = kThreads / 32;
  const long long row = (long long)blockIdx.x * warps + threadIdx.x / 32;  // (b, t, n)
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * T * N) return;
  const long long n = row % N, bt = row / N, t = bt % T, b = bt / T;
  const long long src = b * sb + t * st + n * D;  // q and k are strided views
  const long long dst = row * D;                  // the contiguous tensors
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float x = __bfloat162float(dout[dst + d]) / keep;
    acc = fmaf(x, __bfloat162float(out[dst + d]), acc);
    dos[dst + d] = __float2bfloat16_rn(x);
    qs[dst + d] = __float2bfloat16_rn(__bfloat162float(q[src + d]) * scale);
    ks[dst + d] = __float2bfloat16_rn(__bfloat162float(k[src + d]) * scale);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[(b * N + n) * T + t] = keep * acc;
}

// Dynamic shared memory in bytes: two resident [64][D + 8] bf16 tiles, and two
// stages of the walked tiles: the dk/dv kernel's qs and do' ([32][D + 8] bf16)
// with lse and Di (32 f32 each), the dq kernel's k, v and ks with the key bias.
template <int D>
__host__ __device__ constexpr int dkdv_bf16_stage_bytes() {
  return 2 * 2 * kWalk * (D + 8) + 2 * 4 * kWalk;
}

template <int D>
__host__ __device__ constexpr int dq_bf16_stage_bytes() {
  return 3 * 2 * kWalk * (D + 8) + 4 * kWalk;
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 2 : 1)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const float* __restrict__ kbias, const bf16* __restrict__ qs,
                           const bf16* __restrict__ dos, const float* __restrict__ lse,
                           const float* __restrict__ di, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int T, int N, long long sb, long long st,
                           uint32_t thresh, uint32_t s0, uint32_t s1, int batch0, int dropout,
                           int vec) {
  constexpr int LD = D + 8;
  constexpr int DN = D / 8;      // 8-column tiles of dk / dv
  constexpr int CN = kWalk / 8;  // 8-query tiles of s^T / dp^T
  constexpr int kStage = dkdv_bf16_stage_bytes<D>();
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);
  bf16* v_s = k_s + 64 * LD;
  char* walk_s = reinterpret_cast<char*>(v_s + 64 * LD);  // per stage: qs, do', lse, Di

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBK, n = blockIdx.y, b = blockIdx.z;
  const int H = N * D;
  const long long head = (long long)b * sb + (long long)n * D;
  const long long ohead = (long long)b * T * H + (long long)n * D;  // contiguous tensors
  const long long bn_row = ((long long)b * N + n) * T;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  auto start = [&](int i) {
    char* w = walk_s + (i & 1) * kStage;
    bf16* const dst[2] = {reinterpret_cast<bf16*>(w), reinterpret_cast<bf16*>(w) + kWalk * LD};
    const bf16* const src[2] = {qs + ohead, dos + ohead};
    const long long stride[2] = {H, H};
    bm::start_walk<D, 2>(dst, src, stride, i * kWalk, T, kWalk, vec, kTileThreads);
    float* rows = reinterpret_cast<float*>(w + 4 * kWalk * LD);
    if (threadIdx.x < kWalk) {
      const int t = i * kWalk + threadIdx.x;
      const int at = t < T ? t : T - 1, bytes = t < T ? 4 : 0;
      cp_async4(rows + threadIdx.x, lse + bn_row + at, bytes);
      cp_async4(rows + kWalk + threadIdx.x, di + bn_row + at, bytes);
    }
    cp_async_commit();
  };
  start(0);
  bm::load_tile<D>(k_s, k + head, st, k0, T, 64, 1.f, vec, kTileThreads);
  bm::load_tile<D>(v_s, v + head, st, k0, T, 64, 1.f, vec, kTileThreads);
  // this thread's accumulator rows: keys key_a and key_a + 8
  const int key_a = k0 + warp * 16 + g;
  const float kb_a = key_a < T ? kbias[(long long)b * T + key_a] : -INFINITY;
  const float kb_b = key_a + 8 < T ? kbias[(long long)b * T + key_a + 8] : -INFINITY;

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int c = 0; c < DN; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  const bf16* ka_s = k_s + warp * 16 * LD;
  const bf16* va_s = v_s + warp * 16 * LD;
  const int n_walk = (T + kWalk - 1) / kWalk;

  for (int i = 0; i < n_walk; ++i) {
    cp_async_wait_all();  // as in the f32 kernels
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const char* w = walk_s + (i & 1) * kStage;
    const bf16* q_s = reinterpret_cast<const bf16*>(w);
    const bf16* do_s = q_s + kWalk * LD;
    const float* lse_s = reinterpret_cast<const float*>(w + 4 * kWalk * LD);
    const float* di_s = lse_s + kWalk;
    const int q0 = i * kWalk;

    // s^T = k qs^T and dp^T = v do'^T: 16 keys x 32 queries
    float st_acc[CN][4], dpt_acc[CN][4];
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st_acc[j][e] = dpt_acc[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t ka[4], va[4];
      bm::load_a(ka, ka_s + d0, LD, lane);
      bm::load_a(va, va_s + d0, LD, lane);
#pragma unroll
      for (int j = 0; j < CN; j += 2) {
        uint32_t b0[2], b1[2];
        bm::load_b_nk_x2(b0, b1, q_s + 8 * j * LD + d0, LD, lane);
        bm::mma(st_acc[j], ka, b0);
        bm::mma(st_acc[j + 1], ka, b1);
        bm::load_b_nk_x2(b0, b1, do_s + 8 * j * LD + d0, LD, lane);
        bm::mma(dpt_acc[j], va, b0);
        bm::mma(dpt_acc[j + 1], va, b1);
      }
    }
    // entry e of tile j: key key_a (+ 8 for e >= 2), query ql (+ 1 for odd e);
    // the dropped p and ds replace s^T and dp^T
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int ql = 8 * j + 2 * t4;
      float2 ls = *reinterpret_cast<const float2*>(lse_s + ql);
      const float2 dd = *reinterpret_cast<const float2*>(di_s + ql);
      ls.x = q0 + ql < T ? ls.x : INFINITY;  // queries >= T: p = 0
      ls.y = q0 + ql + 1 < T ? ls.y : INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pd, ds;
        p_and_ds(st_acc[j][e], dpt_acc[j][e], (e & 2) ? kb_b : kb_a, (e & 1) ? ls.y : ls.x,
                 (e & 1) ? dd.y : dd.x, bn, q0 + ql + (e & 1), key_a + ((e & 2) ? 8 : 0), s0,
                 s1, thresh, dropout, pd, ds);
        st_acc[j][e] = pd;
        dpt_acc[j][e] = ds;
      }
    }
    // dv += bf16(pd)^T do' and dk += bf16(ds)^T qs: contraction over the
    // tile's queries, 16 at a time, the tiles above rounded to bf16 as the A
    // operands
#pragma unroll
    for (int j = 0; j < CN; j += 2) {
      uint32_t pa[4], dsa[4];
      bm::frag_a_from_acc(pa, st_acc[j], st_acc[j + 1]);
      bm::frag_a_from_acc(dsa, dpt_acc[j], dpt_acc[j + 1]);
#pragma unroll
      for (int c = 0; c < DN; c += 2) {
        uint32_t b0[2], b1[2];
        bm::load_b_kn_x2(b0, b1, do_s + 8 * j * LD + 8 * c, LD, lane);
        bm::mma(dv_acc[c], pa, b0);
        bm::mma(dv_acc[c + 1], pa, b1);
        bm::load_b_kn_x2(b0, b1, q_s + 8 * j * LD + 8 * c, LD, lane);
        bm::mma(dk_acc[c], dsa, b0);
        bm::mma(dk_acc[c + 1], dsa, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = key_a + 8 * half;
    if (t >= T) continue;
    const long long o = ohead + (long long)t * H + 2 * t4;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * c) =
          __floats2bfloat162_rn(dk_acc[c][2 * half], dk_acc[c][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * c) =
          __floats2bfloat162_rn(dv_acc[c][2 * half], dv_acc[c][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 2 : 1)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const float* __restrict__ kbias, const bf16* __restrict__ qs,
                         const bf16* __restrict__ ks, const bf16* __restrict__ dos,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dq, int T, int N, long long sb, long long st,
                         uint32_t thresh, uint32_t s0, uint32_t s1, int batch0, int dropout,
                         int vec) {
  constexpr int LD = D + 8;
  constexpr int DN = D / 8;
  constexpr int CN = kWalk / 8;  // 8-key tiles of s / dp
  constexpr int kStage = dq_bf16_stage_bytes<D>();
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);             // qs
  bf16* do_s = q_s + 64 * LD;                             // do'
  char* walk_s = reinterpret_cast<char*>(do_s + 64 * LD);  // per stage: k, v, ks, bias

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ, n = blockIdx.y, b = blockIdx.z;
  const int H = N * D;
  const long long head = (long long)b * sb + (long long)n * D;
  const long long ohead = (long long)b * T * H + (long long)n * D;
  const long long bn_row = ((long long)b * N + n) * T;
  const uint32_t bn = (uint32_t)((batch0 + b) * N + n);

  auto start = [&](int i) {
    char* w = walk_s + (i & 1) * kStage;
    bf16* wb = reinterpret_cast<bf16*>(w);
    bf16* const dst[3] = {wb, wb + kWalk * LD, wb + 2 * kWalk * LD};
    const bf16* const src[3] = {k + head, v + head, ks + ohead};
    const long long stride[3] = {st, st, H};
    bm::start_walk<D, 3>(dst, src, stride, i * kWalk, T, kWalk, vec, kTileThreads);
    if (threadIdx.x < kWalk) {
      const int t = i * kWalk + threadIdx.x;
      reinterpret_cast<float*>(w + 6 * kWalk * LD)[threadIdx.x] =
          t < T ? kbias[(long long)b * T + t] : -INFINITY;  // keys >= T: bias -inf
    }
    cp_async_commit();
  };
  start(0);
  bm::load_tile<D>(q_s, qs + ohead, H, q0, T, 64, 1.f, vec, kTileThreads);
  bm::load_tile<D>(do_s, dos + ohead, H, q0, T, 64, 1.f, vec, kTileThreads);
  // this thread's accumulator rows: queries q_a and q_a + 8
  const int q_a = q0 + warp * 16 + g;
  const bool ok_a = q_a < T, ok_b = q_a + 8 < T;
  const float lse_a = ok_a ? lse[bn_row + q_a] : INFINITY;  // queries >= T: p = 0
  const float lse_b = ok_b ? lse[bn_row + q_a + 8] : INFINITY;
  const float di_a = ok_a ? di[bn_row + q_a] : 0.f;
  const float di_b = ok_b ? di[bn_row + q_a + 8] : 0.f;

  float dq_acc[DN][4];
#pragma unroll
  for (int c = 0; c < DN; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[c][e] = 0.f;

  const bf16* qa_s = q_s + warp * 16 * LD;
  const bf16* oa_s = do_s + warp * 16 * LD;
  const int n_walk = (T + kWalk - 1) / kWalk;

  for (int i = 0; i < n_walk; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const char* w = walk_s + (i & 1) * kStage;
    const bf16* k_s = reinterpret_cast<const bf16*>(w);
    const bf16* v_s = k_s + kWalk * LD;
    const bf16* ks_s = v_s + kWalk * LD;
    const float* kb_s = reinterpret_cast<const float*>(w + 6 * kWalk * LD);
    const int k0 = i * kWalk;

    // s = qs k^T and dp = do' v^T: 16 queries x 32 keys
    float s_acc[CN][4], dp_acc[CN][4];
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = dp_acc[j][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t qa[4], oa[4];
      bm::load_a(qa, qa_s + d0, LD, lane);
      bm::load_a(oa, oa_s + d0, LD, lane);
#pragma unroll
      for (int j = 0; j < CN; j += 2) {
        uint32_t b0[2], b1[2];
        bm::load_b_nk_x2(b0, b1, k_s + 8 * j * LD + d0, LD, lane);
        bm::mma(s_acc[j], qa, b0);
        bm::mma(s_acc[j + 1], qa, b1);
        bm::load_b_nk_x2(b0, b1, v_s + 8 * j * LD + d0, LD, lane);
        bm::mma(dp_acc[j], oa, b0);
        bm::mma(dp_acc[j + 1], oa, b1);
      }
    }
    // entry e of tile j: query q_a (+ 8 for e >= 2), key kl (+ 1 for odd e);
    // ds replaces dp
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kl = 8 * j + 2 * t4;
      const float2 kb = *reinterpret_cast<const float2*>(kb_s + kl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pd, ds;
        p_and_ds(s_acc[j][e], dp_acc[j][e], (e & 1) ? kb.y : kb.x, (e & 2) ? lse_b : lse_a,
                 (e & 2) ? di_b : di_a, bn, q_a + ((e & 2) ? 8 : 0), k0 + kl + (e & 1), s0,
                 s1, thresh, dropout, pd, ds);
        dp_acc[j][e] = ds;
      }
    }
    // dq += bf16(ds) ks: contraction over the tile's keys, 16 at a time
#pragma unroll
    for (int j = 0; j < CN; j += 2) {
      uint32_t dsa[4];
      bm::frag_a_from_acc(dsa, dp_acc[j], dp_acc[j + 1]);
#pragma unroll
      for (int c = 0; c < DN; c += 2) {
        uint32_t b0[2], b1[2];
        bm::load_b_kn_x2(b0, b1, ks_s + 8 * j * LD + 8 * c, LD, lane);
        bm::mma(dq_acc[c], dsa, b0);
        bm::mma(dq_acc[c + 1], dsa, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q_a + 8 * half;
    if (t >= T) continue;
    const long long o = ohead + (long long)t * H + 2 * t4;
#pragma unroll
    for (int c = 0; c < DN; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dq + o + 8 * c) =
          __floats2bfloat162_rn(dq_acc[c][2 * half], dq_acc[c][2 * half + 1]);
  }
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* kbias,
                const bf16* out, const bf16* dout, const float* lse, float* di, bf16* qs,
                bf16* ks, bf16* dos, bf16* dq, bf16* dk, bf16* dv, int B, int T, int N,
                long long sb, long long st, float scale, float keep, uint32_t thresh,
                uint32_t s0, uint32_t s1, int batch0, int dropout, cudaStream_t stream) {
  cudaError_t err;
  const long long rows = (long long)B * T * N;
  const int warps = kThreads / 32;
  flash_bwd_prep_bf16_kernel<<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                               stream>>>(q, k, dout, out, di, qs, ks, dos, B, T, N, D, sb, st,
                                         scale, keep);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 16-byte tile copies (8 bf16) where every row start is 16-byte aligned;
  // the scratch tensors are whole allocations with rows of N * D values
  const int vec = aligned16(k) && aligned16(v) && sb % 8 == 0 && st % 8 == 0;
  const int resident = 2 * 2 * 64 * (D + 8);
  const size_t smem_dkdv = resident + 2 * dkdv_bf16_stage_bytes<D>();
  const size_t smem_dq = resident + 2 * dq_bf16_stage_bytes<D>();
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_dkdv)) != cudaSuccess)
    return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  flash_bwd_dkdv_bf16_kernel<D><<<grid, kTileThreads, smem_dkdv, stream>>>(
      k, v, kbias, qs, dos, lse, di, dk, dv, T, N, sb, st, thresh, s0, s1, batch0, dropout,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_dq)) != cudaSuccess)
    return (int)err;
  flash_bwd_dq_bf16_kernel<D><<<grid, kTileThreads, smem_dq, stream>>>(
      k, v, kbias, qs, ks, dos, lse, di, dq, T, N, sb, st, thresh, s0, s1, batch0, dropout,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B3 bwd: three launches on `stream` of `device`; returns the first
// launch error (0 on success); does not synchronise. di is (B, N, T) f32
// scratch the caller allocates. D, thresh and dropout as for
// flash_attn_fwd_f32; inv_keep = 1 / (1 - rate). dq, dk and dv must be
// 8-byte aligned (they are whole allocations).
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

// Kernel B3 bwd in bf16: four launches on `stream` of `device`; returns the
// first launch error (0 on success); does not synchronise. q, k, v, out,
// dout, dq, dk and dv are bf16, kbias and lse f32; di (B, N, T) f32 and qs, ks,
// dos (B, T, N * D) bf16 are scratch the caller allocates. `scale` is the
// softmax scale already rounded to bf16 and keep = 1 - rate; the other
// arguments as for flash_attn_bwd_f32.
int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* kbias,
                        const void* out, const void* dout, const void* lse, void* di,
                        void* qs, void* ks, void* dos, void* dq, void* dk, void* dv, int B,
                        int T, int N, int D, long long sb, long long st, float scale,
                        float keep, unsigned thresh, unsigned s0, unsigned s1, int batch0,
                        int dropout, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  auto cf = static_cast<const float*>(kbias);
  auto lf = static_cast<const float*>(lse);
  auto df = static_cast<float*>(di);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_bf16<32>(c(q), c(k), c(v), cf, c(out), c(dout), lf, df, m(qs), m(ks),
                             m(dos), m(dq), m(dk), m(dv), B, T, N, sb, st, scale, keep,
                             thresh, s0, s1, batch0, dropout, s);
    case 64:
      return launch_bf16<64>(c(q), c(k), c(v), cf, c(out), c(dout), lf, df, m(qs), m(ks),
                             m(dos), m(dq), m(dk), m(dv), B, T, N, sb, st, scale, keep,
                             thresh, s0, s1, batch0, dropout, s);
    case 128:
      return launch_bf16<128>(c(q), c(k), c(v), cf, c(out), c(dout), lf, df, m(qs), m(ks),
                              m(dos), m(dq), m(dk), m(dv), B, T, N, sb, st, scale, keep,
                              thresh, s0, s1, batch0, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
