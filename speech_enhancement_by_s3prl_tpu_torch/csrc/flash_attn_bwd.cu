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

#include "flash_attn_bf16.cuh"
#include "flash_attn_common.cuh"
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

// p and ds of one accumulator entry, from s and dp, and its keep bit. Keys
// >= T come with kb = -inf and queries >= T with lse = +inf, so p = 0 there
// without a branch.
__device__ __forceinline__ void p_and_ds(float s, float dp, float kb, float lse, float di,
                                         bool kept, float& pd, float& ds) {
  const float p = expf(s + kb - lse);
  pd = kept ? p : 0.f;
  ds = p * ((kept ? dp : 0.f) - di);
}

// The walk and the output columns of the tile kernels by head width. Up to
// D = 128 the walked tiles are kWalk rows and a dk/dv block computes every
// column. At D = 256 the two resident 64 x 260 f32 tiles (133 KB) leave room
// for two stages of 16-row walked tiles only; and dk and dv of 16 rows x 256
// columns a warp would be 256 accumulator registers a thread, so a dk/dv
// block computes one half of their columns (kOut = 128), recomputing s^T and
// dp^T, which need all of D, for each half. The dq kernel keeps all 256
// columns of dq (128 registers a thread).
template <int D>
struct BwdTiles {
  static constexpr int kRows = D == 256 ? 16 : kWalk;  // walked rows a stage
  static constexpr int kOut = D == 256 ? 128 : D;      // dk / dv columns a block
};

// Dynamic shared memory of both tile kernels, in floats: the two resident
// [64][D + 4] tiles, two stages of two walked [W][D + 4] tiles, and two
// stages of two W-entry rows (lse and Di, or the key bias).
template <int D>
constexpr int tile_smem_floats() {
  constexpr int W = BwdTiles<D>::kRows;
  return 2 * 64 * (D + 4) + 2 * 2 * W * (D + 4) + 2 * 2 * W;
}

// FORM: the mask form (flash_attn_common.cuh), drawn where dropout != 0
template <int D, int FORM>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 2 : 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ kbias,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dk,
                      float* __restrict__ dv, int T, int N, long long sb, long long st,
                      float scale, float inv_keep, Mask mask, int dropout, int vec) {
  constexpr int LD = D + 4;
  constexpr int W = BwdTiles<D>::kRows;      // walked queries a stage
  constexpr int DO = BwdTiles<D>::kOut;      // dk / dv columns of this block
  constexpr int DN = DO / 8;                 // 8-column tiles of dk / dv
  constexpr int CN = W / 8;                  // 8-query tiles of s^T / dp^T
  constexpr int kStage = 2 * W * LD + 2 * W;  // floats of one walked stage
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // scale k
  float* v_s = k_s + 64 * LD;                    // v / keep
  float* walk_s = v_s + 64 * LD;                 // per stage: q, do, lse, Di

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // blockIdx.y: head n and, where DO < D, which DO columns of dk and dv
  const int k0 = blockIdx.x * kBK, n = blockIdx.y / (D / DO), b = blockIdx.z;
  const int col0 = (blockIdx.y % (D / DO)) * DO;
  const int H = N * D;
  const long long head = (long long)b * sb + (long long)n * D;
  const long long ohead = (long long)b * T * H + (long long)n * D;  // contiguous tensors
  const long long bn_row = ((long long)b * N + n) * T;
  MaskRows<FORM> mrows(mask, b, n);

  auto start = [&](int i) {
    float* w = walk_s + (i & 1) * kStage;
    start_walk_tile<D, W>(w, q + head, st, w + W * LD, dout + ohead, H, w + 2 * W * LD,
                          lse + bn_row, w + 2 * W * LD + W, di + bn_row, i * W, T, vec);
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
  const int n_walk = (T + W - 1) / W;

  for (int i = 0; i < n_walk; ++i) {
    // tile i has landed; every warp is done with tile i - 1, whose stage the
    // copy of tile i + 1 may now overwrite while tile i is worked on
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const float* q_s = walk_s + (i & 1) * kStage;
    const float* do_s = q_s + W * LD;
    const float* lse_s = do_s + W * LD;
    const float* di_s = lse_s + W;
    const int q0 = i * W;

    // s^T = (scale k) q^T and dp^T = (v / keep) do^T: 16 keys x W queries
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
        const bool kept = !dropout || mrows.at(qi).keep(key_a + ((e & 2) ? 8 : 0));
        p_and_ds(st_acc[j][e], dpt_acc[j][e], (e & 2) ? kb_b : kb_a, (e & 1) ? ls.y : ls.x,
                 (e & 1) ? dd.y : dd.x, kept, pd, ds);
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
          load_b_kn(ob[u], do_s + 8 * j * LD + col0 + 8 * (c + u), LD, lane);
          load_b_kn(qb[u], q_s + 8 * j * LD + col0 + 8 * (c + u), LD, lane);
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
    const long long o = ohead + (long long)t * H + col0 + 2 * t4;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      *reinterpret_cast<float2*>(dk + o + 8 * c) =
          make_float2(dk_acc[c][2 * half], dk_acc[c][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + o + 8 * c) =
          make_float2(dv_acc[c][2 * half], dv_acc[c][2 * half + 1]);
    }
  }
}

template <int D, int FORM>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 3 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ kbias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int T, int N,
                    long long sb, long long st, float scale, float inv_keep, Mask mask,
                    int dropout, int vec) {
  constexpr int LD = D + 4;
  constexpr int W = BwdTiles<D>::kRows;  // walked keys a stage
  constexpr int DN = D / 8;
  constexpr int CN = W / 8;  // 8-key tiles of s / dp
  constexpr int kStage = 2 * W * LD + 2 * W;
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
  MaskRows<FORM> mrows(mask, b, n);

  auto start = [&](int i) {
    float* w = walk_s + (i & 1) * kStage;
    start_walk_tile<D, W>(w, k + head, st, w + W * LD, v + head, st, w + 2 * W * LD,
                          kbias + (long long)b * T, nullptr, nullptr, i * W, T, vec);
  };
  start(0);
  load_tile<D>(q_s, q + head, st, q0, T, scale, vec);
  load_tile<D>(do_s, dout + ohead, H, q0, T, inv_keep, vec);
  // this thread's accumulator rows: queries q_a and q_a + 8
  const int q_a = q0 + warp * 16 + g;
  const MaskRow<FORM> mrow[2] = {mrows.at(q_a), mrows.at(q_a + 8)};
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
  const int n_walk = (T + W - 1) / W;

  for (int i = 0; i < n_walk; ++i) {
    cp_async_wait_all();  // as in the dk/dv kernel
    __syncthreads();
    if (i + 1 < n_walk) start(i + 1);
    const float* k_s = walk_s + (i & 1) * kStage;
    const float* v_s = k_s + W * LD;
    const float* kb_s = v_s + W * LD;
    const int k0 = i * W;

    // s = (scale q) k^T and dp = do' v^T: 16 queries x W keys
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
        const bool kept = !dropout || mrow[e >> 1].keep(k0 + kl + (e & 1));
        p_and_ds(s_acc[j][e], dp_acc[j][e], (e & 1) ? kb.y : kb.x, (e & 2) ? lse_b : lse_a,
                 (e & 2) ? di_b : di_a, kept, pd, ds);
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
           float inv_keep, const Mask& mask, int dropout, int form, cudaStream_t stream) {
  cudaError_t err;
  const long long rows = (long long)B * T * N;
  const int warps = kThreads / 32;
  flash_bwd_dot_kernel<<<(unsigned)((rows + warps - 1) / warps), kThreads, 0, stream>>>(
      dout, out, di, B, T, N, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 16-byte tile loads where every row start is 16-byte aligned
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
                  sb % 4 == 0 && st % 4 == 0;
  // without dropout the mask is not drawn: the hash instances serve
  auto dkdv = flash_bwd_dkdv_kernel<D, kMaskHash>;
  auto dq_kernel = flash_bwd_dq_kernel<D, kMaskHash>;
  if (dropout && form == kMaskFlax) {
    dkdv = flash_bwd_dkdv_kernel<D, kMaskFlax>;
    dq_kernel = flash_bwd_dq_kernel<D, kMaskFlax>;
  }
  if (dropout && form == kMaskHiddenHash) {
    dkdv = flash_bwd_dkdv_kernel<D, kMaskHiddenHash>;
    dq_kernel = flash_bwd_dq_kernel<D, kMaskHiddenHash>;
  }
  const size_t smem = sizeof(float) * tile_smem_floats<D>();
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  // the dk/dv kernel's blockIdx.y also picks its columns (BwdTiles)
  dim3 grid_dkdv((T + kBK - 1) / kBK, N * (D / BwdTiles<D>::kOut), B);
  dkdv<<<grid_dkdv, kTileThreads, smem, stream>>>(q, k, v, kbias, dout, lse, di, dk, dv, T, N,
                                                  sb, st, scale, inv_keep, mask, dropout, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  dq_kernel<<<grid, kTileThreads, smem, stream>>>(q, k, v, kbias, dout, lse, di, dq, T, N, sb,
                                                  st, scale, inv_keep, mask, dropout, vec);
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
// every product bf16 operands on the tensor cores (wgmma) with f32 sums, each
// result rounded to bf16 once, from its f32 accumulator.
//
// Bound on this card. The five products are 46 GFLOP at B=6, T=1001, 12 x 64
// (0.047 ms at 989 TFLOP/s) against 0.1 GB moved; as in the forward, the
// CUDA-core work of each logit (an exponential and the hash, in both tile
// kernels, which recompute p and the keep bits) outweighs it at D = 64.
//
// Design (Hopper). Three launches, deterministic, without atomics. A
// pre-pass writes Di and the rounded operands do', qs and ks as contiguous
// (B, T, N * D) bf16 scratch (16 bytes a thread), so the tile kernels take
// their tiles as TMA brings them. Then two tile kernels of the forward's
// shape, a CTA of three consumer warpgroups of 64 resident rows each (two at
// D = 128) and a producer warp that brings the CTA's resident rows in once
// by TMA and walks the other operand through a ring of four stages of shared
// memory on mbarriers (three for dq at D = 128):
//   - dk/dv: a CTA owns 192 keys (K and V from the strided views) and walks
//     qs and do', 32 queries a tile, the producer's lanes writing each
//     stage's lse and Di (queries >= T: +inf and 0, so p = 0 there). Per tile
//     S^T = K qs^T and dP^T = V do'^T (SS wgmma m64n32k16, K-major), then p,
//     the keep bits and ds on the accumulator registers, rounded and packed as
//     A registers of dV += bf16(p_drop)^T do' and dK += bf16(ds)^T qs (RS
//     wgmma m64nDk16, the walked tiles read MN-major): the keys are the
//     accumulator rows, so no tile passes through shared memory;
//   - dq: a CTA owns 192 queries (qs and do' resident) and walks K, V and ks,
//     64 keys a tile, with the key bias (-inf at keys >= T) beside each
//     stage: S = qs K^T and dP = do' V^T (SS), p and ds, dQ += bf16(ds) ks
//     (RS, ks MN-major).
// Both sum over the walk in their wgmma accumulators. p is exp(s + kbias -
// lse) by __expf (ex2.approx: two instructions where expf takes nine, within
// the card's limits), and the kernels are compiled with and without the hash
// (a runtime flag inside the loop split it into short branches).

namespace hp = hopper;
namespace fb = flash_bf16;
using bf16 = __nv_bfloat16;

// The pre-pass: one thread per 8 values (16 bytes) of a (b, t, n) row, D / 8
// threads a row (all in one warp). q and k rows are 16-byte aligned (the
// wrapper's tma_ready), dout and out are contiguous.
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ dout, const bf16* __restrict__ out,
                           float* __restrict__ di, bf16* __restrict__ qs,
                           bf16* __restrict__ ks, bf16* __restrict__ dos, int B, int T,
                           int N, int D, long long sbq, long long stq, long long sbk,
                           long long stk, float scale, float keep) {
  const int per = D / 8;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = i / per;  // (b, t, n)
  const int c = (int)(i % per) * 8;
  const bool ok = row < (long long)B * T * N;
  const long long n = row % N, bt = row / N, t = bt % T, b = bt / T;
  float acc = 0.f;
  if (ok) {
    const long long at = row * D + c;  // the contiguous tensors
    uint4 vd = *reinterpret_cast<const uint4*>(dout + at);
    const uint4 vo = *reinterpret_cast<const uint4*>(out + at);
    uint4 vq = *reinterpret_cast<const uint4*>(q + b * sbq + t * stq + n * D + c);
    uint4 vk = *reinterpret_cast<const uint4*>(k + b * sbk + t * stk + n * D + c);
    __nv_bfloat162* hd = reinterpret_cast<__nv_bfloat162*>(&vd);
    const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&vo);
    __nv_bfloat162* hq = reinterpret_cast<__nv_bfloat162*>(&vq);
    __nv_bfloat162* hk = reinterpret_cast<__nv_bfloat162*>(&vk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(hd[j]), o = __bfloat1622float2(ho[j]);
      const float x0 = x.x / keep, x1 = x.y / keep;
      acc = fmaf(x1, o.y, fmaf(x0, o.x, acc));
      hd[j] = __floats2bfloat162_rn(x0, x1);
      const float2 fq = __bfloat1622float2(hq[j]), fk = __bfloat1622float2(hk[j]);
      hq[j] = __floats2bfloat162_rn(fq.x * scale, fq.y * scale);
      hk[j] = __floats2bfloat162_rn(fk.x * scale, fk.y * scale);
    }
    *reinterpret_cast<uint4*>(dos + at) = vd;
    *reinterpret_cast<uint4*>(qs + at) = vq;
    *reinterpret_cast<uint4*>(ks + at) = vk;
  }
  for (int off = per / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (ok && c == 0) di[(b * N + n) * T + t] = keep * acc;
}

// The CTA of both tile kernels: kConsumers warpgroups of 64 resident rows
// each, then the producer warp. Registers bind the shape: a CTA of 13 warps
// puts 4 on one of the SM's four schedulers, whose 16 K registers leave 128 a
// thread; 9 warps leave 168. So three consumers at D <= 64 (dk/dv's four
// accumulators fit 128 registers with a walk of 32 queries a tile), two at
// D = 128, one at D = 256 (5 warps: up to 255 a thread). At D = 256 dk and dv
// of 64 x 256 f32 would be 256 registers a thread, so a dk/dv CTA computes
// one half of their columns (kOut = 128: 64 + 64 registers), and recomputes
// S^T and dP^T, which contract over all of D, for each half; the dq kernel
// keeps all 256 columns (128 registers) and walks 32 keys a tile.
template <int D>
struct BwdCta {
  static constexpr int kConsumers = D == 256 ? 1 : D == 128 ? 2 : 3;
  static constexpr int kRows = 64 * kConsumers;  // resident rows
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kOut = D == 256 ? 128 : D;  // dk / dv columns a CTA
};

// queries a tile of the dk/dv kernel's walk, keys a tile of the dq kernel's
constexpr int kDkdvWalk = 32;
template <int D>
constexpr int dq_walk() {
  return D == 256 ? 32 : 64;
}

// Byte offsets from the 1024-aligned base: the resident K and V tiles, the
// stages of qs and do', the stages of lse and Di ([stage][W] each), the
// mbarriers (the resident tiles', full[stage], empty[stage]).
template <int D>
struct DkdvSmem {
  static constexpr int kStages = 4;
  static constexpr int W = kDkdvWalk;
  static constexpr int kTile = W * D * 2;  // one walked stage of qs or do'
  static constexpr int kK = 0;
  static constexpr int kV = kK + BwdCta<D>::kRows * D * 2;
  static constexpr int kQ = kV + BwdCta<D>::kRows * D * 2;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kRows = kDo + kStages * kTile;
  static constexpr int kBars = kRows + kStages * 2 * W * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

// The resident qs and do' tiles, the stages of K, V and ks, the stages of the
// key bias, the mbarriers.
template <int D>
struct DqSmem {
  static constexpr int kStages = D >= 128 ? 3 : 4;
  static constexpr int kDqWalk = dq_walk<D>();
  static constexpr int kTile = kDqWalk * D * 2;  // one walked stage of K, V or ks
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + BwdCta<D>::kRows * D * 2;
  static constexpr int kK = kDo + BwdCta<D>::kRows * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kKs = kV + kStages * kTile;
  static constexpr int kBias = kKs + kStages * kTile;
  static constexpr int kBars = kBias + kStages * kDqWalk * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

// The mbarriers of a tile kernel at `bars`: the resident tiles' (one arrival,
// with the bytes), then full[stage] (the producer's 32 lanes and lane 0's TMA
// bytes) and empty[stage] (every consumer thread).
template <int STAGES, int CONSUMERS>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    hp::mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(bars + 8u * (1 + s), 32);
      hp::mbar_init(bars + 8u * (1 + STAGES + s), 128 * CONSUMERS);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
}

// The resident tiles of the CTA: ROWS rows from `rows0` of the operands of
// `maps` into dst[o] (panels of ROWS rows), on one mbarrier.
template <int D, int ROWS, int NOPS>
__device__ __forceinline__ void load_resident(const CUtensorMap* const (&maps)[NOPS],
                                              const uint32_t (&dst)[NOPS], uint32_t bar,
                                              int n, int rows0, int b) {
  using P = hp::Panels<D>;
  constexpr int kRows = ROWS;
  hp::mbar_arrive_expect_tx(bar, NOPS * kRows * D * 2);
#pragma unroll
  for (int o = 0; o < NOPS; ++o)
#pragma unroll
    for (int p = 0; p < P::kCount; ++p)
      hp::tma_load_4d(dst[o] + p * kRows * P::kRowBytes, maps[o], bar, p * P::kCols, n, rows0,
                      b);
}

template <int D, bool DROPOUT, int FORM>
__global__ void __launch_bounds__(BwdCta<D>::kThreads, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tqs,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ kbias, const float* __restrict__ lse,
                           const float* __restrict__ di, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int T, int N, Mask mask) {
  using P = hp::Panels<D>;
  using S = DkdvSmem<D>;
  using C = BwdCta<D>;
  constexpr int W = S::W;
  constexpr int DO = C::kOut;  // dk / dv columns of this CTA
  constexpr uint32_t kResPanel = C::kRows * P::kRowBytes, kWalkPanel = W * P::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const fb::AlignedSmem sm = fb::align_smem(smem_raw);
  const uint32_t bars = sm.addr + S::kBars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + S::kStages + s); };
  float* rows_s = reinterpret_cast<float*>(sm.ptr + S::kRows);

  // blockIdx.y: head n and, where DO < D, which DO columns of dk and dv
  const int k0 = blockIdx.x * C::kRows, n = blockIdx.y / (D / DO), b = blockIdx.z;
  const int col0 = (blockIdx.y % (D / DO)) * DO;
  // the walked tiles' panel of column col0 (panels of P::kCols columns)
  const uint32_t col_at = (col0 / P::kCols) * kWalkPanel;
  const int n_tiles = (T + W - 1) / W;
  const long long bn_row = ((long long)b * N + n) * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_bars<S::kStages, C::kConsumers>(bars);

  if (warp == 4 * C::kConsumers) {  // the producer warp
    if (lane == 0) {
      const CUtensorMap* maps[2] = {&tk, &tv};
      const uint32_t dst[2] = {sm.addr + S::kK, sm.addr + S::kV};
      load_resident<D, C::kRows, 2>(maps, dst, bars, n, k0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % S::kStages, q0 = i * W;
      if (i >= S::kStages) hp::mbar_wait(empty(s), (i / S::kStages - 1) & 1);
      if (lane == 0) {
        hp::mbar_expect_tx(full(s), 2 * S::kTile);
        for (int p = 0; p < P::kCount; ++p) {
          const int at = s * S::kTile + p * kWalkPanel;
          hp::tma_load_4d(sm.addr + S::kQ + at, &tqs, full(s), p * P::kCols, n, q0, b);
          hp::tma_load_4d(sm.addr + S::kDo + at, &tdo, full(s), p * P::kCols, n, q0, b);
        }
      }
      for (int c = lane; c < W; c += 32) {
        const int t = q0 + c;
        rows_s[s * 2 * W + c] = t < T ? lse[bn_row + t] : INFINITY;  // queries >= T: p = 0
        rows_s[s * 2 * W + W + c] = t < T ? di[bn_row + t] : 0.f;
      }
      hp::mbar_arrive(full(s));
    }
    return;
  }

  // a consumer warpgroup: keys k0 + 64 wg ..; this thread's accumulator rows
  // are keys ka and ka + 8
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int ka = k0 + wg * 64 + (warp & 3) * 16 + g;
  const float kb[2] = {fb::key_bias(kbias, b, ka, T), fb::key_bias(kbias, b, ka + 8, T)};
  const uint32_t k_tile = sm.addr + S::kK + wg * 64 * P::kRowBytes;
  const uint32_t v_tile = sm.addr + S::kV + wg * 64 * P::kRowBytes;
  MaskRows<FORM> mrows(mask, b, n);

  float dk_acc[DO / 2], dv_acc[DO / 2];
#pragma unroll
  for (int r = 0; r < DO / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;
  hp::mbar_wait(bars, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S::kStages, q0 = i * W;
    const uint32_t q_tile = sm.addr + S::kQ + s * S::kTile;
    const uint32_t do_tile = sm.addr + S::kDo + s * S::kTile;
    hp::mbar_wait(full(s), (i / S::kStages) & 1);

    // s^T = k qs^T and dp^T = v do'^T: 64 keys x W queries
    float st[W / 2], dpt[W / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_ss<W, 0>(st, P::kmajor(k_tile, kResPanel, kk), P::kmajor(q_tile, kWalkPanel, kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_ss<W, 0>(dpt, P::kmajor(v_tile, kResPanel, kk),
                         P::kmajor(do_tile, kWalkPanel, kk), kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(st);
    hp::fence_regs(dpt);

    // element 4 j + e: key ka + 8 (e / 2), query q0 + 8 j + 2 t4 + e % 2; the
    // dropped p and ds, rounded to bf16, are the A registers of the products
    const float* ls = rows_s + s * 2 * W;
    const float* dd = ls + W;
    uint32_t pa[W / 16][4], dsa[W / 16][4];
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int ql = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(dd + ql);
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(st[4 * j + e] + kb[e >> 1] - ((e & 1) ? l2.y : l2.x));
        const bool kept = !DROPOUT || mrows.at(q0 + ql + (e & 1)).keep(ka + 8 * (e >> 1));
        pd[e] = kept ? p : 0.f;
        ds[e] = p * ((kept ? dpt[4 * j + e] : 0.f) - ((e & 1) ? d2.y : d2.x));
      }
      pa[j >> 1][2 * (j & 1)] = hp::pack_bf16(pd[0], pd[1]);
      pa[j >> 1][2 * (j & 1) + 1] = hp::pack_bf16(pd[2], pd[3]);
      dsa[j >> 1][2 * (j & 1)] = hp::pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][2 * (j & 1) + 1] = hp::pack_bf16(ds[2], ds[3]);
    }

    // dv += bf16(pd)^T do' and dk += bf16(ds)^T qs over the tile's W queries
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      hp::wgmma_rs<DO, 1>(dv_acc, pa[kk], P::mnmajor(do_tile + col_at, kWalkPanel, kk), 1);
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      hp::wgmma_rs<DO, 1>(dk_acc, dsa[kk], P::mnmajor(q_tile + col_at, kWalkPanel, kk), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv_acc);
    hp::fence_regs(dk_acc);
    hp::mbar_arrive(empty(s));
  }

  const int H = N * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = ka + 8 * h;
    if (t >= T) continue;
    const long long o = ((long long)b * T + t) * H + (long long)n * D + col0 + 2 * t4;
#pragma unroll
    for (int c = 0; c < DO / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * c) =
          __floats2bfloat162_rn(dk_acc[4 * c + 2 * h], dk_acc[4 * c + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * c) =
          __floats2bfloat162_rn(dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
    }
  }
}

template <int D, bool DROPOUT, int FORM>
__global__ void __launch_bounds__(BwdCta<D>::kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tqs,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tks,
                         const float* __restrict__ kbias, const float* __restrict__ lse,
                         const float* __restrict__ di, bf16* __restrict__ dq, int T, int N,
                         Mask mask) {
  using P = hp::Panels<D>;
  using S = DqSmem<D>;
  using C = BwdCta<D>;
  constexpr int W = S::kDqWalk;
  constexpr uint32_t kResPanel = C::kRows * P::kRowBytes, kWalkPanel = W * P::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const fb::AlignedSmem sm = fb::align_smem(smem_raw);
  const uint32_t bars = sm.addr + S::kBars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + S::kStages + s); };
  float* bias_s = reinterpret_cast<float*>(sm.ptr + S::kBias);

  const int q0 = blockIdx.x * C::kRows, n = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T + W - 1) / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_bars<S::kStages, C::kConsumers>(bars);

  if (warp == 4 * C::kConsumers) {  // the producer warp
    if (lane == 0) {
      const CUtensorMap* maps[2] = {&tqs, &tdo};
      const uint32_t dst[2] = {sm.addr + S::kQ, sm.addr + S::kDo};
      load_resident<D, C::kRows, 2>(maps, dst, bars, n, q0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % S::kStages, k0 = i * W;
      if (i >= S::kStages) hp::mbar_wait(empty(s), (i / S::kStages - 1) & 1);
      if (lane == 0) {
        hp::mbar_expect_tx(full(s), 3 * S::kTile);
        for (int p = 0; p < P::kCount; ++p) {
          const int at = s * S::kTile + p * kWalkPanel;
          hp::tma_load_4d(sm.addr + S::kK + at, &tk, full(s), p * P::kCols, n, k0, b);
          hp::tma_load_4d(sm.addr + S::kV + at, &tv, full(s), p * P::kCols, n, k0, b);
          hp::tma_load_4d(sm.addr + S::kKs + at, &tks, full(s), p * P::kCols, n, k0, b);
        }
      }
      for (int c = lane; c < W; c += 32) {
        const int t = k0 + c;
        bias_s[s * W + c] = fb::key_bias(kbias, b, t, T);
      }
      hp::mbar_arrive(full(s));
    }
    return;
  }

  // a consumer warpgroup: queries q0 + 64 wg ..; this thread's accumulator
  // rows are queries qa and qa + 8
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int qa = q0 + wg * 64 + (warp & 3) * 16 + g;
  const long long bn_row = ((long long)b * N + n) * T;
  const float lse_r[2] = {qa < T ? lse[bn_row + qa] : INFINITY,  // queries >= T: p = 0
                          qa + 8 < T ? lse[bn_row + qa + 8] : INFINITY};
  const float di_r[2] = {qa < T ? di[bn_row + qa] : 0.f, qa + 8 < T ? di[bn_row + qa + 8] : 0.f};
  MaskRows<FORM> mrows(mask, b, n);
  const MaskRow<FORM> mrow[2] = {mrows.at(qa), mrows.at(qa + 8)};
  const uint32_t q_tile = sm.addr + S::kQ + wg * 64 * P::kRowBytes;
  const uint32_t do_tile = sm.addr + S::kDo + wg * 64 * P::kRowBytes;

  float dq_acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dq_acc[r] = 0.f;
  hp::mbar_wait(bars, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S::kStages, k0 = i * W;
    const uint32_t k_tile = sm.addr + S::kK + s * S::kTile;
    const uint32_t v_tile = sm.addr + S::kV + s * S::kTile;
    const uint32_t ks_tile = sm.addr + S::kKs + s * S::kTile;
    hp::mbar_wait(full(s), (i / S::kStages) & 1);

    // s = qs k^T and dp = do' v^T: 64 queries x 64 keys
    float sc[W / 2], dp[W / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_ss<W, 0>(sc, P::kmajor(q_tile, kResPanel, kk), P::kmajor(k_tile, kWalkPanel, kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_ss<W, 0>(dp, P::kmajor(do_tile, kResPanel, kk),
                         P::kmajor(v_tile, kWalkPanel, kk), kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    // element 4 j + e: query qa + 8 (e / 2), key k0 + 8 j + 2 t4 + e % 2
    const float* kb = bias_s + s * W;
    uint32_t dsa[W / 16][4];
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int kl = 8 * j + 2 * t4;
      const float2 b2 = *reinterpret_cast<const float2*>(kb + kl);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[4 * j + e] + ((e & 1) ? b2.y : b2.x) - lse_r[e >> 1]);
        const bool kept =
            !DROPOUT || mrow[e >> 1].keep(k0 + kl + (e & 1));
        ds[e] = p * ((kept ? dp[4 * j + e] : 0.f) - di_r[e >> 1]);
      }
      dsa[j >> 1][2 * (j & 1)] = hp::pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][2 * (j & 1) + 1] = hp::pack_bf16(ds[2], ds[3]);
    }

    // dq += bf16(ds) ks over the tile's 64 keys
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      hp::wgmma_rs<D, 1>(dq_acc, dsa[kk], P::mnmajor(ks_tile, kWalkPanel, kk), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dq_acc);
    hp::mbar_arrive(empty(s));
  }

  const int H = N * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = qa + 8 * h;
    if (t >= T) continue;
    const long long o = ((long long)b * T + t) * H + (long long)n * D + 2 * t4;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dq + o + 8 * c) =
          __floats2bfloat162_rn(dq_acc[4 * c + 2 * h], dq_acc[4 * c + 2 * h + 1]);
  }
}

// strides: (batch, time) of q, k and v in elements
template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* kbias,
                const bf16* out, const bf16* dout, const float* lse, float* di, bf16* qs,
                bf16* ks, bf16* dos, bf16* dq, bf16* dk, bf16* dv, int B, int T, int N,
                const long long* strides, float scale, float keep, const Mask& mask,
                int dropout, int form, cudaStream_t stream) {
  cudaError_t err;
  const long long threads = (long long)B * T * N * (D / 8);
  flash_bwd_prep_bf16_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                               stream>>>(q, k, dout, out, di, qs, ks, dos, B, T, N, D,
                                         strides[0], strides[1], strides[2], strides[3],
                                         scale, keep);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // the scratch tensors are contiguous (B, T, N * D)
  const long long sb = (long long)T * N * D, st = (long long)N * D;
  CUtensorMap m_k, m_v, m_qs, m_do, m_qs_res, m_do_res, m_k_walk, m_v_walk, m_ks;
  int e = 0;
  constexpr int R = BwdCta<D>::kRows;
  if ((e = fb::encode_heads<D>(&m_k, k, B, T, N, strides[2], strides[3], R)) ||
      (e = fb::encode_heads<D>(&m_v, v, B, T, N, strides[4], strides[5], R)) ||
      (e = fb::encode_heads<D>(&m_qs, qs, B, T, N, sb, st, kDkdvWalk)) ||
      (e = fb::encode_heads<D>(&m_do, dos, B, T, N, sb, st, kDkdvWalk)) ||
      (e = fb::encode_heads<D>(&m_qs_res, qs, B, T, N, sb, st, R)) ||
      (e = fb::encode_heads<D>(&m_do_res, dos, B, T, N, sb, st, R)) ||
      (e = fb::encode_heads<D>(&m_k_walk, k, B, T, N, strides[2], strides[3], dq_walk<D>())) ||
      (e = fb::encode_heads<D>(&m_v_walk, v, B, T, N, strides[4], strides[5], dq_walk<D>())) ||
      (e = fb::encode_heads<D>(&m_ks, ks, B, T, N, sb, st, dq_walk<D>())))
    return e;

  const int smem_dkdv = DkdvSmem<D>::kBytes + 1024;  // + the alignment of the base
  const int smem_dq = DqSmem<D>::kBytes + 1024;
  auto dkdv = flash_bwd_dkdv_bf16_kernel<D, false, kMaskHash>;
  auto dq_kernel = flash_bwd_dq_bf16_kernel<D, false, kMaskHash>;
  if (dropout && form == kMaskFlax) {
    dkdv = flash_bwd_dkdv_bf16_kernel<D, true, kMaskFlax>;
    dq_kernel = flash_bwd_dq_bf16_kernel<D, true, kMaskFlax>;
  } else if (dropout && form == kMaskHiddenHash) {
    dkdv = flash_bwd_dkdv_bf16_kernel<D, true, kMaskHiddenHash>;
    dq_kernel = flash_bwd_dq_bf16_kernel<D, true, kMaskHiddenHash>;
  } else if (dropout) {
    dkdv = flash_bwd_dkdv_bf16_kernel<D, true, kMaskHash>;
    dq_kernel = flash_bwd_dq_bf16_kernel<D, true, kMaskHash>;
  }
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_dkdv)) != cudaSuccess)
    return (int)err;
  // the dk/dv kernel's blockIdx.y also picks its columns (BwdCta::kOut)
  dkdv<<<dim3((T + R - 1) / R, N * (D / BwdCta<D>::kOut), B), BwdCta<D>::kThreads, smem_dkdv,
         stream>>>(
      m_k, m_v, m_qs, m_do, kbias, lse, di, dk, dv, T, N, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_dq)) != cudaSuccess)
    return (int)err;
  dq_kernel<<<dim3((T + R - 1) / R, N, B), BwdCta<D>::kThreads, smem_dq, stream>>>(
      m_qs_res, m_do_res, m_k_walk, m_v_walk, m_ks, kbias, lse, di, dq, T, N, mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {


// Kernel B3 bwd: three launches on `stream` of `device`; returns the first
// launch error (0 on success); does not synchronise. di is (B, N, T) f32
// scratch the caller allocates. D, thresh, dropout and the mask (form, s0,
// s1, chunk, batch0, head0, n_total) as for flash_attn_fwd_f32; inv_keep = 1 / (1 - rate). dq, dk and dv must be
// 8-byte aligned (they are whole allocations).
int flash_attn_bwd_f32(const void* q, const void* k, const void* v, const void* kbias,
                       const void* out, const void* dout, const void* lse, void* di, void* dq,
                       void* dk, void* dv, int B, int T, int N, int D, long long sb,
                       long long st, float scale, float inv_keep, unsigned thresh,
                       unsigned s0, unsigned s1, int batch0, int head0, int n_total, int dropout,
                       int form, int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  const flash::Mask mask{s0, s1, thresh, chunk, T, flash::HeadKey{batch0, head0, n_total}};
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(c(q), c(k), c(v), c(kbias), c(out), c(dout), c(lse), m(di), m(dq),
                        m(dk), m(dv), B, T, N, sb, st, scale, inv_keep, mask, dropout,
                        form, s);
    case 64:
      return launch<64>(c(q), c(k), c(v), c(kbias), c(out), c(dout), c(lse), m(di), m(dq),
                        m(dk), m(dv), B, T, N, sb, st, scale, inv_keep, mask, dropout,
                        form, s);
    case 128:
      return launch<128>(c(q), c(k), c(v), c(kbias), c(out), c(dout), c(lse), m(di), m(dq),
                         m(dk), m(dv), B, T, N, sb, st, scale, inv_keep, mask, dropout,
                         form, s);
    case 256:
      return launch<256>(c(q), c(k), c(v), c(kbias), c(out), c(dout), c(lse), m(di), m(dq),
                         m(dk), m(dv), B, T, N, sb, st, scale, inv_keep, mask, dropout,
                         form, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel B3 bwd in bf16: three launches on `stream` of `device`; returns
// the first launch error (0 on success); does not synchronise. q, k, v, out,
// dout, dq, dk and dv are bf16, kbias (null: no bias) and lse f32; di (B, N,
// T) f32 and qs, ks, dos (B, T, N * D) bf16 are scratch the caller
// allocates. The strides are (batch, time) of q, k and v each, in elements,
// every one a multiple of 8, and q, k, v are 16-byte aligned (TMA's terms:
// the wrapper's tma_ready).
// `scale` is the softmax scale already rounded to bf16 and keep = 1 - rate;
// the other arguments as for flash_attn_bwd_f32.
int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* kbias,
                        const void* out, const void* dout, const void* lse, void* di,
                        void* qs, void* ks, void* dos, void* dq, void* dk, void* dv, int B,
                        int T, int N, int D, long long sbq, long long stq, long long sbk,
                        long long stk, long long sbv, long long stv, float scale, float keep,
                        unsigned thresh, unsigned s0, unsigned s1, int batch0, int head0,
                        int n_total, int dropout, int form, int chunk, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  const flash::Mask mask{s0, s1, thresh, chunk, T, flash::HeadKey{batch0, head0, n_total}};
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  auto cf = static_cast<const float*>(kbias);
  auto lf = static_cast<const float*>(lse);
  auto df = static_cast<float*>(di);
  auto s = static_cast<cudaStream_t>(stream);
  const long long strides[6] = {sbq, stq, sbk, stk, sbv, stv};
  switch (D) {
    case 32:
      return launch_bf16<32>(c(q), c(k), c(v), cf, c(out), c(dout), lf, df, m(qs), m(ks),
                             m(dos), m(dq), m(dk), m(dv), B, T, N, strides, scale, keep,
                             mask, dropout, form, s);
    case 64:
      return launch_bf16<64>(c(q), c(k), c(v), cf, c(out), c(dout), lf, df, m(qs), m(ks),
                             m(dos), m(dq), m(dk), m(dv), B, T, N, strides, scale, keep,
                             mask, dropout, form, s);
    case 128:
      return launch_bf16<128>(c(q), c(k), c(v), cf, c(out), c(dout), lf, df, m(qs), m(ks),
                              m(dos), m(dq), m(dk), m(dv), B, T, N, strides, scale, keep,
                              mask, dropout, form, s);
    case 256:
      return launch_bf16<256>(c(q), c(k), c(v), cf, c(out), c(dout), lf, df, m(qs), m(ks),
                              m(dos), m(dq), m(dk), m(dv), B, T, N, strides, scale, keep,
                              mask, dropout, form, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_bwd_error_string(int code) {
  if (code >= flash_bf16::kMapError) return "cuTensorMapEncodeTiled refused a TMA tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
