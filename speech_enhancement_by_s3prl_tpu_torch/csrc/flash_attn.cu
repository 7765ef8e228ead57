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
// where keep() is the launch's mask form (flash_attn_common.cuh: the JAX
// kernel's salted hash; flax nn.Dropout's threefry draw; the JAX hidden-state
// hash; the last two also in the chunked path's per-chunk keys) at the
// absolute head bn = (batch0 + b) * N_total + head0 + n (HeadKey), so the
// mask is the JAX package's bit for bit whatever the tiling, and a launch on
// heads [head0, head0 + N) of N_total draws those heads' masks.
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

#include "flash_attn_bf16.cuh"
#include "flash_attn_common.cuh"
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

// FORM: the mask form (flash_attn_common.cuh), drawn where dropout != 0
template <int D, int FORM>
__global__ void __launch_bounds__(kTileThreads, D <= 64 ? 3 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kbias,
                 float* __restrict__ out, float* __restrict__ lse, int T, int N,
                 long long sb, long long st, float scale, float keep, Mask mask, int dropout,
                 int vec) {
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
  MaskRows<FORM> mrows(mask, b, n);
  const MaskRow<FORM> mrow[2] = {mrows.at(q_a), mrows.at(q_a + 8)};

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
        const bool kept = !dropout || mrow[e >> 1].keep(k0 + 8 * j + 2 * t4 + (e & 1));
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
           float keep, const Mask& mask, int dropout, int form, cudaStream_t stream) {
  // without dropout the mask is not drawn: the hash instance serves
  auto kernel = flash_fwd_kernel<D, kMaskHash>;
  if (dropout && form == kMaskFlax) kernel = flash_fwd_kernel<D, kMaskFlax>;
  if (dropout && form == kMaskHiddenHash) kernel = flash_fwd_kernel<D, kMaskHiddenHash>;
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte tile loads where every row start is 16-byte aligned
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && sb % 4 == 0 && st % 4 == 0;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  kernel<<<grid, kTileThreads, smem, stream>>>(q, k, v, kbias, out, lse, T, N, sb, st, scale,
                                               keep, mask, dropout, vec);
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
// walked so far (64 a tile), the JAX kernel against the row's final one, so
// the bf16 roundings of p (and through them out) differ by an ulp here and
// there.
//
// Bound on this card. The two products are 18.5 GFLOP at B=6, T=1001,
// 12 x 64: 0.0187 ms at 989 TFLOP/s, against 0.04 GB moved. But each of the
// 72.1 M logits also takes one exponential and the hash's ten integer
// operations on the CUDA cores, more issue slots than the products take
// tensor-core time at D = 64: the CUDA cores bind it, and the design overlaps
// the products with that work rather than the other way round.
//
// Design (Hopper). One CTA of 288 threads per (128-query tile, head, batch):
// two consumer warpgroups of 64 queries each and one producer warp. The
// producer brings the query tile in once by TMA and then walks K and V, 64
// keys a tile, through a ring of five stages of shared memory, each guarded
// by a full and an empty mbarrier; lane 0 issues a stage's TMA loads first,
// then every lane writes its share of the stage's key bias (-inf at keys >=
// T) beside the tiles and arrives. TMA reads the strided (B, T, N * D) views as
// 4-D tensors and fills rows t >= T with zeros. Each consumer warpgroup first
// rounds its 64 query rows to bf16(scale q) in place (elementwise, so the
// swizzle does not matter), fences the async proxy and syncs on a named
// barrier; then per key tile:
//   - S = bf16(scale q) K^T: D / 16 SS wgmma m64n64k16, both operands K-major
//     from shared memory;
//   - on S's accumulator registers: the bias, the online softmax (row maxima
//     across the four lanes of a row by shuffles, each lane's share of the
//     row sum; p = exp(s - m) by __expf, ex2.approx: two instructions where
//     expf takes nine, within the card's limits), the keep bits from each
//     element's absolute (head, query, key) in the wgmma register layout, p
//     rounded to bf16 and packed into the A registers of the next product;
//   - O = alpha O + P V: 4 RS wgmma m64nDk16 with V's [key][d] tile read
//     MN-major; then the warpgroup frees the stage.
// The two warpgroups run unsynchronised, so one's softmax and hash run while
// the other's products are in the tensor cores. Registers bind the shape:
// two CTAs of 9 warps an SM put 5 on one of the SM's four schedulers, whose
// 16 K registers leave 96 a thread (D <= 64), which the 64-key tile fits (32
// S, 32 O and 16 P registers at D = 64); D = 128 runs one CTA an SM (168). The kernel is compiled with and without the hash (a runtime
// flag inside the loop split it into short branches).

namespace hp = hopper;
namespace fb = flash_bf16;
using bf16 = __nv_bfloat16;

constexpr int kFwdQ = 128;        // queries a CTA: two consumer warpgroups of 64
constexpr int kFwdThreads = 288;  // the consumer warpgroups, then the producer warp

// Keys a walked tile and the ring of K, V and key-bias stages. At D = 256 the
// O accumulator alone is 128 registers a thread (of the 224 that 9 warps an
// SM leave), so the tile is 32 keys (16 S and 8 P registers, not 32 and 16),
// and four stages of it fit beside the 64 KB query tile.
template <int D>
struct FwdCfg {
  static constexpr int kKeys = D == 256 ? 32 : 64;
  static constexpr int kStages = D == 256 ? 4 : 5;
};

// Byte offsets from the 1024-aligned base of dynamic shared memory: the query
// tile (raw q, then bf16(scale q)), the K and V stages, the key-bias stages
// and the mbarriers (the query tile's, full[stage], empty[stage]).
template <int D>
struct FwdSmem {
  static constexpr int kKeys = FwdCfg<D>::kKeys;
  static constexpr int kStages = FwdCfg<D>::kStages;
  static constexpr int kTile = kKeys * D * 2;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kFwdQ * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBias = kV + kStages * kTile;
  static constexpr int kBars = kBias + kStages * kKeys * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

// DROPOUT: rate > 0, the mask of form FORM compiled in (a flag tested inside
// the loop would split it into short branches the scheduler cannot
// interleave)
template <int D, bool DROPOUT, int FORM>
__global__ void __launch_bounds__(kFwdThreads, D <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const float* __restrict__ kbias,
                      bf16* __restrict__ out, float* __restrict__ lse, int T, int N,
                      float scale, float keep, Mask mask) {
  using P = hp::Panels<D>;
  using S = FwdSmem<D>;
  constexpr int kFwdK = S::kKeys, kFwdStages = S::kStages;
  constexpr uint32_t kQPanel = kFwdQ * P::kRowBytes, kKPanel = kFwdK * P::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const fb::AlignedSmem sm = fb::align_smem(smem_raw);
  const uint32_t bar_q = sm.addr + S::kBars;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + kFwdStages + s); };
  float* bias_s = reinterpret_cast<float*>(sm.ptr + S::kBias);

  const int q0 = blockIdx.x * kFwdQ, n = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (T + kFwdK - 1) / kFwdK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hp::mbar_init(bar_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      hp::mbar_init(full(s), 32);    // the producer's lanes (and lane 0's TMA bytes)
      hp::mbar_init(empty(s), 256);  // every consumer thread
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp
    if (lane == 0) {
      hp::mbar_arrive_expect_tx(bar_q, kFwdQ * D * 2);
      for (int p = 0; p < P::kCount; ++p)
        hp::tma_load_4d(sm.addr + S::kQ + p * kQPanel, &tq, bar_q, p * P::kCols, n, q0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kFwdStages, k0 = i * kFwdK;
      if (i >= kFwdStages) hp::mbar_wait(empty(s), (i / kFwdStages - 1) & 1);
      if (lane == 0) {
        hp::mbar_expect_tx(full(s), 2 * S::kTile);
        for (int p = 0; p < P::kCount; ++p) {
          const int at = s * S::kTile + p * kKPanel;
          hp::tma_load_4d(sm.addr + S::kK + at, &tk, full(s), p * P::kCols, n, k0, b);
          hp::tma_load_4d(sm.addr + S::kV + at, &tv, full(s), p * P::kCols, n, k0, b);
        }
      }
      for (int c = lane; c < kFwdK; c += 32) {
        const int t = k0 + c;
        bias_s[s * kFwdK + c] = fb::key_bias(kbias, b, t, T);
      }
      hp::mbar_arrive(full(s));
    }
    return;
  }

  // a consumer warpgroup: queries q0 + 64 wg ..; this thread's accumulator
  // rows are queries qa and qa + 8
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int qa = q0 + wg * 64 + (warp & 3) * 16 + g;
  const uint32_t q_tile = sm.addr + S::kQ + wg * 64 * P::kRowBytes;

  hp::mbar_wait(bar_q, 0);
  for (int p = 0; p < P::kCount; ++p) {
    uint4* rows = reinterpret_cast<uint4*>(sm.ptr + S::kQ + p * kQPanel + wg * 64 * P::kRowBytes);
    for (int c = threadIdx.x & 127; c < 64 * P::kRowBytes / 16; c += 128) {
      uint4 x = rows[c];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      rows[c] = x;
    }
  }
  hp::fence_proxy_async();
  hp::named_sync(1 + wg, 128);

  MaskRows<FORM> mrows(mask, b, n);
  const MaskRow<FORM> mrow[2] = {mrows.at(qa), mrows.at(qa + 8)};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float o[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) o[r] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kFwdStages, k0 = i * kFwdK;
    const uint32_t k_tile = sm.addr + S::kK + s * S::kTile;
    const uint32_t v_tile = sm.addr + S::kV + s * S::kTile;
    hp::mbar_wait(full(s), (i / kFwdStages) & 1);

    // S = bf16(scale q) k^T: 64 queries x 64 keys
    float sc[kFwdK / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_ss<kFwdK, 0>(sc, P::kmajor(q_tile, kQPanel, kk),
                             P::kmajor(k_tile, kKPanel, kk), kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);

    // the key bias and the online softmax in f32; element 4 j + e is query
    // qa + 8 (e / 2), key k0 + 8 j + 2 t4 + e % 2
    const float* kb = bias_s + s * kFwdK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kFwdK / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(kb + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] += (e & 1) ? bb.y : bb.x;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
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
    // l sums the undropped p; the dropped p, rounded to bf16, are the A
    // registers of P V (columns 16 kk .. 16 kk + 15 in pa[kk])
    float rs[2] = {0.f, 0.f};
    uint32_t pa[kFwdK / 16][4];
#pragma unroll
    for (int j = 0; j < kFwdK / 8; ++j) {
      float pk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[4 * j + e] - shift[e >> 1]);
        rs[e >> 1] += p;
        const bool kept = !DROPOUT || mrow[e >> 1].keep(k0 + 8 * j + 2 * t4 + (e & 1));
        pk[e] = kept ? p : 0.f;
      }
      pa[j >> 1][2 * (j & 1)] = hp::pack_bf16(pk[0], pk[1]);
      pa[j >> 1][2 * (j & 1) + 1] = hp::pack_bf16(pk[2], pk[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r >> 1) & 1];

    // O += bf16(p) v over the tile's 64 keys
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdK / 16; ++kk)
      hp::wgmma_rs<D, 1>(o, pa[kk], P::mnmajor(v_tile, kKPanel, kk), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    hp::mbar_arrive(empty(s));
  }

  const int H = N * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = qa + 8 * h;
    const float sum = quad_sum(l[h]);  // every lane of the warp shuffles
    if (t >= T) continue;
    const float r = 1.f / (sum * keep);
    bf16* dst = out + ((long long)b * T + t) * H + (long long)n * D + 2 * t4;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2 * h] * r, o[4 * c + 2 * h + 1] * r);
    if (t4 == 0) lse[((long long)b * N + n) * T + t] = m[h] + logf(sum);
  }
}

// strides: (batch, time) of q, k and v in elements
template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* kbias, bf16* out,
                float* lse, int B, int T, int N, const long long* strides, float scale,
                float keep, const Mask& mask, int dropout, int form, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ops[3] = {q, k, v};
  const int rows[3] = {kFwdQ, FwdCfg<D>::kKeys, FwdCfg<D>::kKeys};
  for (int o = 0; o < 3; ++o) {
    const int err = fb::encode_heads<D>(&maps[o], ops[o], B, T, N, strides[2 * o],
                                        strides[2 * o + 1], rows[o]);
    if (err) return err;
  }
  const int smem = FwdSmem<D>::kBytes + 1024;  // + the alignment of the base
  auto kernel = flash_fwd_bf16_kernel<D, false, kMaskHash>;
  if (dropout) {
    kernel = form == kMaskFlax         ? flash_fwd_bf16_kernel<D, true, kMaskFlax>
             : form == kMaskHiddenHash ? flash_fwd_bf16_kernel<D, true, kMaskHiddenHash>
                                       : flash_fwd_bf16_kernel<D, true, kMaskHash>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kFwdQ - 1) / kFwdQ, N, B);
  kernel<<<grid, kFwdThreads, smem, stream>>>(maps[0], maps[1], maps[2], kbias, out, lse, T, N,
                                              scale, keep, mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {


// Kernel B3 fwd. Launches on `stream` of `device` and returns
// cudaGetLastError() (0 on success); does not synchronise. D is 32, 64,
// 128 or 256; keep = 1 - rate and thresh (the hashes: min(int((1 - rate) *
// 2^32), 2^32 - 1); the flax form: ceil(float32(1 - rate) * 2^23)) computed by
// the caller; dropout = 0 draws no mask (rate 0). The mask is of form `form`
// (flash::MaskForm) from the words s0, s1, in chunks of `chunk` queries (0:
// one draw), keyed on flash::HeadKey{batch0, head0, n_total} (a launch on its
// own: 0, 0, N). out must be 8-byte aligned (it is a whole allocation).
int flash_attn_fwd_f32(const void* q, const void* k, const void* v, const void* kbias,
                       void* out, void* lse, int B, int T, int N, int D, long long sb,
                       long long st, float scale, float keep, unsigned thresh, unsigned s0,
                       unsigned s1, int batch0, int head0, int n_total, int dropout, int form,
                       int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  const flash::Mask mask{s0, s1, thresh, chunk, T, flash::HeadKey{batch0, head0, n_total}};
  auto* qf = static_cast<const float*>(q);
  auto* kf = static_cast<const float*>(k);
  auto* vf = static_cast<const float*>(v);
  auto* bf = static_cast<const float*>(kbias);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(qf, kf, vf, bf, of, lf, B, T, N, sb, st, scale, keep, mask, dropout,
                        form, s);
    case 64:
      return launch<64>(qf, kf, vf, bf, of, lf, B, T, N, sb, st, scale, keep, mask, dropout,
                        form, s);
    case 128:
      return launch<128>(qf, kf, vf, bf, of, lf, B, T, N, sb, st, scale, keep, mask, dropout,
                         form, s);
    case 256:
      return launch<256>(qf, kf, vf, bf, of, lf, B, T, N, sb, st, scale, keep, mask, dropout,
                         form, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel B3 fwd in bf16: q, k, v and out bf16, kbias (null: no bias) and lse
// f32, the arguments otherwise as for flash_attn_fwd_f32 but for the strides:
// (batch, time) of q, k and v each, in elements, every one a multiple of 8,
// and q, k, v 16-byte aligned (TMA's terms: the wrapper's tma_ready). `scale`
// is the softmax scale already rounded to bf16. out must be 4-byte aligned (a
// whole allocation).
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* kbias,
                        void* out, void* lse, int B, int T, int N, int D, long long sbq,
                        long long stq, long long sbk, long long stk, long long sbv,
                        long long stv, float scale, float keep, unsigned thresh, unsigned s0,
                        unsigned s1, int batch0, int head0, int n_total, int dropout, int form,
                        int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || N <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  const flash::Mask mask{s0, s1, thresh, chunk, T, flash::HeadKey{batch0, head0, n_total}};
  auto* qb = static_cast<const bf16*>(q);
  auto* kb = static_cast<const bf16*>(k);
  auto* vb = static_cast<const bf16*>(v);
  auto* bf = static_cast<const float*>(kbias);
  auto* ob = static_cast<bf16*>(out);
  auto* lf = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  const long long strides[6] = {sbq, stq, sbk, stk, sbv, stv};
  switch (D) {
    case 32:
      return launch_bf16<32>(qb, kb, vb, bf, ob, lf, B, T, N, strides, scale, keep, mask,
                             dropout, form, s);
    case 64:
      return launch_bf16<64>(qb, kb, vb, bf, ob, lf, B, T, N, strides, scale, keep, mask,
                             dropout, form, s);
    case 128:
      return launch_bf16<128>(qb, kb, vb, bf, ob, lf, B, T, N, strides, scale, keep, mask,
                              dropout, form, s);
    case 256:
      return launch_bf16<256>(qb, kb, vb, bf, ob, lf, B, T, N, strides, scale, keep, mask,
                              dropout, form, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int code) {
  if (code >= flash_bf16::kMapError) return "cuTensorMapEncodeTiled refused a TMA tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
