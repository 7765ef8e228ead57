// Reverse-time backward of the time-major LSTM recurrence, f32, for Hopper
// (kernel B2 bwd).
//
// Replaces: speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py,
//   _tm_bwd / _kernel_tm_bwd (the VJP of lstm_bidir_tm that every recurrent
//   layer of the train step runs).
//
// Inputs, all (ndir, ...) over the direction axis (1 or 2) as the forward
// kernels lay them out: xw (ndir, B, T, 4H), w_hh_t (ndir, H, 4H), the
// forward's hs and cs (ndir, B, T, H) and the cotangent dhs (ndir, B, T, H).
// Outputs dxw (ndir, B, T, 4H) and dw_hh_t (ndir, H, 4H). For each direction
// and each step tt = T-1 .. 0:
//   gates = xw_tt + h_{tt-1} @ W_hh^T        (recomputed, i, f, g, o)
//   dh  = dhs_tt + dh_carry;  do = dh * tanh(c_tt)
//   dct = dh * o * (1 - tanh(c_tt)^2) + dc_carry
//   da  = [dct*g * i(1-i), dct*c_{tt-1} * f(1-f), dct*i * (1-g^2), do * o(1-o)]
//   dxw_tt = da;  dh_carry = da @ W_hh;  dc_carry = dct * f
//   dW_hh^T += h_{tt-1}^T da
// with h_{-1} = c_{-1} = 0 and both carries zero at tt = T-1. Nothing is
// clamped: a NaN in xw, cs or dhs reaches dxw through the cell's backward, so
// the train step's non-finite guard sees it.
//
// What bounds it on this card: of the three products of a step only
// dh_carry = da_{tt+1} @ W_hh depends on the step before. The gates read the
// forward's hs and dW_hh^T reads hs and the finished dxw: both are plain
// products over all B * T rows at once, work for the tensor cores. What stays
// sequential is T dependent steps of one small product each, bound by the
// latency of a step: the exchange between the SMs that share one direction's
// W_hh (1 MiB at H = 256, more than one SM's shared memory) and the reading
// of the resident weights from shared memory.
//
// Design (the route for H a multiple of 8 up to 256): three phases behind one
// entry, no atomics, the same bits on every run.
//   1. lstm_bwd_gates_kernel (parallel over the B * T rows): gates = xw_t +
//      h_{t-1} @ W_hh^T as a tiled product on the tensor cores in three
//      split-TF32 passes (mma_tf32x3.cuh; a fresh accumulator a 32-deep slice
//      of H, summed with f32 additions), the four activations applied, written
//      into the dxw buffer, which phase 2 overwrites: no further memory.
//   2. lstm_bwd_seq_kernel, the dh chain: a thread-block cluster of 8 per
//      (direction, batch block of 8 rows). Block k
//      owns H / 8 hidden units and keeps their 4 * H / 8 columns of W_hh^T in
//      shared memory for the whole sequence (128 KB at H = 256). A step reads
//      the activations from dxw_tt, c_tt, c_{tt-1} and dhs_tt, forms dh, dct
//      and da, and writes da over dxw_tt. For the next step each block
//      multiplies its own da columns by its weight slice, a partial dh_carry
//      over all H units, and sends each owner its units' partial through
//      distributed shared memory (rows x H floats a block a step, a quarter
//      of what sending da itself would take); the owner adds the 8 partials in
//      rank order. One cluster barrier a step (the receive buffer is double-
//      buffered), no grid barrier, no round trip through L2. Batch blocks of 8
//      rows: up to B = 56 the chain takes as long as at B = 8, since an H100
//      holds 14 such clusters at once (a cluster lies within one GPC, so fewer
//      than 132 SMs / 8); beyond that the clusters take turns. Blocks of 16
//      rows, which would halve the clusters, were measured at 2.5 times the
//      time of two turns of 8 and are not used.
//   3. lstm_bwd_dw_kernel + lstm_bwd_dw_sum_kernel (parallel): dW_hh^T =
//      sum over rows with t >= 1 of hs_{t-1}^T da, an (H x B*T)(B*T x 4H)
//      product on the tensor cores as in phase 1, the contraction split over
//      `splits` blocks whose partial sums a second kernel adds in split order.
// Any other hidden size takes the earlier design below (lstm_bidir_tm_bwd_
// kernel: one cooperative launch, a grid barrier a step, all three products
// inside the loop), which has no constraint on H.
//
// The earlier design: one persistent cooperative launch, as in lstm_tm.cu.
// Block k owns
// one direction and K hidden units j0 .. j0+K-1, which is to say the 4K gate
// columns {g*H + j}. It keeps in shared memory for the whole sequence:
//   - W_hh^T's 4K columns (H x 4K) for the gate recomputation;
//   - W_hh^T's K rows (K x 4H) for dh_carry of its own units;
//   - its columns of dW_hh^T (H x 4K), summed over all steps and rows with
//     no atomics and written once at the end;
//   - dc_carry of its units.
// dh_carry of unit j needs all 4H columns of the later step's da, which other
// blocks computed: dxw is the exchange buffer. A block writes its da columns
// into dxw at tt, meets the others at grid.sync(), and at tt-1 stages the
// whole (B, 4H) rows of dxw at tt through L2 with __ldcg (never a stale L1
// line). A step is latency-bound at small B, so each chunk of BT batch rows
// starts all its loads in one round, and one pass over the (row, unit) tiles
// computes both dot products before the cell's backward.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "mma_tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// Rows staged in shared memory at once (of 4H + 1 floats), as a count of floats.
constexpr int kStageFloats = 16384;
// Loads each thread keeps in flight while staging (one round at B = 6).
constexpr int kInFlight = 12;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One chunk's loads, all issued in one round so that their latencies overlap:
//   region 0: rows b0 .. b0+bt-1 of da_{tt+1} (dxw at tt+1, 4H floats a row),
//             written by other blocks during this launch: read from L2 (__ldcg);
//   region 1: the same rows of h_{tt-1} (hs at tt-1, H floats a row);
//   region 2: the epilogue's operands of each (row, unit): the 4 gate inputs
//             xw_tt, c_tt, c_{tt-1} and dhs_tt.
// Regions 1 and 2 are read-only for the whole launch (__ldg). A region that
// the step does not need (da at tt = T-1, h at tt = 0) is given zero rows,
// and its buffer is not read.
struct ChunkLoads {
  const float* da;   // dxw row of (b0, tt + 1), or nullptr
  const float* h;    // hs row of (b0, tt - 1), or nullptr
  const float* xw;   // xw row of (b0, tt)
  const float* cs;   // cs row of (b0, tt)
  const float* dhs;  // dhs row of (b0, tt)
  bool has_prev;     // tt > 0: c_{tt-1} exists
};

__device__ __forceinline__ void stage_chunk(const ChunkLoads& ld, float* st_s, float* hst_s,
                                            float* ep_s, int bt, int T, int H, int K,
                                            int j0) {
  const int H4 = 4 * H, HP = H + 1, H4P = H4 + 1;
  const int vec = (H % 4 == 0) ? 4 : 1;
  const int pr0 = H4 / vec, pr1 = H / vec;
  const int n0 = ld.da ? bt * pr0 : 0;
  const int n1 = ld.h ? bt * pr1 : 0;
  const int n2 = bt * K * 7;
  const int n = n0 + n1 + n2;
  for (int base = threadIdx.x; base < n; base += blockDim.x * kInFlight) {
    float4 v[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      int k = base + q * blockDim.x;
      if (k < n0) {
        const float* row = ld.da + (size_t)(k / pr0) * T * H4;
        if (vec == 4) {
          v[q] = __ldcg(reinterpret_cast<const float4*>(row) + k % pr0);
        } else {
          v[q].x = __ldcg(row + k % pr0);
        }
      } else if ((k -= n0) < n1) {
        const float* row = ld.h + (size_t)(k / pr1) * T * H;
        if (vec == 4) {
          v[q] = __ldg(reinterpret_cast<const float4*>(row) + k % pr1);
        } else {
          v[q].x = __ldg(row + k % pr1);
        }
      } else if ((k -= n1) < n2) {
        const int r = k / (K * 7), u = (k / 7) % K, w = k % 7;
        const size_t hrow = (size_t)r * T * H + j0 + u;
        if (w < 4) {
          v[q].x = __ldg(ld.xw + (size_t)r * T * H4 + w * H + j0 + u);
        } else if (w == 4) {
          v[q].x = __ldg(ld.cs + hrow);
        } else if (w == 5) {
          v[q].x = ld.has_prev ? __ldg(ld.cs + hrow - H) : 0.0f;
        } else {
          v[q].x = __ldg(ld.dhs + hrow);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      int k = base + q * blockDim.x;
      float* out;
      int m = vec;
      if (k < n0) {
        out = st_s + (k / pr0) * H4P + (k % pr0) * vec;
      } else if ((k -= n0) < n1) {
        out = hst_s + (k / pr1) * HP + (k % pr1) * vec;
      } else if ((k -= n1) < n2) {
        out = ep_s + (k / 7) * 8 + k % 7;
        m = 1;
      } else {
        continue;
      }
      out[0] = v[q].x;
      if (m == 4) {
        out[1] = v[q].y;
        out[2] = v[q].z;
        out[3] = v[q].w;
      }
    }
  }
}

// Dynamic shared memory layout (C = 4K gate columns of this block; rows of
// H + 1 and 4H + 1 entries are padded so that lanes reading the same column
// of different rows hit different banks):
//   w_s   [K][H + 1]   float4  the 4 gate weights of unit j0 + u for input i
//   da_s  [BT][C]      float   this block's da columns of the current chunk
//   dw_s  [H][C]       float   this block's columns of dW_hh^T (c = g*K + u)
//   st_s  [BT][4H + 1] float   the chunk's rows of da_{tt+1}
//   hst_s [BT][H + 1]  float   the chunk's rows of h_{tt-1}
//   wr_s  [K][4H + 1]  float   rows j0 + u of W_hh^T
//   ep_s  [BT][K][8]   float   xw_tt (4 gates), c_tt, c_{tt-1}, dhs_tt
//   dc_s  [B][K]       float   dc_carry of this block's units
// R: batch rows per thread in the dot products (1 for small batches, 4 from
// B = 4 up). G lanes share one tile of outputs and split its dot products.
template <int R>
__global__ void __launch_bounds__(kThreads)
lstm_bidir_tm_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh_t,
                         const float* __restrict__ hs, const float* __restrict__ cs,
                         const float* __restrict__ dhs, float* dxw,
                         float* __restrict__ dwhh, int B, int T, int H, int K, int BT,
                         int G) {
  extern __shared__ float4 smem4[];
  const int HP = H + 1, H4 = 4 * H, H4P = H4 + 1, C = 4 * K;
  float4* w_s = smem4;
  float* da_s = reinterpret_cast<float*>(w_s + K * HP);
  float* dw_s = da_s + BT * C;
  float* st_s = dw_s + H * C;
  float* hst_s = st_s + BT * H4P;
  float* wr_s = hst_s + BT * HP;
  float* ep_s = wr_s + K * H4P;
  float* dc_s = ep_s + BT * K * 8;

  cg::grid_group grid = cg::this_grid();
  const int blocks_per_dir = H / K;
  const int d = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * K;

  const float* whh = w_hh_t + (size_t)d * H * H4;
  for (int idx = threadIdx.x; idx < K * H; idx += blockDim.x) {
    const int u = idx / H, i = idx % H;
    const float* row = whh + (size_t)i * H4 + j0 + u;
    w_s[u * HP + i] = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
  }
  for (int idx = threadIdx.x; idx < K * H4; idx += blockDim.x)
    wr_s[(idx / H4) * H4P + idx % H4] = whh[(size_t)(j0 + idx / H4) * H4 + idx % H4];
  for (int idx = threadIdx.x; idx < H * C; idx += blockDim.x) dw_s[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < B * K; idx += blockDim.x) dc_s[idx] = 0.0f;

  const size_t dir_h = (size_t)B * T * H;
  const float* xw_d = xw + (size_t)d * B * T * H4;
  const float* hs_d = hs + d * dir_h;
  const float* cs_d = cs + d * dir_h;
  const float* dhs_d = dhs + d * dir_h;
  float* dxw_d = dxw + (size_t)d * B * T * H4;
  const int per_pass = blockDim.x / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;

  for (int tt = T - 1; tt >= 0; --tt) {
    const bool carry = tt < T - 1;  // dh_carry from step tt + 1 exists
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int bt = min(BT, B - b0);
      // a tile is R batch rows x one hidden unit
      const int tiles = ((bt + R - 1) / R) * K;
      __syncthreads();  // earlier readers of the staging buffers are done
      ChunkLoads ld;
      ld.da = carry ? dxw_d + ((size_t)b0 * T + tt + 1) * H4 : nullptr;
      ld.h = tt > 0 ? hs_d + ((size_t)b0 * T + tt - 1) * H : nullptr;
      ld.xw = xw_d + ((size_t)b0 * T + tt) * H4;
      ld.cs = cs_d + ((size_t)b0 * T + tt) * H;
      ld.dhs = dhs_d + ((size_t)b0 * T + tt) * H;
      ld.has_prev = tt > 0;
      stage_chunk(ld, st_s, hst_s, ep_s, bt, T, H, K, j0);
      __syncthreads();

      // per (row, unit): the gates recomputed from h_{tt-1} (zero at tt = 0,
      // where xw alone gives them) and dh_carry = da_{tt+1} . W_hh^T[j, :];
      // then the cell's backward
      for (int o0 = 0; o0 < tiles; o0 += per_pass) {
        const int o = o0 + group;
        const bool active = o < tiles;
        const int rg = active ? o / K : 0;
        const int u = active ? o % K : 0;
        float a[R][4], e[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          a[q][0] = a[q][1] = a[q][2] = a[q][3] = 0.0f;
          e[q] = 0.0f;
        }
        if (active) {
          // rows past bt repeat row bt - 1, and their results are dropped
          int rows[R];
#pragma unroll
          for (int q = 0; q < R; ++q) rows[q] = min(rg * R + q, bt - 1);
          if (tt > 0) {
            const float4* wcol = w_s + u * HP;
            for (int i = lane; i < H; i += G) {
              const float4 w = wcol[i];
#pragma unroll
              for (int q = 0; q < R; ++q) {
                const float hv = hst_s[rows[q] * HP + i];
                a[q][0] = fmaf(hv, w.x, a[q][0]);
                a[q][1] = fmaf(hv, w.y, a[q][1]);
                a[q][2] = fmaf(hv, w.z, a[q][2]);
                a[q][3] = fmaf(hv, w.w, a[q][3]);
              }
            }
          }
          if (carry) {
            const float* wrow = wr_s + u * H4P;
            for (int col = lane; col < H4; col += G) {
              const float w = wrow[col];
#pragma unroll
              for (int q = 0; q < R; ++q) e[q] = fmaf(st_s[rows[q] * H4P + col], w, e[q]);
            }
          }
        }
        // every lane of the warp reaches the shuffles (uniform loop bounds)
        for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int q = 0; q < R; ++q) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              a[q][g] += __shfl_xor_sync(0xffffffffu, a[q][g], off);
            e[q] += __shfl_xor_sync(0xffffffffu, e[q], off);
          }
        }
        if (active && lane == 0) {
          const int j = j0 + u;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int r = rg * R + q;
            if (r < bt) {
              const int b = b0 + r;
              const float* ep = ep_s + (r * K + u) * 8;
              const float ig = sigmoid_f32(ep[0] + a[q][0]);
              const float fg = sigmoid_f32(ep[1] + a[q][1]);
              const float gg = tanhf(ep[2] + a[q][2]);
              const float og = sigmoid_f32(ep[3] + a[q][3]);
              const float tc = tanhf(ep[4]);
              const float c_prev = ep[5];
              const float dh = ep[6] + e[q];
              const float dout = dh * tc;
              const float dct = dh * og * (1.0f - tc * tc) + dc_s[b * K + u];
              dc_s[b * K + u] = dct * fg;
              const float da_i = dct * gg * ig * (1.0f - ig);
              const float da_f = dct * c_prev * fg * (1.0f - fg);
              const float da_g = dct * ig * (1.0f - gg * gg);
              const float da_o = dout * og * (1.0f - og);
              float* dp = dxw_d + ((size_t)b * T + tt) * H4 + j;
              dp[0] = da_i;
              dp[H] = da_f;
              dp[2 * H] = da_g;
              dp[3 * H] = da_o;
              float* ds = da_s + r * C + u;
              ds[0] = da_i;
              ds[K] = da_f;
              ds[2 * K] = da_g;
              ds[3 * K] = da_o;
            }
          }
        }
      }
      __syncthreads();

      // -- dW_hh^T[:, own columns] += h_{tt-1}^T da (nothing to add at tt = 0).
      // Each thread owns 4 x 4 tiles of (input i, column c): no two threads
      // write one entry, so no atomics; it sums its tile over the chunk's
      // rows in registers and adds it to shared memory once.
      if (tt > 0) {
        const int nq_c = C / 4;
        const int nq = ((H + 3) / 4) * nq_c;
        for (int qd = threadIdx.x; qd < nq; qd += blockDim.x) {
          const int i0 = (qd / nq_c) * 4, c0 = (qd % nq_c) * 4;
          float acc[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
          for (int r = 0; r < bt; ++r) {
            const float4 dv = *reinterpret_cast<const float4*>(da_s + r * C + c0);
            const float* hrow = hst_s + r * HP;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float hv = i0 + k < H ? hrow[i0 + k] : 0.0f;
              acc[k][0] = fmaf(hv, dv.x, acc[k][0]);
              acc[k][1] = fmaf(hv, dv.y, acc[k][1]);
              acc[k][2] = fmaf(hv, dv.z, acc[k][2]);
              acc[k][3] = fmaf(hv, dv.w, acc[k][3]);
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (i0 + k < H) {
              float* out = dw_s + (i0 + k) * C + c0;
              out[0] += acc[k][0];
              out[1] += acc[k][1];
              out[2] += acc[k][2];
              out[3] += acc[k][3];
            }
          }
        }
      }
    }
    grid.sync();  // da_tt of every block is in dxw before anyone reads it
  }

  __syncthreads();
  float* dw_d = dwhh + (size_t)d * H * H4;
  for (int idx = threadIdx.x; idx < H * C; idx += blockDim.x) {
    const int i = idx / C, c = idx % C;
    dw_d[(size_t)i * H4 + (c / K) * H + j0 + c % K] = dw_s[idx];
  }
}

size_t smem_bytes(int B, int H, int K, int BT) {
  const size_t HP = (size_t)H + 1, H4P = 4 * (size_t)H + 1, C = 4 * (size_t)K;
  return sizeof(float) * (4 * K * HP + BT * C + H * C + BT * H4P + BT * HP + K * H4P +
                          (size_t)BT * K * 8 + (size_t)B * K);
}
// ---------------------------------------------------------------------------
// The three-phase route (H a multiple of 8, at most 256).

using namespace tf32x3;

constexpr int kTileThreads = 128;  // 4 warps, each 16 rows of a 64-row tile
constexpr int kTile = 64;          // edge of an output tile of the two products
constexpr int kDepth = 32;         // contraction depth of one staged slice
constexpr int kLdA = kDepth + 4;   // [row][depth] tiles, read by ldmatrix
constexpr int kLdB = kTile + 8;    // [depth][column] tiles, read in plain order

constexpr int kCluster = 8;
constexpr int kSeqThreads = 256;
constexpr int kSeqRows = 8;  // batch rows a cluster takes

// Phase 1. One stage: a_s [kTile][kLdA], rows of h_{t-1}; w_s [kDepth][kLdB],
// rows of W_hh^T. Row r = b * T + t of one direction's h_{t-1} is row r - 1
// of hs, and zeros at t = 0. Writes act(xw + h_{t-1} @ W_hh^T) into `gates`.
constexpr int kGateStage = kTile * kLdA + kDepth * kLdB;

__global__ void __launch_bounds__(kTileThreads)
lstm_bwd_gates_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh_t,
                      const float* __restrict__ hs, float* __restrict__ gates, int M, int T,
                      int H) {
  __shared__ __align__(16) float smem[2 * kGateStage];
  const int H4 = 4 * H;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile, d = blockIdx.z;
  const float* hs_d = hs + (size_t)d * M * H;
  const float* w_d = w_hh_t + (size_t)d * H * H4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  auto start = [&](int kc) {
    float* a_s = smem + (kc & 1) * kGateStage;
    float* w_s = a_s + kTile * kLdA;
    const int i0 = kc * kDepth;
    for (int idx = threadIdx.x; idx < kTile * (kDepth / 4); idx += kTileThreads) {
      const int r = idx / (kDepth / 4), c = (idx % (kDepth / 4)) * 4;
      const int row = m0 + r;
      const bool ok = row < M && row % T != 0 && i0 + c < H;
      cp_async16(a_s + r * kLdA + c, ok ? hs_d + (size_t)(row - 1) * H + i0 + c : hs_d,
                 ok ? 16 : 0);
    }
    for (int idx = threadIdx.x; idx < kDepth * (kTile / 4); idx += kTileThreads) {
      const int k = idx / (kTile / 4), c = (idx % (kTile / 4)) * 4;
      const bool ok = i0 + k < H && n0 + c < H4;
      cp_async16(w_s + k * kLdB + c, ok ? w_d + (size_t)(i0 + k) * H4 + n0 + c : w_d,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[kTile / 8][4];
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nk = (H + kDepth - 1) / kDepth;
  start(0);
  for (int kc = 0; kc < nk; ++kc) {
    // slice kc has landed; every warp is done with slice kc - 1, whose stage
    // the copy of slice kc + 1 may now overwrite
    cp_async_wait_all();
    __syncthreads();
    if (kc + 1 < nk) start(kc + 1);
    const float* a_s = smem + (kc & 1) * kGateStage + warp * 16 * kLdA;
    const float* w_s = smem + (kc & 1) * kGateStage + kTile * kLdA;
    // the slice's sum in a fresh accumulator (12 chained passes on the tensor
    // core), then one f32 addition
    float part[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < kDepth; k8 += 8) {
      FragA a;
      FragB b[kTile / 8];
      load_a(a, a_s + k8, kLdA, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) load_b_kn_std(b[n], w_s + k8 * kLdB + 8 * n, kLdB, lane);
      mma3<kTile / 8>(part, a, b);
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

  const float* xw_d = xw + (size_t)d * M * H4;
  float* out_d = gates + (size_t)d * M * H4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + warp * 16 + g + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const int col = n0 + 8 * n + 2 * t4;  // col and col + 1 lie in one gate
      if (col >= H4) continue;
      const float2 x = *reinterpret_cast<const float2*>(xw_d + (size_t)row * H4 + col);
      const float v0 = acc[n][2 * half] + x.x, v1 = acc[n][2 * half + 1] + x.y;
      const bool is_g = col / H == 2;
      *reinterpret_cast<float2*>(out_d + (size_t)row * H4 + col) =
          is_g ? make_float2(tanhf(v0), tanhf(v1))
               : make_float2(sigmoid_f32(v0), sigmoid_f32(v1));
    }
  }
}

// Phase 2: the dh chain. Dynamic shared memory, U = H / 8 units a block:
//   wt_s   [U][H]                      float4  (W_hh^T[j][g * H + j0 + u])_g for
//                                              every unit j: this block's gate
//                                              columns, transposed
//   da_s   [kSeqRows][U]               float4  this block's da of the last step
//   recv_s [2][kCluster][kSeqRows][U]  float   partial dh_carry of this block's
//                                              units from each block, per step parity
// Thread j computes the partial dh_carry of unit j for every row; thread
// row * U + u runs the cell's backward of its (row, unit) and carries dc in a
// register.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kSeqThreads, 1)
lstm_bwd_seq_kernel(const float* __restrict__ w_hh_t, const float* __restrict__ cs,
                    const float* __restrict__ dhs, float* dxw, int B, int T, int H) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / kCluster;
  const int nbb = (B + kSeqRows - 1) / kSeqRows;
  const int d = cid / nbb;
  const int b0 = (cid % nbb) * kSeqRows;
  const int rows = min(kSeqRows, B - b0);
  const int U = H / kCluster;
  const int j0 = rank * U;
  const int H4 = 4 * H;
  const int tid = threadIdx.x;

  float4* wt_s = smem4;
  float4* da_s = wt_s + U * H;
  float* recv_s = reinterpret_cast<float*>(da_s + kSeqRows * U);

  const float* whh = w_hh_t + (size_t)d * H * H4;
  for (int idx = tid; idx < H * U; idx += kSeqThreads) {
    const int j = idx / U, u = idx % U;
    const float* col = whh + (size_t)j * H4 + j0 + u;
    wt_s[u * H + j] = make_float4(col[0], col[H], col[2 * H], col[3 * H]);
  }

  // the product's side of this thread: unit j, whose owner is block j / U
  const int j = tid;
  const bool has_j = j < H;
  float* push = nullptr;
  if (has_j)
    push = cluster.map_shared_rank(recv_s, j / U) + rank * kSeqRows * U + j % U;
  // the cell's side: (row, unit u) of this block
  const bool has_p = tid < rows * U;
  const int row = tid / U, u = tid % U;
  const size_t at_h = ((size_t)d * B + b0 + (has_p ? row : 0)) * T * H + j0 + u;
  float* dxw_p = dxw + ((size_t)d * B + b0 + (has_p ? row : 0)) * T * H4 + j0 + u;
  const float* cs_p = cs + at_h;
  const float* dhs_p = dhs + at_h;
  float dc = 0.f;

  cluster.sync();  // every block of the cluster runs before a remote store lands

  for (int tt = T - 1; tt >= 0; --tt) {
    const bool carry = tt < T - 1;  // dh_carry from step tt + 1 exists
    const int buf = tt & 1;
    // the cell's operands of this step, in flight during the product
    float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, c = 0.f, c_prev = 0.f, dh = 0.f;
    if (has_p) {
      const float* gp = dxw_p + (size_t)tt * H4;
      ig = gp[0];
      fg = gp[H];
      gg = gp[2 * H];
      og = gp[3 * H];
      c = cs_p[(size_t)tt * H];
      c_prev = tt > 0 ? cs_p[(size_t)(tt - 1) * H] : 0.f;
      dh = dhs_p[(size_t)tt * H];
    }
    if (carry) {
      if (has_j) {
        float acc[kSeqRows];
#pragma unroll
        for (int r = 0; r < kSeqRows; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < U; ++k) {
          const float4 w = wt_s[k * H + j];
#pragma unroll
          for (int r = 0; r < kSeqRows; ++r) {
            if (r < rows) {
              const float4 a = da_s[r * U + k];
              acc[r] = fmaf(a.x, w.x, acc[r]);
              acc[r] = fmaf(a.y, w.y, acc[r]);
              acc[r] = fmaf(a.z, w.z, acc[r]);
              acc[r] = fmaf(a.w, w.w, acc[r]);
            }
          }
        }
        float* dst = push + buf * kCluster * kSeqRows * U;
#pragma unroll
        for (int r = 0; r < kSeqRows; ++r)
          if (r < rows) dst[r * U] = acc[r];
      }
      cluster.sync();  // the 8 partials of this step are in every owner's buffer
    }
    if (has_p) {
      if (carry) {
        const float* in = recv_s + (buf * kCluster * kSeqRows + row) * U + u;
#pragma unroll
        for (int s = 0; s < kCluster; ++s) dh += in[s * kSeqRows * U];
      }
      const float tc = tanhf(c);
      const float dout = dh * tc;
      const float dct = dh * og * (1.0f - tc * tc) + dc;
      dc = dct * fg;
      const float4 da = make_float4(dct * gg * ig * (1.0f - ig), dct * c_prev * fg * (1.0f - fg),
                                    dct * ig * (1.0f - gg * gg), dout * og * (1.0f - og));
      float* dp = dxw_p + (size_t)tt * H4;
      dp[0] = da.x;
      dp[H] = da.y;
      dp[2 * H] = da.z;
      dp[3 * H] = da.w;
      da_s[row * U + u] = da;
    }
    __syncthreads();  // da_tt is in da_s before the next step's product
  }
}

// Phase 3. One stage: hp_s [kDepth][kLdB], rows of h_{t-1} (zeros at t = 0);
// da_s [kDepth][kLdB], the same rows of da. Block (i tile, n tile, direction
// and split) sums hs_{t-1}^T da over its `chunk` rows into `out`, laid out
// (splits, ndir, H, 4H).
constexpr int kDwStage = 2 * kDepth * kLdB;

__global__ void __launch_bounds__(kTileThreads)
lstm_bwd_dw_kernel(const float* __restrict__ hs, const float* __restrict__ da,
                   float* __restrict__ out, int M, int T, int H, int splits, int chunk) {
  __shared__ __align__(16) float smem[2 * kDwStage];
  const int H4 = 4 * H;
  const int i0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int ndir = gridDim.z / splits;
  const int d = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int r_begin = sp * chunk, r_end = min(M, r_begin + chunk);
  const float* hs_d = hs + (size_t)d * M * H;
  const float* da_d = da + (size_t)d * M * H4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  auto start = [&](int kc) {
    float* hp_s = smem + (kc & 1) * kDwStage;
    float* da_s = hp_s + kDepth * kLdB;
    const int r0 = r_begin + kc * kDepth;
    for (int idx = threadIdx.x; idx < kDepth * (kTile / 4); idx += kTileThreads) {
      const int k = idx / (kTile / 4), c = (idx % (kTile / 4)) * 4;
      const int row = r0 + k;
      const bool ok_h = row < r_end && row % T != 0 && i0 + c < H;
      const bool ok_a = row < r_end && n0 + c < H4;
      cp_async16(hp_s + k * kLdB + c, ok_h ? hs_d + (size_t)(row - 1) * H + i0 + c : hs_d,
                 ok_h ? 16 : 0);
      cp_async16(da_s + k * kLdB + c, ok_a ? da_d + (size_t)row * H4 + n0 + c : da_d,
                 ok_a ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[kTile / 8][4];
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nk = r_end > r_begin ? (r_end - r_begin + kDepth - 1) / kDepth : 0;
  if (nk > 0) start(0);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait_all();  // as in the gates kernel
    __syncthreads();
    if (kc + 1 < nk) start(kc + 1);
    const float* hp_s = smem + (kc & 1) * kDwStage + warp * 16;
    const float* da_s = smem + (kc & 1) * kDwStage + kDepth * kLdB;
    float part[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < kDepth; k8 += 8) {
      FragA a;
      FragB b[kTile / 8];
      load_a_km(a, hp_s + k8 * kLdB, kLdB, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
        load_b_kn_std(b[n], da_s + k8 * kLdB + 8 * n, kLdB, lane);
      mma3<kTile / 8>(part, a, b);
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

  float* out_d = out + ((size_t)sp * ndir + d) * H * H4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + warp * 16 + g + 8 * half;
    if (i >= H) continue;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const int col = n0 + 8 * n + 2 * t4;
      if (col >= H4) continue;
      *reinterpret_cast<float2*>(out_d + (size_t)i * H4 + col) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// dW_hh^T[idx] = the splits' partial sums, added in split order.
__global__ void __launch_bounds__(kThreads)
lstm_bwd_dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dwhh, int n,
                       int splits) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  float sum = part[idx];
  for (int s = 1; s < splits; ++s) sum += part[(size_t)s * n + idx];
  dwhh[idx] = sum;
}

size_t seq_smem_bytes(int H) {
  const size_t U = H / kCluster;
  return sizeof(float4) * (U * H + kSeqRows * U) +
         sizeof(float) * (2 * kCluster * kSeqRows * U);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The earlier design, for any H. xw (ndir, B, T, 4H), w_hh_t (ndir, H, 4H),
// hs, cs, dhs (ndir, B, T, H), dxw (ndir, B, T, 4H) and dwhh (ndir, H, 4H)
// are contiguous f32 device pointers on `device`; dxw and dwhh are written in
// full. Returns the first non-zero CUDA status among the set-up calls, the
// cooperative launch's own status (which reports a grid too large to be
// co-resident) and cudaGetLastError(); 0 on success. Does not synchronise.
int lstm_bidir_tm_bwd_grid_f32(const void* xw, const void* w_hh_t, const void* hs,
                               const void* cs, const void* dhs, void* dxw, void* dwhh,
                               int ndir, int B, int T, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndir <= 0 || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;

  int sms = 0, coop = 0, smem_optin = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)))
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&smem_optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin, device)))
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;

  const int rows = kStageFloats / (4 * H + 1);
  const int BT = B < rows ? B : (rows > 0 ? rows : 1);
  // K: hidden units per block. Take the narrowest power of two that divides
  // H and still gives one block per SM at most (at H = 256 on 132 SMs: K = 4,
  // 128 blocks; the step is latency-bound, so more blocks with less work each
  // finish it sooner), and widen while the grid would not be co-resident.
  int K = 8;
  while (K > 1 && H % K) K >>= 1;
  while (K > 1 && ndir * (H / (K / 2)) <= sms) K >>= 1;
  const int R = B >= 4 ? 4 : 1;
  const void* fn = R == 4 ? (const void*)lstm_bidir_tm_bwd_kernel<4>
                          : (const void*)lstm_bidir_tm_bwd_kernel<1>;
  for (;;) {
    const size_t smem = smem_bytes(B, H, K, BT);
    const int grid = ndir * (H / K);
    if (smem <= (size_t)smem_optin) {
      if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem)))
        return (int)err;
      int per_sm = 0;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                               smem)))
        return (int)err;
      if (grid <= per_sm * sms) {
        const int tiles = (BT + R - 1) / R * K;
        int G = 32;
        while (G > 1 && (kThreads / G) < tiles) G >>= 1;
        void* args[] = {(void*)&xw, (void*)&w_hh_t, (void*)&hs, (void*)&cs,
                        (void*)&dhs, (void*)&dxw, (void*)&dwhh, (void*)&B,
                        (void*)&T,  (void*)&H,  (void*)&K,   (void*)&BT, (void*)&G};
        err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem,
                                          (cudaStream_t)stream);
        if (err != cudaSuccess) return (int)err;
        return (int)cudaGetLastError();
      }
    }
    if (H % (2 * K)) break;
    K *= 2;
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

// The three-phase route: the same tensors, H a multiple of 8 and at most 256,
// every pointer 16-byte aligned. `splits` >= 1 ways to split dW_hh^T's
// contraction over the B * T rows; `scratch` holds splits * ndir * H * 4H
// floats when splits > 1 (unused otherwise). Four or five launches on
// `stream`; returns the first non-zero status, 0 on success. Does not
// synchronise.
int lstm_bidir_tm_bwd_phases_f32(const void* xw, const void* w_hh_t, const void* hs,
                                 const void* cs, const void* dhs, void* dxw, void* dwhh,
                                 void* scratch, int ndir, int B, int T, int H, int splits,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndir <= 0 || B <= 0 || T <= 0 || H <= 0 || splits <= 0 || H % kCluster ||
      H / kCluster > 32 || (long long)B * T > 0x7fffffffLL / 4)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(xw) && aligned16(w_hh_t) && aligned16(hs) && aligned16(dxw) &&
        aligned16(dwhh) && (splits == 1 || aligned16(scratch))))
    return (int)cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const int M = B * T, H4 = 4 * H;
  const unsigned tiles_n = (H4 + kTile - 1) / kTile;

  lstm_bwd_gates_kernel<<<dim3((M + kTile - 1) / kTile, tiles_n, ndir), kTileThreads, 0, s>>>(
      c(xw), c(w_hh_t), c(hs), m(dxw), M, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem = seq_smem_bytes(H);
  int smem_optin = 0;
  if ((err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)))
    return (int)err;
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(lstm_bwd_seq_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return (int)err;
  const int nbb = (B + kSeqRows - 1) / kSeqRows;
  lstm_bwd_seq_kernel<<<ndir * nbb * kCluster, kSeqThreads, smem, s>>>(
      c(w_hh_t), c(cs), c(dhs), m(dxw), B, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int chunk = ((M + splits - 1) / splits + kDepth - 1) / kDepth * kDepth;
  float* part = splits == 1 ? m(dwhh) : m(scratch);
  lstm_bwd_dw_kernel<<<dim3((H + kTile - 1) / kTile, tiles_n, ndir * splits), kTileThreads, 0,
                       s>>>(c(hs), c(dxw), part, M, T, H, splits, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (splits > 1) {
    const int n = ndir * H * H4;
    lstm_bwd_dw_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        part, m(dwhh), n, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* lstm_tm_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
