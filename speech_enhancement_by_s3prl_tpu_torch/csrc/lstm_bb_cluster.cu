// Bidirectional LSTM recurrence (forward) with the input projection inside
// the kernel, f32, for Hopper: the thread-block cluster design of kernel B7.
//
// Replaces lstm_bidir_pallas_fused / _fused_kernel in
// speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py (kernel B7: the
// batch-blocked recurrence with the projection x @ W_ih^T + bias computed
// inside, so that no xw tensor exists in device memory). This is the
// `cluster` route of ops/cuda/lstm_kernel.bb_route for B7; B6, the same
// recurrence from xw, runs on B1's kernel (lstm_tm_cluster.cu), whose
// algorithm this one shares. lstm_bb.cu keeps the earlier design (W_hh^T in
// shared memory, W_ih^T streamed from L2 every step), which no shape routes
// to any more.
//
// Computes, for each direction d, batch row b and step t = 0 .. T-1:
//   gates = xs[d, b, t] @ w_ih_t[d] + bias[d] + h_{t-1} @ w_hh_t[d]
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// gate order i, f, g, o; h and c start at zero and stay f32. Direction 1
// receives its input already time-flipped, so both directions walk t upward.
//
// What bounds it on this card: the T dependent steps. A step is a small
// (rows, H) x (H, 4H) product, so at few rows the exchange of h_t between the
// SMs that share one direction's W_hh^T (1 MiB at H = 256) sets the step
// time, as in B1. The projection adds rows x D x 4H / 8 FMAs a block a step,
// with W_ih^T (D x 4H / 8 floats a block, 256 KB at D = 512) too large to
// stay beside W_hh^T.
//
// Design, on the skeleton of lstm_tm_cluster.cu:
// (a) One thread-block cluster of 8 per (direction, batch block of `bb`
//     rows), no grid barrier; block k owns U = H / 8 hidden units (the 4U
//     gate columns {g * H + j0 + u}). The wrapper picks bb so that all
//     clusters are co-resident (fused_batch_block); rows are independent and
//     a row's sums never depend on the other rows, so every split gives the
//     same bits.
// (b) W_hh^T in registers for the whole sequence (a warp a slice of 16
//     inputs, a lane a unit), the step product on FMAs with partials summed
//     by the row's warp in slice order, as B1; h_t pushed to all 8 blocks
//     through distributed shared memory into a double buffer, and a split
//     cluster barrier (arrive.release after the pushes, wait.acquire before
//     h is read). Up to 10 rows: what the shared memory leaves beside the
//     projection's ring and staging. A step product on the tensor cores (3
//     split-TF32 mma.sync passes) and W_hh^T in shared memory were measured
//     and lost to FMAs at every row count (root PERF.md, PR 9).
// (c) The projection runs ahead by a run of R = 64 / bb steps: the
//     (bb * R) x D x 4U product of the next run goes on the tensor cores
//     (mma_tf32x3.cuh), in chunks of 32 inputs of D, each a fresh chain of 4
//     k-steps added in chunk order into a double-buffered ring of gate inputs
//     in shared memory (the first chunk adds the bias). The chunks of run
//     k + 1 are spread over the R steps of run k and done between the
//     barrier's arrive and its wait (all blocks of a cluster at the same
//     steps, so those steps are longer by a chunk); x and W_ih^T of a chunk
//     are staged by cp.async while the chunk before is multiplied, so W_ih^T
//     streams from L2 once a run, not once a step. Spreading over steps was
//     picked over warps of their own: the recurrence's 512 threads already
//     hold W_hh^T in all of the register file, so a producer warp would have
//     no registers. Rows and inputs past the edge (ragged B, T, D) are
//     zero-filled in the staging buffers, never in device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"
#include "launch_setup.cuh"
#include "mma_tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kUnits = 32;                   // most units a block owns (H / 8)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;        // 16
constexpr int kSliceLen = 16;                // inputs a warp owns
constexpr int kSlices = kWarps;              // slices of the 256 inputs
constexpr int kHPad = kSlices * kSliceLen;   // 256
constexpr int kHLd = kHPad + 4;              // h rows
constexpr int kMaxRows = 10;                 // rows a cluster takes at most
constexpr int kNTiles = 4;                   // n-tiles of 8 gate columns a warp holds
constexpr int kLdC = 4 * kUnits + 8;         // 136: rows of gate columns (8 mod 32)
constexpr int kRunPairs = 64;                // rows x steps a run projects
constexpr int kChunk = 32;                   // inputs of D a projection chunk
constexpr int kXLd = kChunk + 4;             // 36: staged x rows (4 mod 32)
constexpr int kStage = kRunPairs * kXLd + kChunk * kLdC;  // floats a staged chunk

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void fma4(float4& a, float s, const float4& w) {
  a.x = fmaf(s, w.x, a.x);
  a.y = fmaf(s, w.y, a.y);
  a.z = fmaf(s, w.z, a.z);
  a.w = fmaf(s, w.w, a.w);
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Floats of dynamic shared memory at bb rows:
//   h_s     [2][bb][kHLd]             h_{t-1} / h_t
//   part_s  [bb][kSlices][kUnits]     float4 partial gates
//   ring_s  [2][kRunPairs][kLdC]      gate inputs of this run and the next
//   stage_s [2][kStage]               a chunk's x [kRunPairs][kXLd] and
//                                     W_ih^T [kChunk][kLdC], double-buffered
__host__ __device__ inline size_t smem_floats(int bb) {
  return (size_t)2 * bb * kHLd + (size_t)bb * kSlices * kUnits * 4 +
         (size_t)2 * kRunPairs * kLdC + 2 * kStage;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
lstm_bb_cluster_kernel(const float* __restrict__ xs, const float* __restrict__ w_ih_t,
                       const float* __restrict__ bias, const float* __restrict__ w_hh_t,
                       float* __restrict__ hs, int B, int T, int H, int D, int bb,
                       int vec) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / kCluster;
  const int nbb = (B + bb - 1) / bb;
  const int d = cid / nbb;
  const int b0 = (cid % nbb) * bb;
  const int rows = min(bb, B - b0);
  const int U = H / kCluster;
  const int N4 = 4 * U;
  const int j0 = rank * U;
  const int H4 = 4 * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates

  float* h_s = reinterpret_cast<float*>(smem4);
  float* part_s = h_s + 2 * bb * kHLd;
  float* ring_s = part_s + bb * kSlices * kUnits * 4;
  float* stage_s = ring_s + 2 * kRunPairs * kLdC;
  float4* part4 = reinterpret_cast<float4*>(part_s);

  // the weights: thread (warp s, lane u) holds inputs 16 s .. 16 s + 15 of
  // unit j0 + u, 4 gates each
  const float* whh = w_hh_t + (size_t)d * H * H4;
  float4 w[kSliceLen];
#pragma unroll
  for (int k = 0; k < kSliceLen; ++k) {
    const int i = warp * kSliceLen + k;
    w[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lane < U && i < H) {
      const float* p = whh + (size_t)i * H4 + j0 + lane;
      w[k] = make_float4(__ldg(p), __ldg(p + H), __ldg(p + 2 * H), __ldg(p + 3 * H));
    }
  }
  for (int idx = tid; idx < 2 * bb * kHLd; idx += kThreads) h_s[idx] = 0.0f;

  // the cell's side: warp = row, lane = unit (as B1)
  const bool on = warp < rows && lane < U;
  float c = 0.0f;

  // the projection, as a stream of items (run j, chunk c) in order
  const int nch = (D + kChunk - 1) / kChunk;
  const int R = kRunPairs / bb;
  const int nruns = (T + R - 1) / R;
  const int nitems = nruns * nch;
  const float* xs_d = xs + (size_t)d * B * T * D;
  // a thread stages the 16 bytes at (x row fx_m, inputs 4 fx_q ..) and at
  // (W_ih^T row fw_q[k], columns fw_n[k] ..): indices worked out once
  const int fx_m = tid >> 3, fx_q = (tid & 7) * 4;
  const int fx_s = fx_m / bb, fx_row = fx_m - fx_s * bb;
  int fw_q[2], fw_n[2], fw_col[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int p = tid + k * kThreads;
    fw_q[k] = p >> 5;
    fw_n[k] = (p & 31) * 4;
    fw_col[k] = (fw_n[k] / U) * H + j0 + fw_n[k] % U;
  }
  const bool xvec = vec & 1, wvec = vec & 2;
  auto fetch = [&](int i) {  // stage item i's x and W_ih^T slice in buffer i & 1
    const int j = i / nch, ch = i - j * nch;
    float* sx = stage_s + (i & 1) * kStage;
    float* sw = sx + kRunPairs * kXLd;
    {
      const int t = j * R + fx_s, dd = ch * kChunk + fx_q;
      const bool ok = fx_s < R && fx_row < rows && t < T;
      const int n = ok ? max(0, min(4, D - dd)) : 0;  // inputs left in this row
      const float* src = n ? xs_d + ((size_t)(b0 + fx_row) * T + t) * D + dd : xs;
      float* dst = sx + fx_m * kXLd + fx_q;
      if (xvec) {
        cp_async16(dst, src, 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < n ? src + e : xs, e < n ? 4 : 0);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int dd = ch * kChunk + fw_q[k];
      float* dst = sw + fw_q[k] * kLdC + fw_n[k];
      const float* row = w_ih_t + ((size_t)d * D + dd) * H4;
      if (wvec) {  // U a multiple of 4: the 4 columns lie in one gate
        const bool ok = dd < D && fw_n[k] < N4;
        cp_async16(dst, ok ? row + fw_col[k] : w_ih_t, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = fw_n[k] + e;
          const bool ok = dd < D && n < N4;
          cp_async4(dst + e, ok ? row + (n / U) * H + j0 + n % U : w_ih_t, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  auto process = [&](int i) {  // item i into the ring; item i + 1 fetched meanwhile
    cp_async_wait_all();
    __syncthreads();  // item i has landed for all; no warp still reads its buffer's last item
    if (i + 1 < nitems) fetch(i + 1);
    const int j = i / nch, ch = i - j * nch;
    const float* sx = stage_s + (i & 1) * kStage;
    const float* sw = sx + kRunPairs * kXLd;
    const int mt = warp & 3;  // 4 M tiles x 4 column quarters
    if (mt * 16 >= bb * R) return;
    float* rb = ring_s + (j & 1) * kRunPairs * kLdC;
    const float* bd = bias + (size_t)d * H4;
    // two n-tiles at a time (the A fragments read again from shared memory),
    // so that few registers are live beside the resident W_hh^T
    for (int n0 = 0; n0 < kNTiles; n0 += 2) {
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        if (ch * kChunk + kk * 8 < D) {
          tf32x3::FragA a;
          tf32x3::load_a(a, sx + mt * 16 * kXLd + kk * 8, kXLd, lane);
          tf32x3::FragB b[2];
#pragma unroll
          for (int n = 0; n < 2; ++n)
            tf32x3::load_b_kn_std(b[n], sw + kk * 8 * kLdC + ((warp >> 2) * kNTiles + n0 + n) * 8,
                                  kLdC, lane);
          tf32x3::mma3<2>(acc, a, b);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int m = mt * 16 + gq + 8 * h2;
          const int col = ((warp >> 2) * kNTiles + n0 + n) * 8 + 2 * tq;
          if (col < N4 && m < bb * R) {
            float2* p = reinterpret_cast<float2*>(rb + m * kLdC + col);
            float2 v = ch == 0
                           ? make_float2(__ldg(bd + (col / U) * H + j0 + col % U),
                                         __ldg(bd + ((col + 1) / U) * H + j0 + (col + 1) % U))
                           : *p;
            v.x += acc[n][2 * h2];
            v.y += acc[n][2 * h2 + 1];
            *p = v;
          }
        }
    }
  };

  fetch(0);
  for (int i = 0; i < nch; ++i) process(i);  // run 0, before its steps

  cluster.sync();  // every block's h_s is zeroed before a remote store lands

  for (int t = 0; t < T; ++t) {
    float* h_cur = h_s + (t & 1) * bb * kHLd;
    float* h_nxt = h_s + ((t + 1) & 1) * bb * kHLd;
    if (t > 0) cluster_wait_acquire();  // h_{t-1} has landed

    // partial gates of every row over this warp's 16 inputs (as B1)
    for (int r = 0; r < rows; ++r) {
      const float4* hp = reinterpret_cast<const float4*>(h_cur + r * kHLd + warp * kSliceLen);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kSliceLen / 4; ++q) {
        const float4 hv = hp[q];
        fma4(acc, hv.x, w[4 * q]);
        fma4(acc, hv.y, w[4 * q + 1]);
        fma4(acc, hv.z, w[4 * q + 2]);
        fma4(acc, hv.w, w[4 * q + 3]);
      }
      part4[(r * kSlices + warp) * kUnits + lane] = acc;
    }
    __syncthreads();

    // the cell: gate inputs, then the partials in order; h_t to all 8 blocks
    const int run = t / R, s = t - run * R;
    const float* rb = ring_s + (run & 1) * kRunPairs * kLdC;
    float h = 0.0f;
    if (on) {
      const float* xp = rb + (s * bb + warp) * kLdC + lane;
      float4 x = make_float4(xp[0], xp[U], xp[2 * U], xp[3 * U]);
      const float4* ps = part4 + warp * kSlices * kUnits + lane;
#pragma unroll 4
      for (int sl = 0; sl < kSlices; ++sl) {
        const float4 p = ps[sl * kUnits];
        x.x += p.x;
        x.y += p.y;
        x.z += p.z;
        x.w += p.w;
      }
      const float ig = sigmoid_f32(x.x);
      const float fg = sigmoid_f32(x.y);
      const float gg = tanhf(x.z);
      const float og = sigmoid_f32(x.w);
      c = fmaf(fg, c, ig * gg);
      h = og * tanhf(c);
      float* dst = h_nxt + warp * kHLd + j0 + lane;
#pragma unroll
      for (int kk = 0; kk < kCluster; ++kk) *cluster.map_shared_rank(dst, kk) = h;
    }
    cluster_arrive_release();
    if (on) hs[((size_t)(d * B + b0 + warp) * T + t) * H + j0 + lane] = h;
    // this step's share of the next run's projection, off the h chain
    if (run + 1 < nruns) {
      for (int i = (run + 1) * nch + s * nch / R; i < (run + 1) * nch + (s + 1) * nch / R; ++i)
        process(i);
    }
  }
  // no block leaves while a store into its shared memory may be in flight
  cluster_wait_acquire();
}

KernelSetup g_setup[kMaxDevices];

}  // namespace

extern "C" {

// Kernel B7. xs (2, B, T, D), w_ih_t (2, D, 4H), bias (2, 4H), w_hh_t
// (2, H, 4H) and hs (2, B, T, H) are contiguous f32 device pointers on
// `device`; H a multiple of 8 and at most 256, D >= 1, 1 <= batch_block <= 10
// (the rows a cluster takes). Returns the first non-zero CUDA status among
// the set-up calls and cudaGetLastError() after the launch (which reports a
// cluster that cannot be placed); 0 on success. Does not synchronise.
int lstm_bb_cluster_f32(const void* xs, const void* w_ih_t, const void* bias,
                        const void* w_hh_t, void* hs, int B, int T, int H, int D,
                        int batch_block, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % kCluster || H / kCluster > kUnits || D <= 0 ||
      batch_block < 1 || batch_block > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const KernelSetup* setup;
  cudaError_t err = setup_on(device, g_setup, lstm_bb_cluster_kernel, &setup);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * smem_floats(batch_block);
  if (smem > (size_t)setup->smem_optin) return (int)cudaErrorInvalidValue;
  const int nbb = (B + batch_block - 1) / batch_block;
  // the staging copies 16 bytes at once where rows and columns allow it
  const int vec = (D % 4 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0) |
                  ((H / kCluster) % 4 == 0 && reinterpret_cast<uintptr_t>(w_ih_t) % 16 == 0) << 1;
  lstm_bb_cluster_kernel<<<2 * nbb * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xs, (const float*)w_ih_t, (const float*)bias, (const float*)w_hh_t,
      (float*)hs, B, T, H, D, batch_block, vec);
  return (int)cudaGetLastError();
}

// The number of 8-block clusters of this kernel at kMaxRows rows that the
// card holds at once (one block of 512 threads a SM), into *clusters.
int lstm_bb_cluster_max_clusters(int device, int* clusters) {
  const KernelSetup* setup;
  cudaError_t err = setup_on(device, g_setup, lstm_bb_cluster_kernel, &setup);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = sizeof(float) * smem_floats(kMaxRows);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)lstm_bb_cluster_kernel,
                                             &config);
}

const char* lstm_bb_cluster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
