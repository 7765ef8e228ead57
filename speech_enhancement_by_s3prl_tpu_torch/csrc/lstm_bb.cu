// Batch-blocked bidirectional LSTM recurrence (forward), with or without the
// input projection inside the kernel, f32, for Hopper.
//
// Replaces, in speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py:
//   - lstm_bidir_pallas / _kernel (kernel B6: the recurrence computed
//     independently per batch block, state reset per block);
//   - lstm_bidir_pallas_fused / _fused_kernel (kernel B7: the same with the
//     input projection x @ W_ih^T + bias computed inside, so that no xw tensor
//     exists in device memory).
// Both are one kernel template: kFused swaps the xw stream for the projection.
//
// Computes, for each direction d, batch row b and step t = 0 .. T-1:
//   gates = xw[d, b, t] + h_{t-1} @ w_hh_t[d]                        (B6)
//   gates = xs[d, b, t] @ w_ih_t[d] + bias[d] + h_{t-1} @ w_hh_t[d]  (B7)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// gate order i, f, g, o; h and c start at zero and stay f32. Direction 1
// receives its input already time-flipped, so both directions walk t upward.
//
// What bounds it on this card: the T dependent steps, each a small product.
// One direction's W_hh^T is 1 MiB at H = 256 and does not fit one SM, and a
// batch block shares nothing with another, so no grid-wide barrier is needed:
// only the blocks that work on one (direction, batch block) must meet.
//
// Design: a thread-block cluster of 8 per (direction, batch block of up to
// 32 rows). Block k of the cluster owns H / 8 hidden units; its 4 * H / 8
// columns of W_hh^T stay in its shared memory for the whole sequence (128 KB
// at H = 256). Every block keeps a full copy of h_{t-1} of its batch block in
// shared memory, double-buffered: at step t each block computes the gates of
// its units from its copy, updates its slice of c (shared memory), writes
// h_t to hs and pushes its slice of h_t into the next buffer of all 8 blocks
// through distributed shared memory; one cluster barrier per step orders
// those stores before step t + 1 reads them. The buffer written at step t is
// the one read at step t - 1, which every block has finished once it passed
// the barrier of step t - 1, so one barrier a step is enough. Inside a
// block, a lane is a hidden unit (its four gates as one float4 of weights),
// and the 8 warps split the work into row groups of 4 and, for small batch
// blocks, slices of the reduction over H (and D); partial sums meet in shared
// memory in a fixed order, so the result is the same on every run.
// For B7 the projection of step t is part of the same reduction, extended
// over [h_{t-1} | x_t] against [W_hh^T ; W_ih^T]: the W_ih^T columns of the
// block stream from L2 every step (D x 4H/8 floats; they do not fit beside
// the W_hh^T slice) and x_t is read from device memory as warp-wide
// broadcasts. The ragged last batch block is guarded by its row count;
// nothing is padded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // batch rows a warp accumulates at once
constexpr int kMaxBlock = 32;  // batch rows a cluster takes
constexpr int kPairs = kMaxBlock * 32 / kThreads;  // (row, unit) outputs a thread

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void fma4(float4& a, float s, const float4& w) {
  a.x = fmaf(s, w.x, a.x);
  a.y = fmaf(s, w.y, a.y);
  a.z = fmaf(s, w.z, a.z);
  a.w = fmaf(s, w.w, a.w);
}

// Dynamic shared memory, U = H / 8 units a block, RA = 4 * RG rows allocated:
//   w_s    [H][U]          float4  the 4 gate weights of unit j0 + u for input i
//   part_s [kWarps * 4][U] float4  partial gates of (warp, row), summed per unit
//   h_s    [2][RA][H]      float   h_{t-1} and h_t of the batch block
//   c_s    [RA][U]         float   this block's slice of the cell state
//   bias_s [4][U]          float   this block's bias columns (B7)
// RG row groups times S = 8 / RG reduction slices make the 8 warps.
template <bool kFused>
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kThreads, 1)
lstm_bb_kernel(const float* __restrict__ xin, const float* __restrict__ w_ih_t,
               const float* __restrict__ bias, const float* __restrict__ w_hh_t,
               float* __restrict__ hs, int B, int T, int H, int D, int bb, int RG,
               int xvec) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / kCluster;
  const int nbb = (B + bb - 1) / bb;
  const int d = cid / nbb;
  const int b0 = (cid % nbb) * bb;
  const int rows = min(bb, B - b0);
  const int U = H / kCluster;
  const int j0 = rank * U;
  const int H4 = 4 * H;
  const int RA = RG * kRows;
  const int S = kWarps / RG;
  const int tid = threadIdx.x;

  float4* w_s = smem4;
  float4* part_s = w_s + H * U;
  float* h_s = reinterpret_cast<float*>(part_s + kWarps * kRows * U);
  float* c_s = h_s + 2 * RA * H;
  float* bias_s = c_s + RA * U;

  const float* whh = w_hh_t + (size_t)d * H * H4;
  for (int idx = tid; idx < H * U; idx += kThreads) {
    const float* col = whh + (size_t)(idx / U) * H4 + j0 + idx % U;
    w_s[idx] = make_float4(col[0], col[H], col[2 * H], col[3 * H]);
  }
  for (int idx = tid; idx < 2 * RA * H; idx += kThreads) h_s[idx] = 0.0f;
  for (int idx = tid; idx < RA * U; idx += kThreads) c_s[idx] = 0.0f;
  if (kFused) {
    for (int idx = tid; idx < 4 * U; idx += kThreads)
      bias_s[idx] = bias[(size_t)d * H4 + (idx / U) * H + j0 + idx % U];
  }

  float* h_remote[kCluster];
#pragma unroll
  for (int k = 0; k < kCluster; ++k) h_remote[k] = cluster.map_shared_rank(h_s, k);

  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp % RG, slice = warp / RG;
  const int row0 = rg * kRows;
  const bool live = lane < U;
  const int uc = live ? lane : U - 1;  // idle lanes repeat the last unit, unread

  const float* in_d = xin + (size_t)d * B * T * (kFused ? D : H4);
  float* hs_d = hs + (size_t)d * B * T * H;
  const float* wih = kFused ? w_ih_t + (size_t)d * D * H4 + j0 + uc : nullptr;

  cluster.sync();  // every block's h_s is zeroed before a remote store lands

  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (t & 1) * RA * H;
    const int nxt = ((t + 1) & 1) * RA * H;

    // B6: the xw values of this thread's outputs, loaded before the products
    float xg[kPairs][4];
    if (!kFused) {
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int p = tid + k * kThreads;
        if (p < rows * U) {
          const float* xp = in_d + ((size_t)(b0 + p / U) * T + t) * H4 + j0 + p % U;
          xg[k][0] = xp[0];
          xg[k][1] = xp[H];
          xg[k][2] = xp[2 * H];
          xg[k][3] = xp[3 * H];
        }
      }
    }

    float4 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    // h_{t-1} @ W_hh^T over this warp's slice of H, four inputs at a time
    for (int q = slice; q < H / 4; q += S) {
      const float4* wq = w_s + (size_t)(4 * q) * U + uc;
      const float4 w0 = wq[0], w1 = wq[U], w2 = wq[2 * U], w3 = wq[3 * U];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h_cur + (row0 + r) * H + 4 * q);
        fma4(acc[r], hv.x, w0);
        fma4(acc[r], hv.y, w1);
        fma4(acc[r], hv.z, w2);
        fma4(acc[r], hv.w, w3);
      }
    }

    if (kFused) {
      // x_t @ W_ih^T over this warp's slice of D; rows past the block's last
      // repeat it, and their sums are never read
      const float* xr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        xr[r] = in_d + ((size_t)(b0 + min(row0 + r, rows - 1)) * T + t) * D;
      if (xvec) {
        for (int q = slice; q < D / 4; q += S) {
          float4 xv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            xv[r] = __ldg(reinterpret_cast<const float4*>(xr[r]) + q);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float* wr = wih + (size_t)(4 * q + k) * H4;
            const float4 w =
                make_float4(__ldg(wr), __ldg(wr + H), __ldg(wr + 2 * H), __ldg(wr + 3 * H));
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float xs = k == 0 ? xv[r].x : (k == 1 ? xv[r].y : (k == 2 ? xv[r].z : xv[r].w));
              fma4(acc[r], xs, w);
            }
          }
        }
      } else {
        for (int i = slice; i < D; i += S) {
          const float* wr = wih + (size_t)i * H4;
          const float4 w =
              make_float4(__ldg(wr), __ldg(wr + H), __ldg(wr + 2 * H), __ldg(wr + 3 * H));
#pragma unroll
          for (int r = 0; r < kRows; ++r) fma4(acc[r], __ldg(xr[r] + i), w);
        }
      }
    }

    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) part_s[(warp * kRows + r) * U + lane] = acc[r];
    }
    __syncthreads();

    // each (row, unit) output: sum the slices in order, add xw or the bias,
    // apply the cell, push h_t to every block of the cluster
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int p = tid + k * kThreads;
      if (p < rows * U) {
        const int row = p / U, u = p % U;
        float4 g = kFused ? make_float4(bias_s[u], bias_s[U + u], bias_s[2 * U + u],
                                        bias_s[3 * U + u])
                          : make_float4(xg[k][0], xg[k][1], xg[k][2], xg[k][3]);
        // slice s of this row was summed by warp s * RG + row / 4
        for (int s = 0; s < S; ++s) {
          const float4 v = part_s[(s * RG * kRows + row) * U + u];
          g.x += v.x;
          g.y += v.y;
          g.z += v.z;
          g.w += v.w;
        }
        const float ig = sigmoid_f32(g.x);
        const float fg = sigmoid_f32(g.y);
        const float gg = tanhf(g.z);
        const float og = sigmoid_f32(g.w);
        const float c = fg * c_s[row * U + u] + ig * gg;
        c_s[row * U + u] = c;
        const float h = og * tanhf(c);
        hs_d[((size_t)(b0 + row) * T + t) * H + j0 + u] = h;
        const int at = nxt + row * H + j0 + u;
#pragma unroll
        for (int kk = 0; kk < kCluster; ++kk) h_remote[kk][at] = h;
      }
    }
    cluster.sync();  // h_t is in every block's buffer; part_s is free again
  }
}

size_t smem_bytes(int H, int RG) {
  const size_t U = H / kCluster, RA = (size_t)RG * kRows;
  return sizeof(float4) * (H * U + kWarps * kRows * U) +
         sizeof(float) * (2 * RA * H + RA * U + 4 * U);
}

// Launches the recurrence on `stream`. Returns the first non-zero CUDA status
// among the set-up calls and cudaGetLastError() after the launch (which
// reports a cluster that cannot be placed); 0 on success. Does not
// synchronise.
template <bool kFused>
int launch(const void* xin, const void* w_ih_t, const void* bias, const void* w_hh_t,
           void* hs, int B, int T, int H, int D, int batch_block, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || H <= 0 || batch_block <= 0 || (kFused && D <= 0))
    return (int)cudaErrorInvalidValue;
  // a lane is a hidden unit and a block owns H / 8 of them
  if (H % kCluster || H / kCluster > 32) return (int)cudaErrorInvalidValue;

  int bb = batch_block < kMaxBlock ? batch_block : kMaxBlock;
  if (bb > B) bb = B;
  const int RG = bb > 16 ? 8 : (bb > 8 ? 4 : (bb > 4 ? 2 : 1));
  const size_t smem = smem_bytes(H, RG);
  int smem_optin = 0;
  if ((err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)))
    return (int)err;
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(lstm_bb_kernel<kFused>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return (int)err;
  const int nbb = (B + bb - 1) / bb;
  const int xvec = kFused && D % 4 == 0 && reinterpret_cast<uintptr_t>(xin) % 16 == 0;
  lstm_bb_kernel<kFused><<<2 * nbb * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xin, (const float*)w_ih_t, (const float*)bias, (const float*)w_hh_t,
      (float*)hs, B, T, H, D, bb, RG, xvec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B6. xw (2, B, T, 4H), w_hh_t (2, H, 4H) and hs (2, B, T, H) are
// contiguous f32 device pointers on `device`; H a multiple of 8, at most 256.
// Batch blocks of more than 32 rows run as several of 32: rows are
// independent, so the split does not change the result.
int lstm_bidir_bb_f32(const void* xw, const void* w_hh_t, void* hs, int B, int T, int H,
                      int batch_block, int device, void* stream) {
  return launch<false>(xw, nullptr, nullptr, w_hh_t, hs, B, T, H, 0, batch_block, device,
                       stream);
}

// Kernel B7. xs (2, B, T, D), w_ih_t (2, D, 4H), bias (2, 4H), w_hh_t
// (2, H, 4H) and hs (2, B, T, H), as above.
int lstm_bidir_fused_f32(const void* xs, const void* w_ih_t, const void* bias,
                         const void* w_hh_t, void* hs, int B, int T, int H, int D,
                         int batch_block, int device, void* stream) {
  return launch<true>(xs, w_ih_t, bias, w_hh_t, hs, B, T, H, D, batch_block, device,
                      stream);
}

const char* lstm_bb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
