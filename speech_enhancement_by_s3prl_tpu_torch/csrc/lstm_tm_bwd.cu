// Reverse-time backward of the time-major bidirectional LSTM recurrence, f32,
// for Hopper (kernel B2 bwd).
//
// Replaces: speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py,
//   _tm_bwd / _kernel_tm_bwd (the VJP of lstm_bidir_tm that every
//   bidirectional layer of the train step runs).
//
// Inputs, all (2, ...) over the direction axis as the forward kernels lay them
// out: xw (2, B, T, 4H), w_hh_t (2, H, 4H), the forward's hs and cs
// (2, B, T, H) and the cotangent dhs (2, B, T, H). Outputs dxw (2, B, T, 4H)
// and dw_hh_t (2, H, 4H). For each direction and each step tt = T-1 .. 0:
//   gates = xw_tt + h_{tt-1} @ W_hh^T        (recomputed, i, f, g, o)
//   dh  = dhs_tt + dh_carry;  do = dh * tanh(c_tt)
//   dct = dh * o * (1 - tanh(c_tt)^2) + dc_carry
//   da  = [dct*g * i(1-i), dct*c_{tt-1} * f(1-f), dct*i * (1-g^2), do * o(1-o)]
//   dxw_tt = da;  dh_carry = da @ W_hh;  dc_carry = dct * f
//   dW_hh^T += h_{tt-1}^T da
// with h_{-1} = c_{-1} = 0 and both carries zero at tt = T-1. Nothing is
// clamped: a NaN anywhere reaches the outputs, so the train step's
// non-finite guard sees it.
//
// What bounds it on this card: like the forward, T strictly sequential steps
// of small products, now three of them a step ((B, H) x (H, 4H) for the
// gates, (B, 4H) x (4H, H) for dh_carry, (H, B) x (B, 4H) for dW_hh^T). One
// direction's W_hh^T (1 MiB at H = 256) does not fit one SM's shared memory.
//
// Design: one persistent cooperative launch, as in lstm_tm.cu. Block k owns
// one direction and K hidden units j0 .. j0+K-1, which is to say the 4K gate
// columns {g*H + j}. It keeps in shared memory for the whole sequence:
//   - W_hh^T's 4K columns (H x 4K) for the gate recomputation;
//   - W_hh^T's K rows (K x 4H) for dh_carry of its own units;
//   - its columns of dW_hh^T (H x 4K), summed over all steps and rows with
//     no atomics and written once at the end, so no second kernel and no
//     library call computes dW_hh^T;
//   - dc_carry of its units.
// dh_carry of unit j needs all 4H columns of the later step's da, which other
// blocks computed: dxw is the exchange buffer. A block writes its da columns
// into dxw at tt, meets the others at grid.sync(), and at tt-1 stages the
// whole (B, 4H) rows of dxw at tt through L2 with __ldcg (never a stale L1
// line). h_{tt-1}, c_tt and c_{tt-1} come from the forward's hs/cs, complete
// before the launch, so plain read-only loads serve. A step is latency-bound
// at small B, so each chunk of BT batch rows issues all its loads (da rows,
// h rows, and the epilogue's xw, c and dhs values) in one round, and one pass
// over the (row, unit) tiles computes both dot products (gates over H,
// dh_carry over 4H) before the cell's backward.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

}  // namespace

extern "C" {

// Launches the backward on `stream`. xw (2, B, T, 4H), w_hh_t (2, H, 4H),
// hs, cs, dhs (2, B, T, H), dxw (2, B, T, 4H) and dwhh (2, H, 4H) are
// contiguous f32 device pointers on `device`; dxw and dwhh are written in
// full. Returns the first non-zero CUDA status among the set-up calls, the
// cooperative launch's own status (which reports a grid too large to be
// co-resident) and cudaGetLastError(); 0 on success. Does not synchronise.
int lstm_bidir_tm_bwd_f32(const void* xw, const void* w_hh_t, const void* hs,
                          const void* cs, const void* dhs, void* dxw, void* dwhh, int B,
                          int T, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;

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
  while (K > 1 && 2 * (H / (K / 2)) <= sms) K >>= 1;
  const int R = B >= 4 ? 4 : 1;
  const void* fn = R == 4 ? (const void*)lstm_bidir_tm_bwd_kernel<4>
                          : (const void*)lstm_bidir_tm_bwd_kernel<1>;
  for (;;) {
    const size_t smem = smem_bytes(B, H, K, BT);
    const int grid = 2 * (H / K);
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
    if (H % (2 * K) || 2 * (H / (2 * K)) < 2) break;
    K *= 2;
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

const char* lstm_tm_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
