// Time-major LSTM recurrence (forward), one or two directions, f32, for Hopper.
//
// Replaces, in speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py:
//   - lstm_bidir_pallas_tm / _kernel_tm (kernel B1: the recurrence that every
//     bidirectional layer of the enhance and eval paths runs);
//   - _tm_fwd_with_cell / _kernel_tm_fc (kernel B2 fwd: the same recurrence
//     under autograd, which also writes the cell state of every step, the
//     residual that the backward kernel in lstm_tm_bwd.cu reads).
// Both are one kernel template: kCell adds one store of c_t per step and
// nothing else, so B1's instances compile as they did before the flag.
// This is the `grid` route of ops/cuda/lstm_kernel.fwd_route: the hidden
// sizes that lstm_tm_cluster.cu does not take (not a multiple of 8, or above
// 256) run here.
//
// Computes, for each direction d < ndir (ndir is 2 for a bidirectional layer,
// 1 for a one-direction layer) and each step t = 0 .. T-1, for the whole batch:
//   gates = xw[d, :, t] + h_{t-1} @ w_hh_t[d]        (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// with h and c starting at zero, or at a given (h0, c0), and kept in f32.
// Direction 1 receives its own already time-flipped xw, so both directions
// walk t upward. B1 may also take h0, c0 (ndir, B, H) and write the final
// cell state cT (ndir, B, H), for a stream carried chunk by chunk; a null
// pointer leaves the stateless arithmetic as it is (zeros in, no cT out).
//
// What bounds it on this card: the T steps are strictly sequential, and each
// step is a tiny (B, H) x (H, 4H) product. At the flagship width (H = 256) one
// direction's W_hh^T is 256 x 1024 x 4 B = 1 MiB, far above the 227 KB of
// shared memory one block can hold, so the TPU design (weights and state
// resident in one core's VMEM for the whole sequence) does not fit one SM.
// Re-reading W_hh^T from L2 every step would make each step wait on 2 MiB of
// L2 traffic; launching one kernel per step would pay a launch per step.
//
// Design: one persistent cooperative launch per layer. Block k owns one
// direction and a slice of K hidden units; its 4K columns of W_hh^T stay in
// shared memory for the whole sequence (K = 8 at H = 256: 32 KB a block, 64
// blocks). Each step a block stages h_{t-1} of its direction (read from the
// hs output of the previous step, through L2, bypassing L1), computes its
// (B, 4K) gates with f32 FMAs, updates its slice of c (kept in shared
// memory), and writes h_t into hs. One grid-wide barrier per step orders the
// h_t writes before any block reads them at t + 1; since h_t is read from hs
// itself, no separate h buffer is needed. Per step the only device-memory
// traffic is the xw slice in and the h slice out; the cost left is the
// barrier and the latency of the short dot products, which later work can cut
// (tensor cores, clusters with distributed shared memory in place of the grid
// barrier, bf16 xw streams).
//
// The bf16-h form (kBf16H, entries' `h_bf16`): h_{t-1} (h0 included) rounded
// to bf16 where a block stages it for the step product, as the JAX package's
// one-direction lax.scan cell in bf16 rounds it; hs, cs, c and cT keep f32.
//
// The bf16 stream forms (entries' `form` bits 2 and 4, as in
// lstm_tm_cluster.cu): kXw reads xw as bf16, widened where a tile reads it;
// kOut stores hs (and cs under kCell) rounded to bf16. Since the steps read
// h_{t-1} back from hs, kOut would feed the recurrence a rounded h: there
// each block also writes h_t in f32 into `hf` (2, ndir, B, H), by step
// parity (h_{t-1} is read from one half while h_t goes to the other; the grid
// barrier orders a step's writes before the next step's reads), and the
// steps read h from it.
//
// B1's forms of other functions (entries' `form` bits 8 and 16, as in
// lstm_tm_cluster.cu): kFormGates runs the cell on the gate pre-activations
// rounded to bf16, i, f, o = bf16(bf16(tanh(x / 2)) / 2 + 1/2), g =
// bf16(tanh(x)) and i * g rounded to bf16 (JAX's SE_PALLAS_GATES_BF16);
// kFormI8 reads an int8 xw and one f32 scale a (direction, row, step), and a
// tile takes q * scale rounded once (the scan's SE_LSTM_XW_INT8). kFormH with
// kFormOut is the MXU form under SE_PALLAS_HS_BF16: the steps read h from hf
// and round it where they stage it. The flags are template parameters, so
// the f32 instances keep their code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16_round.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// Rows of h_{t-1} staged in shared memory at once, as a count of floats.
constexpr int kStageFloats = 16384;
// Loads of h_{t-1} each thread keeps in flight while staging: the staging
// is a run of L2 round trips, so batching them hides their latency.
constexpr int kInFlight = 8;
// bits of kForm (and of the entries' `form`): the bf16-h form, a bf16 xw,
// bf16 hs (and cs)
constexpr int kFormH = 1, kFormXw = 2, kFormOut = 4, kFormGates = 8, kFormI8 = 16;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The gates form's sigmoid of a bf16 value x: tanh(x / 2) / 2 + 1/2, each pass
// rounded to bf16 (the halvings exact).
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return bf16_round(bf16_round(tanhf(x * 0.5f)) * 0.5f + 0.5f);
}

// One step's cell: the updated c and h from the gate pre-activations (i, f, g,
// o) and c_{t-1}; kGates: the gates form.
template <bool kGates>
__device__ __forceinline__ float2 cell(float xi, float xf, float xg, float xo, float c) {
  if (kGates) {
    const float ig = sigmoid_bf16(bf16_round(xi));
    const float fg = sigmoid_bf16(bf16_round(xf));
    const float gg = bf16_round(tanhf(bf16_round(xg)));
    const float og = sigmoid_bf16(bf16_round(xo));
    c = fg * c + bf16_round(ig * gg);
    return make_float2(c, og * tanhf(c));
  }
  const float ig = sigmoid_f32(xi);
  const float fg = sigmoid_f32(xf);
  const float gg = tanhf(xg);
  const float og = sigmoid_f32(xo);
  c = fg * c + ig * gg;
  return make_float2(c, og * tanhf(c));
}

// Dynamic shared memory layout (rows padded to H + 1 entries, so that lanes
// reading the same i of different rows hit different banks):
//   w_s [K][H + 1] float4  the 4 gate weights of hidden unit j0 + u for input i
//   h_s [BT][H + 1] float  a chunk of batch rows of h_{t-1}
//   c_s [B][K]      float  this block's slice of the cell state
// R: batch rows per thread (1 for small batches, 4 from B = 4 up).
// kCell: also write c_t into cs (2, B, T, H), laid out like hs.
// h0, c0 and c_out are (ndir, B, H) or null. kForm: the bf16-h form (kFormH),
// the stream forms (kFormXw, kFormOut; hf is used under kFormOut only), the
// gates form (kFormGates) and an int8 xw (kFormI8, with xw_scale (ndir, B, T);
// else null).
template <int R, bool kCell, int kForm>
__global__ void __launch_bounds__(kThreads)
lstm_bidir_tm_kernel(const float* __restrict__ xw, const float* __restrict__ xw_scale,
                     const float* __restrict__ w_hh_t, float* hs, float* __restrict__ cs,
                     const float* __restrict__ h0, const float* __restrict__ c0,
                     float* __restrict__ c_out, float* __restrict__ hf, int B, int T, int H,
                     int K, int BT, int G) {
  constexpr bool kBf16H = kForm & kFormH;
  constexpr bool kOut = kForm & kFormOut;
  constexpr bool kI8 = kForm & kFormI8;
  using XwT = std::conditional_t<
      kI8, int8_t, std::conditional_t<(kForm & kFormXw) != 0, __nv_bfloat16, float>>;
  using OutT = std::conditional_t<kOut, __nv_bfloat16, float>;
  extern __shared__ float4 smem4[];
  float4* w_s = smem4;
  const int HP = H + 1;
  float* h_s = reinterpret_cast<float*>(w_s + K * HP);
  float* c_s = h_s + BT * HP;

  cg::grid_group grid = cg::this_grid();
  const int blocks_per_dir = H / K;
  const int d = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * K;
  const int H4 = 4 * H;

  const float* whh = w_hh_t + (size_t)d * H * H4;
  for (int idx = threadIdx.x; idx < K * H; idx += blockDim.x) {
    const int u = idx / H, i = idx % H;
    const float* row = whh + (size_t)i * H4 + j0 + u;
    w_s[u * HP + i] = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
  }
  // this block's units of c_{-1} for every row, and where cT goes
  const size_t state_d = (size_t)d * B * H + j0;
  for (int idx = threadIdx.x; idx < B * K; idx += blockDim.x)
    c_s[idx] = c0 != nullptr ? c0[state_d + (size_t)(idx / K) * H + idx % K] : 0.0f;

  const XwT* xw_d = reinterpret_cast<const XwT*>(xw) + (size_t)d * B * T * H4;
  const float* scale_d = kI8 ? xw_scale + (size_t)d * B * T : nullptr;
  OutT* hs_d = reinterpret_cast<OutT*>(hs) + (size_t)d * B * T * H;
  OutT* cs_d = kCell ? reinterpret_cast<OutT*>(cs) + (size_t)d * B * T * H : nullptr;
  // kOut: h of this direction in f32 by step parity, (B, H) each
  const size_t hf_half = (size_t)(gridDim.x / blocks_per_dir) * B * H;
  float* hf_d = kOut ? hf + (size_t)d * B * H : nullptr;
  // G lanes share one tile of outputs and split its dot products over H; G is a power of two <= 32, so a group never straddles
  // a warp and the shuffles below stay inside it.
  const int per_pass = blockDim.x / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;

  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int bt = min(BT, B - b0);
      __syncthreads();  // earlier readers of h_s are done; w_s / c_s are set
      if (t == 0) {
        const float* h0_d = h0 != nullptr ? h0 + ((size_t)d * B + b0) * H : nullptr;
        for (int idx = threadIdx.x; idx < bt * H; idx += blockDim.x)
          h_s[(idx / H) * HP + idx % H] =
              h0_d != nullptr ? (kBf16H ? bf16_round(h0_d[idx]) : h0_d[idx]) : 0.0f;
      } else {
        // h_{t-1} rows were written by other blocks at t - 1: __ldcg reads
        // them from L2, never from a stale L1 line. 16-byte loads where the
        // rows allow them, kInFlight of them in flight per thread.
        const int vec = (H % 4 == 0) ? 4 : 1;
        const int per_row = H / vec;
        const int n = bt * per_row;
        for (int base = threadIdx.x; base < n; base += blockDim.x * kInFlight) {
          float4 v[kInFlight];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            const int k = base + q * blockDim.x;
            if (k < n) {
              const float* row;
              if constexpr (kOut) {
                row = hf_d + ((t - 1) & 1) * hf_half + (size_t)(b0 + k / per_row) * H;
              } else {
                row = hs_d + ((size_t)(b0 + k / per_row) * T + (t - 1)) * H;
              }
              if (vec == 4) {
                v[q] = __ldcg(reinterpret_cast<const float4*>(row) + k % per_row);
              } else {
                v[q].x = __ldcg(row + k % per_row);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            const int k = base + q * blockDim.x;
            if (k < n) {
              float* dst = h_s + (k / per_row) * HP + (k % per_row) * vec;
              dst[0] = kBf16H ? bf16_round(v[q].x) : v[q].x;
              if (vec == 4) {
                dst[1] = kBf16H ? bf16_round(v[q].y) : v[q].y;
                dst[2] = kBf16H ? bf16_round(v[q].z) : v[q].z;
                dst[3] = kBf16H ? bf16_round(v[q].w) : v[q].w;
              }
            }
          }
        }
      }
      __syncthreads();
      // a tile is R batch rows x one hidden unit: the thread reuses each
      // W_hh^T value it reads from shared memory for R rows
      const int tiles = ((bt + R - 1) / R) * K;
      for (int o0 = 0; o0 < tiles; o0 += per_pass) {
        const int o = o0 + group;
        const bool active = o < tiles;
        const int rg = active ? o / K : 0;
        const int u = active ? o % K : 0;
        const bool owner = active && lane == 0;
        const float* hrow[R];
        float x[R][4];
        // issue the xw loads of this tile now; they land during the FMAs.
        // Rows past bt repeat row bt - 1, and their results are dropped.
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int r = min(rg * R + q, bt - 1);
          hrow[q] = h_s + r * HP;
          x[q][0] = x[q][1] = x[q][2] = x[q][3] = 0.0f;
          if (owner) {
            const XwT* xp = xw_d + ((size_t)(b0 + r) * T + t) * H4 + j0 + u;
            if constexpr (kI8) {
              // q * scale rounded once, as JAX's xw_t.astype(f32) * scale_t
              const float sc = scale_d[(size_t)(b0 + r) * T + t];
              x[q][0] = __fmul_rn((float)xp[0], sc);
              x[q][1] = __fmul_rn((float)xp[H], sc);
              x[q][2] = __fmul_rn((float)xp[2 * H], sc);
              x[q][3] = __fmul_rn((float)xp[3 * H], sc);
            } else {
              x[q][0] = widen(xp[0]);
              x[q][1] = widen(xp[H]);
              x[q][2] = widen(xp[2 * H]);
              x[q][3] = widen(xp[3 * H]);
            }
          }
        }
        float a[R][4];
#pragma unroll
        for (int q = 0; q < R; ++q) a[q][0] = a[q][1] = a[q][2] = a[q][3] = 0.0f;
        if (active) {
          const float4* wcol = w_s + u * HP;
          for (int i = lane; i < H; i += G) {
            const float4 w = wcol[i];
#pragma unroll
            for (int q = 0; q < R; ++q) {
              const float hv = hrow[q][i];
              a[q][0] = fmaf(hv, w.x, a[q][0]);
              a[q][1] = fmaf(hv, w.y, a[q][1]);
              a[q][2] = fmaf(hv, w.z, a[q][2]);
              a[q][3] = fmaf(hv, w.w, a[q][3]);
            }
          }
        }
        // every lane of the warp reaches these shuffles (the loop bounds are
        // uniform over the block)
        for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int q = 0; q < R; ++q) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              a[q][g] += __shfl_xor_sync(0xffffffffu, a[q][g], off);
          }
        }
        if (owner) {
          const int j = j0 + u;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int r = rg * R + q;
            if (r < bt) {
              const int b = b0 + r;
              const float2 ch =
                  cell<(kForm & kFormGates) != 0>(x[q][0] + a[q][0], x[q][1] + a[q][1],
                                                  x[q][2] + a[q][2], x[q][3] + a[q][3],
                                                  c_s[b * K + u]);
              const float c = ch.x;
              c_s[b * K + u] = c;
              const float h = ch.y;
              hs_d[((size_t)b * T + t) * H + j] = narrow<OutT>(h);
              if (kCell) cs_d[((size_t)b * T + t) * H + j] = narrow<OutT>(c);
              if (kOut) hf_d[(t & 1) * hf_half + (size_t)b * H + j] = h;
            }
          }
        }
      }
    }
    grid.sync();  // h_t of every block is in hs before anyone reads it
  }
  if (c_out != nullptr) {  // the grid barrier above also orders c_s
    for (int idx = threadIdx.x; idx < B * K; idx += blockDim.x)
      c_out[state_d + (size_t)(idx / K) * H + idx % K] = c_s[idx];
  }
}

size_t smem_bytes(int B, int H, int K, int BT) {
  return sizeof(float) * ((size_t)4 * K * (H + 1) + (size_t)BT * (H + 1) + (size_t)B * K);
}

// Launches the recurrence on `stream`; cs is nullptr for B1, and h0, c0 and
// c_out are nullptr but for B1 with a carried state; hf (2, ndir, B, H) f32
// is used only when kForm has kFormOut. Returns the
// first non-zero CUDA status among the set-up calls, the cooperative launch's
// own status (which reports a grid too large to be co-resident) and
// cudaGetLastError(); 0 on success. Does not synchronise.
template <bool kCell, int kForm>
int launch(const void* xw, const void* xw_scale, const void* w_hh_t, void* hs, void* cs,
           const void* h0, const void* c0, void* c_out, void* hf, int ndir, int B, int T,
           int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndir <= 0 || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((kForm & kFormOut) && hf == nullptr) return (int)cudaErrorInvalidValue;
  if ((kForm & kFormI8) && xw_scale == nullptr) return (int)cudaErrorInvalidValue;

  int sms = 0, coop = 0, smem_optin = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)))
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)))
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&smem_optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin, device)))
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;

  const int BT = B < kStageFloats / H ? B : (kStageFloats / H > 0 ? kStageFloats / H : 1);
  // K: hidden units per block. Start at 8 (or the largest power of two that
  // divides H) and widen while the grid would not be co-resident.
  int K = 8;
  while (K > 1 && H % K) K >>= 1;
  const int R = B >= 4 ? 4 : 1;
  const void* fn = R == 4 ? (const void*)lstm_bidir_tm_kernel<4, kCell, kForm>
                          : (const void*)lstm_bidir_tm_kernel<1, kCell, kForm>;
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
        const int tiles = ((B < BT ? B : BT) + R - 1) / R * K;
        int G = 32;
        while (G > 1 && (kThreads / G) < tiles) G >>= 1;
        void* args[] = {(void*)&xw, (void*)&xw_scale, (void*)&w_hh_t, (void*)&hs,
                        (void*)&cs, (void*)&h0,       (void*)&c0,     (void*)&c_out,
                        (void*)&hf, (void*)&B,        (void*)&T,      (void*)&H,
                        (void*)&K,  (void*)&BT,       (void*)&G};
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

}  // namespace

#define LSTM_TM_FORM(with_cell, form)                                                     \
  case form:                                                                             \
    return launch<with_cell, form>(xw, xw_scale, w_hh_t, hs, cs, h0, c0, c_out, hf, ndir, B, \
                                   T, H, device, stream);

extern "C" {

// Kernel B1. xw (ndir, B, T, 4H), w_hh_t (ndir, H, 4H) and hs (ndir, B, T, H)
// are contiguous device pointers on `device`, f32 but for the forms. h0 and
// c0 (ndir, B, H) are the initial state and c_out (ndir, B, H) receives the
// final cell state; each may be null (zeros; not written). `form`: bit 1 the
// bf16-h form, bit 2 xw bf16, bit 4 hs bf16, which also needs hf, an f32
// buffer of 2 * ndir * B * H (else null), bit 8 the gates form, bit 16 xw
// int8 with xw_scale (ndir, B, T) f32 (else null), in the combinations of
// lstm_tm_cluster_f32.
int lstm_bidir_tm_f32(const void* xw, const void* xw_scale, const void* w_hh_t, void* hs,
                      const void* h0, const void* c0, void* c_out, void* hf, int ndir, int B,
                      int T, int H, int form, int device, void* stream) {
  void* cs = nullptr;
  switch (form) {
    LSTM_TM_FORM(false, 0)
    LSTM_TM_FORM(false, kFormH)
    LSTM_TM_FORM(false, kFormH | kFormXw)
    LSTM_TM_FORM(false, kFormXw)
    LSTM_TM_FORM(false, kFormOut)
    LSTM_TM_FORM(false, kFormXw | kFormOut)
    LSTM_TM_FORM(false, kFormH | kFormOut)
    LSTM_TM_FORM(false, kFormH | kFormXw | kFormOut)
    LSTM_TM_FORM(false, kFormGates)
    LSTM_TM_FORM(false, kFormGates | kFormXw)
    LSTM_TM_FORM(false, kFormGates | kFormOut)
    LSTM_TM_FORM(false, kFormGates | kFormXw | kFormOut)
    LSTM_TM_FORM(false, kFormGates | kFormH)
    LSTM_TM_FORM(false, kFormGates | kFormH | kFormXw)
    LSTM_TM_FORM(false, kFormGates | kFormH | kFormOut)
    LSTM_TM_FORM(false, kFormGates | kFormH | kFormXw | kFormOut)
    LSTM_TM_FORM(false, kFormI8)
    LSTM_TM_FORM(false, kFormI8 | kFormH)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel B2 fwd: as lstm_bidir_tm_f32, and cs (ndir, B, T, H) receives the
// cell state of every step; `form` and hf as there, bit 4 storing hs and cs
// in bf16 (the bf16 residuals).
int lstm_bidir_tm_fc_f32(const void* xw, const void* w_hh_t, void* hs, void* cs, void* hf,
                         int ndir, int B, int T, int H, int form, int device, void* stream) {
  const void *xw_scale = nullptr, *h0 = nullptr, *c0 = nullptr;
  void* c_out = nullptr;
  switch (form) {
    LSTM_TM_FORM(true, 0)
    LSTM_TM_FORM(true, kFormH)
    LSTM_TM_FORM(true, kFormH | kFormXw)
    LSTM_TM_FORM(true, kFormXw)
    LSTM_TM_FORM(true, kFormOut)
    LSTM_TM_FORM(true, kFormXw | kFormOut)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* lstm_tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
