// Time-major LSTM recurrence (forward), one or two directions, f32, for Hopper:
// the thread-block cluster design of kernels B1 and B2 fwd.
//
// Replaces, in speech_enhancement_by_s3prl_tpu/ops/pallas/lstm_kernel.py:
//   - lstm_bidir_pallas_tm / _kernel_tm (kernel B1: the recurrence that every
//     recurrent layer of the enhance and eval paths runs);
//   - _tm_fwd_with_cell / _kernel_tm_fc (kernel B2 fwd: the same recurrence
//     under autograd, which also writes the cell state of every step for the
//     backward in lstm_tm_bwd.cu).
// kCell adds the store of c_t and nothing else. This is the `cluster` route of
// ops/cuda/lstm_kernel.fwd_route, taken for H a multiple of 8 up to 256;
// lstm_tm.cu keeps the earlier cooperative design for any other H.
//
// Computes, for each direction d < ndir (1 or 2), batch row b and step
// t = 0 .. T-1:
//   gates = xw[d, b, t] + h_{t-1} @ w_hh_t[d]        (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// with h and c starting at zero, or at a given (h0, c0), and kept in f32.
// Direction 1 receives its own already time-flipped xw, so both directions
// walk t upward. B1 may also take an initial state h0, c0 (ndir, B, H) and
// write the final cell state cT (ndir, B, H): the carried state of a stream
// that continues chunk by chunk. Each pointer may be null (zeros in, no cT
// out); then nothing of the arithmetic differs from the stateless launch.
//
// What bounds it on this card: the T steps are strictly sequential, and a
// step is a small (rows, H) x (H, 4H) product whose operands are tiny next to
// the card's rates, so the time of one dependent step is what counts: the
// exchange of h_t between the SMs that share one direction's W_hh^T (1 MiB at
// H = 256, more than one SM holds), the reading of the weights, the loads of
// xw and the cell's arithmetic, all on the chain from h_{t-1} to h_t.
//
// Design:
// (a) One thread-block cluster of 8 per (direction, batch block), no grid
//     barrier. Block k owns U = H / 8 hidden units j0 .. j0 + U - 1 (the 4U
//     gate columns {g * H + j}); the blocks of a cluster meet once a step.
// (b) Batch blocks of `bb` rows, picked by the wrapper so that all clusters
//     are co-resident (fwd_batch_block): at small B a cluster takes one row,
//     and a cluster's step time grows with its rows. Rows are independent and
//     a row's sums run in an order that does not depend on the other rows of
//     its block, so every split gives the same bits.
// (c) The weights in registers for the whole sequence: thread (s, u), s the
//     warp (a slice of 16 inputs i = 16 s .. 16 s + 15) and u the lane (a
//     unit), holds W_hh^T[i, g * H + j0 + u] for its 16 inputs and 4 gates,
//     64 floats (512 threads a block hold the 4U x H slice, 128 KB at H = 256).
//     A step reads only h from shared memory (warp-wide broadcasts), and each
//     thread's partial gates go to shared memory; the warp of row r then adds
//     the 16 slices of its row in slice order, one lane a unit. Slices past H
//     (H < 256) hold zeros.
// (d) xw fetched ahead: the thread of (row, unit) keeps its 4 gate inputs of
//     the next kRing steps in flight with cp.async into a ring in shared
//     memory, so the load's latency is off the chain.
// (e) h_t to every block of the cluster through distributed shared memory,
//     into a double-buffered h in each block: the warp of row r stores its
//     U units to each of the 8 blocks, one lane a unit, so every remote store
//     instruction writes U contiguous floats (128 bytes at H = 256). Storing
//     16 bytes a lane instead (4 units gathered by shuffles) measured slower
//     on the card (variant kVectorPush). The cluster barrier is split:
//     arrive (release) right after the stores, wait (acquire) only before the
//     next step reads h, with the hs / cs stores and the next prefetch in
//     between. The buffer written at step t was read at step t - 1 by every
//     block before it arrived there, and a block's partial gates of step t
//     are read before its threads arrive, so one barrier a step is enough.
// lstm_tm_cluster_f32's `variant` runs B1 with one element changed (weights
// read from shared memory every step, xw loaded inside its step, 16-byte
// remote stores, a whole cluster.sync() after the stores), so that each
// element's worth is measured on the card.
//
// The bf16-h form (flag kBf16H, entries' `h_bf16`): the one-direction layer
// of the JAX package in bf16, its lax.scan cell, which rounds h_{t-1} to bf16
// for the step product only. Each block rounds the h_t it pushes to the
// cluster (and h0 where it loads it), which feeds nothing but the next step's
// product; hs, cs, c and cT keep the f32 values. With W_hh^T holding bf16
// values, each product h * w is exact in f32, so the FMAs sum exact products
// and only the order of the sum differs from the plain version's.
//
// The bf16 stream forms of the JAX package's Pallas kernels (entries' `form`
// bits 2 and 4; flags kXwBf16, kOutBf16), which change what is read and
// stored, not the f32 recurrence:
//   - kXwBf16 (SE_LSTM_XW_BF16 there): xw is bf16, widened where the cell
//     reads it. cp.async moves 4, 8 or 16 bytes, not a 2-byte element, so
//     each thread of (d) copies the 4-byte word that holds its unit's bf16
//     element (aligned down: the other half is the neighbouring unit's, and
//     H % 8 == 0 keeps the word inside the gate's row) into its own slot of
//     the ring, and takes its half. A thread reads only what it copied, as
//     in f32, so nothing waits on the other lanes; two lanes fetch each word,
//     from one 32-byte sector, so the bytes read from memory halve. Copying
//     16-byte pieces of the row across the warp instead makes every lane
//     wait for the others (__syncwarp() before the read and the refill): that
//     measured 0.07 ms more a launch than f32 at B=1 on an H100.
//   - kOutBf16 (SE_PALLAS_HS_BF16 for B1, SE_PALLAS_VJP_BF16's residuals for
//     B2 fwd): hs (and cs under kCell) stored rounded to bf16; h, c, the
//     exchange and cT stay f32.
//
// The forms that change B1's function (entries' `form` bits 8 and 16; flags
// kGatesBf16, kXwInt8; B1 only, as the JAX package reads them only there):
//   - kGatesBf16 (SE_PALLAS_GATES_BF16 on the Pallas B1): the cell takes the
//     gate pre-activations rounded to bf16, i, f, o = bf16(bf16(tanh(x / 2))
//     / 2 + 1/2) and g = bf16(tanh(x)) (each transcendental pass in f32 on a
//     bf16 value, rounded), i * g rounded to bf16, then c and h in f32.
//     Beside kBf16H (h rounded for the product) and W_hh^T holding bf16
//     values it is JAX's SE_PALLAS_MXU_BF16 with SE_PALLAS_GATES_BF16;
//     kBf16H also composes with kOutBf16 (the MXU form under
//     SE_PALLAS_HS_BF16).
//   - kXwInt8 (SE_LSTM_XW_INT8 on the scan, a one-direction layer): xw is
//     int8 with one f32 scale a (direction, row, step), and a step reads
//     q * scale in f32 (one rounded product, then the partials added as in
//     f32). As under kXwBf16, each thread copies the aligned 4-byte word that
//     holds its unit's int8 element into its slot of the ring (H % 8 == 0
//     keeps the word inside the gate's row, whose 4H bytes keep every word
//     aligned), and takes its byte; the scale of the step rides the ring as a
//     fifth slot, copied by every lane of the row's warp.
// The flags are template parameters, so the f32 instances keep their code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16_round.cuh"
#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kUnits = 32;                          // most units a block owns (H / 8)
constexpr int kSlices = 16;                         // a warp a slice of the inputs
constexpr int kThreads = kUnits * kSlices;          // 512
constexpr int kSliceLen = 16;                       // inputs a thread owns
constexpr int kHPad = kSlices * kSliceLen;          // 256: h rows, zeros past H
constexpr int kMaxRows = kThreads / kUnits;         // 16: a warp a row in the cell
constexpr int kRing = 4;                            // steps of xw in flight

// variants that change one element of the design (measurement only)
constexpr int kSmemWeights = 1;  // (c) off: W_hh^T slice in shared memory
constexpr int kLoadInStep = 2;   // (d) off: xw loaded at the start of its step
constexpr int kVectorPush = 4;   // (e) 16-byte remote stores gathered by shuffles
constexpr int kFullSync = 8;     // (e) off: cluster.sync() right after the stores
// the bf16-h form: h rounded to bf16 for the step product (variant 0 only)
constexpr int kBf16H = 16;
// the stream forms (variant 0 only): xw read as bf16; hs (and cs) stored as bf16
constexpr int kXwBf16 = 32;
constexpr int kOutBf16 = 64;
// B1's forms of other functions (variant 0 only): the gates in bf16; an int8
// xw with its scale
constexpr int kGatesBf16 = 128;
constexpr int kXwInt8 = 256;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The gates form's sigmoid of a bf16 value x (JAX spells it in bf16 as
// tanh(x / 2) / 2 + 1/2): each pass rounded to bf16, the halvings exact.
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return bf16_round(bf16_round(tanhf(x * 0.5f)) * 0.5f + 0.5f);
}

// The int8 element at byte `byte` of a 4-byte word held in a float's bits,
// widened to f32.
__device__ __forceinline__ float int8_byte(float word, int byte) {
  return (float)(int8_t)(__float_as_uint(word) >> (8 * byte));
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

// Dynamic shared memory, bb rows allocated:
//   part_s [bb][kSlices][kUnits]      float4  partial gates of (row, slice, unit)
//   h_s    [2][bb][kHPad]             float   h_{t-1} / h_t of the batch block
//   xw_s   [kRing][S][bb][kUnits]     float   xw of the ring's steps (under
//                                             kXwBf16 / kXwInt8 the word
//                                             holding it), S = 4 gates, and
//                                             under kXwInt8 the step's scale
//   w_s    [kHPad][kUnits]            float4  the weights (kSmemWeights only)
// h0, c0 and c_out are (ndir, B, H) or null; xw_scale (ndir, B, T) under
// kXwInt8, else null.
template <bool kCell, int kFlags>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
lstm_tm_cluster_kernel(const float* __restrict__ xw, const float* __restrict__ xw_scale,
                       const float* __restrict__ w_hh_t, float* __restrict__ hs,
                       float* __restrict__ cs, const float* __restrict__ h0,
                       const float* __restrict__ c0, float* __restrict__ c_out, int B, int T,
                       int H, int bb) {
  constexpr bool kWs = kFlags & kSmemWeights;
  constexpr bool kRingOn = !(kFlags & kLoadInStep);
  constexpr bool kRoundH = kFlags & kBf16H;
  constexpr bool kXwB = kFlags & kXwBf16;
  constexpr bool kXwI8 = kFlags & kXwInt8;
  constexpr bool kGatesB = kFlags & kGatesBf16;
  constexpr int kSlots = kXwI8 ? 5 : 4;  // the ring's slots a step
  using OutT = std::conditional_t<(kFlags & kOutBf16) != 0, __nv_bfloat16, float>;
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
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool live = lane < U;

  float4* part_s = smem4;
  float* h_s = reinterpret_cast<float*>(part_s + bb * kSlices * kUnits);
  float* xw_s = h_s + 2 * bb * kHPad;
  float4* w_s = reinterpret_cast<float4*>(xw_s + kRing * kSlots * bb * kUnits);
  const int ring_gate = bb * kUnits;  // stride of a gate in the ring

  // (c) this thread's 16 inputs x 4 gates of unit j0 + lane
  float4 w[kSliceLen];
  {
    const float* whh = w_hh_t + (size_t)d * H * H4 + j0 + lane;
#pragma unroll
    for (int k = 0; k < kSliceLen; ++k) {
      const int i = warp * kSliceLen + k;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live && i < H) {
        const float* p = whh + (size_t)i * H4;
        v = make_float4(__ldg(p), __ldg(p + H), __ldg(p + 2 * H), __ldg(p + 3 * H));
      }
      if (kWs) {
        w_s[i * kUnits + lane] = v;
      } else {
        w[k] = v;
      }
    }
  }
  // slot 0 holds h_{-1}: every block needs all H units of its rows, so every
  // block loads its rows of h0 there (zeros past H, and without h0)
  for (int idx = tid; idx < 2 * bb * kHPad; idx += kThreads) {
    const int r = idx / kHPad, i = idx % kHPad;
    const float v = (h0 != nullptr && r < rows && i < H)
                        ? h0[((size_t)d * B + b0 + r) * H + i] : 0.0f;
    h_s[idx] = kRoundH ? bf16_round(v) : v;
  }

  // the cell's side: warp `row` is batch row b0 + row, lane the unit
  const int row = warp;
  const bool cell = row < rows && live;
  const size_t at = ((size_t)d * B + b0 + (cell ? row : 0)) * T;
  const float* xw_p = xw + at * H4 + j0 + (cell ? lane : 0);
  OutT* hs_p = reinterpret_cast<OutT*>(hs) + at * H + j0 + (cell ? lane : 0);
  OutT* cs_p = kCell ? reinterpret_cast<OutT*>(cs) + at * H + j0 + (cell ? lane : 0) : nullptr;
  float* ring_p = xw_s + row * kUnits + lane;
  // kXwBf16: the 4-byte word of the bf16 xw holding this thread's element
  // (at * H4 and g * H are even, so the half is the same at every step and
  // gate), and which half it is
  const uint32_t* xww_p =
      reinterpret_cast<const uint32_t*>(xw) + ((at * H4 + j0 + (cell ? lane : 0)) >> 1);
  const bool xw_hi = (j0 + lane) & 1;
  // kXwInt8: the 4-byte word of the int8 xw holding this thread's element
  // (at * H4 and g * H are multiples of 4, so the byte is the same at every
  // step and gate), which byte it is, and the row's scales
  const uint32_t* xwq_p =
      reinterpret_cast<const uint32_t*>(xw) + ((at * H4 + j0 + (cell ? lane : 0)) >> 2);
  const int xw_byte = (j0 + lane) & 3;
  const float* scale_p = kXwI8 ? xw_scale + at : nullptr;
  const size_t state_at = ((size_t)d * B + b0 + (cell ? row : 0)) * H + j0 + (cell ? lane : 0);
  float c = (c0 != nullptr && cell) ? c0[state_at] : 0.0f;

  // (d) xw of step t into ring slot t % kRing: one group a step, empty past T
  auto prefetch = [&](int t) {
    if (t < T) {
      float* dst = ring_p + (t % kRing) * kSlots * ring_gate;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (kXwI8) {
          cp_async4(dst + g * ring_gate,
                    reinterpret_cast<const float*>(xwq_p + (size_t)t * H + g * (H / 4)), 4);
        } else if (kXwB) {
          cp_async4(dst + g * ring_gate,
                    reinterpret_cast<const float*>(xww_p + (size_t)t * (H4 / 2) + g * (H / 2)),
                    4);
        } else {
          cp_async4(dst + g * ring_gate, xw_p + (size_t)t * H4 + g * H, 4);
        }
      }
      if (kXwI8) cp_async4(dst + 4 * ring_gate, scale_p + t, 4);
    }
    cp_async_commit();
  };
  if (kRingOn && cell) {
    for (int t = 0; t < kRing; ++t) prefetch(t);
  }

  cluster.sync();  // every block's h_s is set before a remote store lands

  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (t & 1) * bb * kHPad;
    float* h_nxt = h_s + ((t + 1) & 1) * bb * kHPad;
    if (t > 0 && !(kFlags & kFullSync)) cluster_wait_acquire();  // h_{t-1} has landed
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!kRingOn && cell) {  // the f32 design's variant only
      const float* xp = xw_p + (size_t)t * H4;
      x = make_float4(xp[0], xp[H], xp[2 * H], xp[3 * H]);
    }

    // partial gates of every row over this warp's 16 inputs
    for (int r = 0; r < rows; ++r) {
      const float4* hp = reinterpret_cast<const float4*>(h_cur + r * kHPad + warp * kSliceLen);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kSliceLen / 4; ++q) {
        const float4 hv = hp[q];
        const int k = 4 * q;
        if (kWs) {
          const float4* wq = w_s + (warp * kSliceLen + k) * kUnits + lane;
          fma4(acc, hv.x, wq[0]);
          fma4(acc, hv.y, wq[kUnits]);
          fma4(acc, hv.z, wq[2 * kUnits]);
          fma4(acc, hv.w, wq[3 * kUnits]);
        } else {
          fma4(acc, hv.x, w[k]);
          fma4(acc, hv.y, w[k + 1]);
          fma4(acc, hv.z, w[k + 2]);
          fma4(acc, hv.w, w[k + 3]);
        }
      }
      part_s[(r * kSlices + warp) * kUnits + lane] = acc;
    }
    __syncthreads();

    float h = 0.0f;
    if (row < rows) {  // uniform over the warp
      if (live) {
        if (kRingOn) {
          cp_async_wait<kRing - 1>();  // this thread's copy of step t has landed
          const float* xs = ring_p + (t % kRing) * kSlots * ring_gate;
          if (kXwI8) {
            // q * scale rounded once, as JAX's xw_t.astype(f32) * scale_t
            const float sc = xs[4 * ring_gate];
            x = make_float4(__fmul_rn(int8_byte(xs[0], xw_byte), sc),
                            __fmul_rn(int8_byte(xs[ring_gate], xw_byte), sc),
                            __fmul_rn(int8_byte(xs[2 * ring_gate], xw_byte), sc),
                            __fmul_rn(int8_byte(xs[3 * ring_gate], xw_byte), sc));
          } else if (kXwB) {
            x = make_float4(bf16_half(xs[0], xw_hi), bf16_half(xs[ring_gate], xw_hi),
                            bf16_half(xs[2 * ring_gate], xw_hi),
                            bf16_half(xs[3 * ring_gate], xw_hi));
          } else {
            x = make_float4(xs[0], xs[ring_gate], xs[2 * ring_gate], xs[3 * ring_gate]);
          }
        }
        // xw, then the 16 slices in order
        const float4* ps = part_s + row * kSlices * kUnits + lane;
#pragma unroll 4
        for (int s = 0; s < kSlices; ++s) {
          const float4 p = ps[s * kUnits];
          x.x += p.x;
          x.y += p.y;
          x.z += p.z;
          x.w += p.w;
        }
        if (kGatesB) {
          const float ig = sigmoid_bf16(bf16_round(x.x));
          const float fg = sigmoid_bf16(bf16_round(x.y));
          const float gg = bf16_round(tanhf(bf16_round(x.z)));
          const float og = sigmoid_bf16(bf16_round(x.w));
          c = fmaf(fg, c, bf16_round(ig * gg));
          h = og * tanhf(c);
        } else {
          const float ig = sigmoid_f32(x.x);
          const float fg = sigmoid_f32(x.y);
          const float gg = tanhf(x.z);
          const float og = sigmoid_f32(x.w);
          c = fmaf(fg, c, ig * gg);
          h = og * tanhf(c);
        }
      }
      // (e) h_t of this row to all 8 blocks, rounded in the bf16-h form
      const float h_push = kRoundH ? bf16_round(h) : h;
      float* dst_row = h_nxt + row * kHPad + j0;
      if ((kFlags & kVectorPush) && U % 4 == 0) {
        const int nq = U / 4;  // 16-byte pieces of the row's U units
        for (int base = 0; base < nq * kCluster; base += 32) {
          const int idx = base + lane;
          const int q = idx % nq;
          float4 v;
          v.x = __shfl_sync(0xffffffffu, h_push, 4 * q);
          v.y = __shfl_sync(0xffffffffu, h_push, 4 * q + 1);
          v.z = __shfl_sync(0xffffffffu, h_push, 4 * q + 2);
          v.w = __shfl_sync(0xffffffffu, h_push, 4 * q + 3);
          if (idx < nq * kCluster)
            reinterpret_cast<float4*>(cluster.map_shared_rank(dst_row, idx / nq))[q] = v;
        }
      } else if (live) {
#pragma unroll
        for (int k = 0; k < kCluster; ++k) cluster.map_shared_rank(dst_row, k)[lane] = h_push;
      }
    }
    if (kFlags & kFullSync) {
      cluster.sync();
    } else {
      cluster_arrive_release();
    }
    if (cell) {
      hs_p[(size_t)t * H] = narrow<OutT>(h);
      if (kCell) cs_p[(size_t)t * H] = narrow<OutT>(c);
      if (kRingOn) prefetch(t + kRing);
    }
  }
  if (c_out != nullptr && cell) c_out[state_at] = c;
  // no block leaves while a store into its shared memory may be in flight
  if (!(kFlags & kFullSync)) cluster_wait_acquire();
}

size_t smem_bytes(int bb, int flags) {
  const size_t slots = (flags & kXwInt8) ? 5 : 4;
  return sizeof(float4) * (size_t)bb * kSlices * kUnits +
         sizeof(float) * ((size_t)2 * bb * kHPad + (size_t)kRing * slots * bb * kUnits) +
         ((flags & kSmemWeights) ? sizeof(float4) * kHPad * kUnits : 0);
}

template <bool kCell, int kFlags>
int launch(const void* xw, const void* xw_scale, const void* w_hh_t, void* hs, void* cs,
           const void* h0, const void* c0, void* c_out, int ndir, int B, int T, int H, int bb,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndir < 1 || ndir > 2 || B <= 0 || T <= 0 || H <= 0 || H % kCluster ||
      H / kCluster > kUnits || bb < 1 || bb > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bb, kFlags);
  int smem_optin = 0;
  if ((err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)))
    return (int)err;
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  if ((kFlags & (kXwBf16 | kXwInt8)) && reinterpret_cast<uintptr_t>(xw) % 4)
    return (int)cudaErrorMisalignedAddress;  // the 4-byte words of the bf16 / int8 fetch
  if ((kFlags & kXwInt8) && (xw_scale == nullptr || reinterpret_cast<uintptr_t>(xw_scale) % 4))
    return (int)cudaErrorInvalidValue;
  auto fn = lstm_tm_cluster_kernel<kCell, kFlags>;
  if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return (int)err;
  const int nbb = (B + bb - 1) / bb;
  lstm_tm_cluster_kernel<kCell, kFlags><<<ndir * nbb * kCluster, kThreads, smem,
                                          (cudaStream_t)stream>>>(
      (const float*)xw, (const float*)xw_scale, (const float*)w_hh_t, (float*)hs, (float*)cs,
      (const float*)h0, (const float*)c0, (float*)c_out, B, T, H, bb);
  return (int)cudaGetLastError();
}

template <bool kCell>
int max_clusters(int device, int* out) {
  auto fn = lstm_tm_cluster_kernel<kCell, 0>;
  const size_t smem = smem_bytes(kMaxRows, 0);
  cudaError_t err = cudaSetDevice(device);  // the query is of the device asked about
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)fn, &config);
}

// The flags of an entry's `form`: bit 1 the bf16-h form, bit 2 a bf16 xw,
// bit 4 bf16 hs (and cs), bit 8 the gates form, bit 16 an int8 xw.
int form_flags(int form) {
  return ((form & 1) ? kBf16H : 0) | ((form & 2) ? kXwBf16 : 0) | ((form & 4) ? kOutBf16 : 0) |
         ((form & 8) ? kGatesBf16 : 0) | ((form & 16) ? kXwInt8 : 0);
}

}  // namespace

extern "C" {

// Kernel B1. xw (ndir, B, T, 4H), w_hh_t (ndir, H, 4H) and hs (ndir, B, T, H)
// are contiguous f32 device pointers on `device`; ndir 1 or 2, H a multiple of
// 8 and at most 256, 1 <= batch_block <= 16. h0 and c0 (ndir, B, H) are the
// initial state, c_out (ndir, B, H) receives the final cell state; each may
// be null (zeros; not written). `variant` 0 is the design; for
// measurement, 1 reads the weights from shared memory every step (batch_block
// <= 8), 2 loads xw inside its step, 4 makes the remote stores 16 bytes a
// lane, 8 puts a whole cluster barrier after them. `form` (variant 0 only):
// bit 1 the bf16-h form, bit 2 xw bf16 (4-byte aligned), bit 4 hs bf16, bit 8
// the gates form, bit 16 xw int8 (4-byte aligned) with xw_scale (ndir, B, T)
// f32 (else null), in the combinations the JAX package runs: the Pallas B1's
// (bf16-h, xw f32 or bf16, hs f32 or bf16, gates or not) and the scan's
// (bf16-h or not, xw f32, bf16 or int8). Returns the first non-zero
// CUDA status among the set-up calls and cudaGetLastError() after the launch
// (which reports a cluster that cannot be placed); 0 on success. Does not
// synchronise.
int lstm_tm_cluster_f32(const void* xw, const void* xw_scale, const void* w_hh_t, void* hs,
                        const void* h0, const void* c0, void* c_out, int ndir, int B, int T,
                        int H, int batch_block, int variant, int form, int device,
                        void* stream) {
#define LSTM_TM_CLUSTER_VARIANT(flags)                                                    \
  case flags:                                                                           \
    return launch<false, flags>(xw, xw_scale, w_hh_t, hs, nullptr, h0, c0, c_out, ndir, B, \
                                T, H, batch_block, device, stream);
  if (form) {
    if (variant != 0) return (int)cudaErrorInvalidValue;
    variant = form_flags(form);
  }
  switch (variant) {
    LSTM_TM_CLUSTER_VARIANT(0)
    LSTM_TM_CLUSTER_VARIANT(kSmemWeights)
    LSTM_TM_CLUSTER_VARIANT(kLoadInStep)
    LSTM_TM_CLUSTER_VARIANT(kVectorPush)
    LSTM_TM_CLUSTER_VARIANT(kFullSync)
    LSTM_TM_CLUSTER_VARIANT(kBf16H)
    LSTM_TM_CLUSTER_VARIANT(kBf16H | kXwBf16)
    LSTM_TM_CLUSTER_VARIANT(kXwBf16)
    LSTM_TM_CLUSTER_VARIANT(kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kXwBf16 | kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kBf16H | kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kBf16H | kXwBf16 | kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16 | kXwBf16)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16 | kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16 | kXwBf16 | kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16 | kBf16H)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16 | kBf16H | kXwBf16)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16 | kBf16H | kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kGatesBf16 | kBf16H | kXwBf16 | kOutBf16)
    LSTM_TM_CLUSTER_VARIANT(kXwInt8)
    LSTM_TM_CLUSTER_VARIANT(kXwInt8 | kBf16H)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LSTM_TM_CLUSTER_VARIANT
}

// Kernel B2 fwd: as lstm_tm_cluster_f32 with variant 0, and cs (ndir, B, T,
// H) receives the cell state of every step; `form` as there, bit 4 storing
// hs and cs in bf16 (the bf16 residuals).
int lstm_tm_cluster_fc_f32(const void* xw, const void* w_hh_t, void* hs, void* cs, int ndir,
                           int B, int T, int H, int batch_block, int form, int device,
                           void* stream) {
#define LSTM_TM_CLUSTER_FORM(flags)                                                    \
  case flags:                                                                        \
    return launch<true, flags>(xw, nullptr, w_hh_t, hs, cs, nullptr, nullptr, nullptr, ndir, \
                               B, T, H, batch_block, device, stream);
  switch (form_flags(form)) {
    LSTM_TM_CLUSTER_FORM(0)
    LSTM_TM_CLUSTER_FORM(kBf16H)
    LSTM_TM_CLUSTER_FORM(kBf16H | kXwBf16)
    LSTM_TM_CLUSTER_FORM(kXwBf16)
    LSTM_TM_CLUSTER_FORM(kOutBf16)
    LSTM_TM_CLUSTER_FORM(kXwBf16 | kOutBf16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LSTM_TM_CLUSTER_FORM
}

// The number of 8-block clusters of this kernel that the card holds at once
// (the smaller of B1's and B2 fwd's), into *clusters; returns the CUDA status.
int lstm_tm_cluster_max_clusters(int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int a = 0, b = 0;
  int rc = max_clusters<false>(device, &a);
  if (rc) return rc;
  if ((rc = max_clusters<true>(device, &b))) return rc;
  *clusters = a < b ? a : b;
  return 0;
}

const char* lstm_tm_cluster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
