// The bf16-h form's dW_hh^T (ops/cuda/lstm_kernel.lstm_bidir_tm_dw_bf16), for
// Hopper.
//
// Replaces no Pallas kernel of its own: it is the dW_hh^T of the JAX
// package's one-direction lax.scan cell in bf16 (models/lstm.py, the cell
// reached through LstmCellScan), whose reverse scan carries the cotangent of
// the bf16 W_hh^T as a bf16 value and rounds after every step:
//   acc = 0;  for t = T-1 .. 1:  acc = bf16(acc + bf16(sum_b bf16(h_{t-1,b})^T da_{t,b}))
// (h_{-1} = 0 adds nothing at t = 0). hs (ndir, B, T, H) and da (ndir, B, T,
// 4H), the bf16-h backward's dxw, are f32; dW_hh^T (ndir, H, 4H) is written
// in f32 holding bf16 values. A sum rounded after every step cannot be split
// over t: the only parallel work is over the H x 4H elements.
//
// The first design (formerly in lstm_tm_bwd.cu: a thread 4 elements, the step's
// sum an FMA chain over the rows in row order, runs of steps staged by
// cp.async with runtime division by B, h rounded where staged) took 0.64 ms at
// B = 6, T = 1001, H = 256 on an H100 (0.19 at B = 1). Variants of it in a
// development build told its suspects apart (PERF.md, section 6): B as a template
// argument (the row loop unrolled, the staging's divisions by a constant)
// halved it (0.34; 0.094), no loads at all 0.39 (0.16), no rounded carry 0.60
// (0.16), staging alone 0.28 (0.05). Runtime B in the inner loops bound it
// first, then the FMAs and loads of about a dozen instructions an element and
// step on 16 warps an SM; occupancy was not the limit.
//
// Design:
//   - The step product on the tensor cores, wgmma m64n32k16 bf16 with f32
//     sums, A from registers and B from shared memory: M = 64 inputs i, N =
//     32 gate columns c, K = slots of the batch rows. bf16(h) is exact in
//     bf16; da in f32 is split into three bf16 terms, hi = bf16(da), mid =
//     bf16(da - hi), lo = da - hi - mid, which hold its 24 bits exactly (any
//     normal da above 2^-100). A k16 slice holds four batch rows: slots 2q,
//     2q + 1 the pair (hi, mid) of row q and slots 8 + 2q, 9 + 2q the pair
//     (lo, 0), each against (h, h) of row q, so that every product is exact
//     and lane 4g + q of the A fragment holds row q alone (one 4-byte word,
//     bf16 h at inputs g and g + 8, widened by two byte permutes). The tensor
//     core sums the products in its own order, so the step sum can differ from
//     the plain version's f32 row-order sum in its last bits, and bf16(p) then
//     in one unit where p lies at a rounding boundary: 99.99% of the elements
//     are identical at T = 1001 (phase 13 (a) of chip_smoke.py holds the
//     share within one unit).
//   - The carry as packed bf16x2: r = bf16(p) two elements at a time
//     (cvt.rn.bf16x2.f32), acc = acc + r by add.rn.bf16x2. The sum of two
//     bf16 numbers is exact in f32 whenever it can round differently, so one
//     rounding of it gives the plain version's bf16(acc + r) bit for bit. The
//     accumulator's layout is the carry's: each thread keeps its 16 elements'
//     carries in registers for all of T, and a step's first wgmma starts from
//     zero. One instruction an element and step (the SASS: 8 F2FP and 8 HADD2
//     a thread and step for 16 elements).
//   - A block owns 64 inputs x 32 columns of one direction (H = 256: 4 x 32
//     = 128 blocks, one an SM): one multiplying warpgroup and 8 converter
//     warps. The converters stage runs of 16 steps (32 for B <= 4) of the
//     block's h_{t-1} (64 floats a row) and da_t (32 floats) for every batch
//     row by 16-byte cp.async (4-byte pieces where H % 4 != 0, whose rows TMA
//     cannot take), the next run in flight, and turn each run into its
//     fragments once per element: A words (bf16 h pairs) and the B tiles
//     wgmma reads (the split of da), a run ahead of the warpgroup, behind
//     named barriers (full / free per fragment buffer). The warpgroup walks a
//     run's steps keeping three steps' wgmma in flight ahead of the carry: a
//     step's product depends on no other step, only the carry is serial.
//   - Measured in a development build, in turn: a barrier-bound first version
//     of this design (all threads staging, converting, then multiplying), 0.22
//     ms at B = 6; mma.sync products (16 cycles an m16n8k16 on a quarter SM)
//     and fragment layouts that met banks twice; converter items that the
//     compiler serialised (a store between every two loads: the staged rows
//     and the fragments share one array); the cost of a run's cp.async group
//     whatever its size, which longer runs amortise (a deeper ring did not);
//     and wgmma serialised by a wait after each until a step's A registers
//     were written before its fence. Loads at B = 6 move ~295 MB through L2
//     (hs read by the 32 column blocks, da by the 4 input blocks), near its
//     rate.
//   - No division in the loops: a thread's staging piece is its step and
//     place in the row; the rows of a group are a template constant (4: B <=
//     4, one k16 slice; 8: two slices), and B > 8 takes groups of 8 rows in a
//     loop with fewer steps a run, down to one step a run where one step's
//     rows just fit the shared memory (kChunkRows, 136 on an H100).
//   - Any B: past kChunkRows a step's rows are staged in C chunks of equal
//     groups (G = ceil(B / 8) groups in chunks of ceil(G / C)), one chunk a
//     run of one step. A chunk's slices go in wgmma chains of kChainGroups
//     groups (32 rows), each from zero in a second set of accumulators and
//     added to the step's sum in f32 (to nearest) once its wgmma are done;
//     the step's first chain is its sum. The warpgroup waits for a chunk's
//     products before it frees the chunk's fragment buffer and carries after
//     the last chunk only, so the step's one bf16 rounding comes after its
//     last chunk. Short chains, not one over all rows: the tensor cores' f32
//     accumulation loses low bits of the products as the running sum grows,
//     so that one chain over 352 rows fails phase 13's share within one bf16
//     unit of the plain version, and one chain a chunk of 136 rows comes
//     within 2e-4 of it at B = 352 (an H100, PERF.md). Rows past B in the
//     last chunk get zero fragments, since its buffer held an earlier chunk.
//     At B <= kChunkRows (C = 1) nothing of this runs: those B keep their
//     bits.
//   - No atomics, no reduction across blocks: the same bits on every run.
//     Any H: inputs past H and columns past 4H are staged as zeros and not
//     stored.
// What bounds it: per element and step, one instruction of the carry on the
// CUDA cores ((T - 1) H 4H instructions at 128 a clock and SM, 33.5 T/s:
// 0.0078 ms at T = 1001, H = 256, at any B); the products, three bf16 passes
// of 2 B (T - 1) H 4H operations at 989 TFLOP/s (0.0095 ms at B = 6, 0.0016
// at B = 1); the bytes, hs and da read once and dW_hh^T written (31.8 MB at B
// = 6: 0.0095 ms at 3.35 TB/s). So 0.0095 ms at B = 6 and 0.0078 at B = 1, by
// operations. The first design's bound counted only the row FMAs at the f32
// rate (0.047 ms at B = 6, 0.0078 at B = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "hopper.cuh"

namespace {

constexpr int kI = 64;             // inputs (rows of dW_hh^T) a block
constexpr int kC = 32;             // gate columns a block
constexpr int kMmaWarps = 4;       // one warpgroup: m tile = warp, all 4 n tiles
constexpr int kConvWarps = 8;      // A of 4 m tiles, B of 4 n tiles
constexpr int kConvThreads = 32 * kConvWarps;
constexpr int kThreads = 32 * kMmaWarps + kConvThreads;
constexpr int kS = 16;             // steps a run at most (twice as many for B <= 4)
constexpr int kStages = 2;         // staged runs: one converted, one in flight
constexpr int kFrags = 2;          // fragment buffers: one converted, one multiplied
constexpr int kHRow = kI + 8;      // floats a staged h row (conflict-free gathers)
constexpr int kARow = kC + 8;      // floats a staged da row
// bytes a batch row of one step takes: its staged h and da rows and its
// fragments (a uint32 of A per input pair, a uint2 of B per column)
constexpr int kRowBytes = kStages * 4 * (kHRow + kARow) + kFrags * 384;
constexpr int kSmemOptin = 232448;  // an H100 block's shared memory
// the most rows a run of one step stages at once (the wrapper's
// DW_BF16_CHUNK_ROWS); a larger B takes chunks of at most this many
constexpr int kChunkRows = kSmemOptin / kRowBytes / 8 * 8;  // 136
// groups of 8 rows a wgmma chain of a step's sum takes past one chunk (the
// wrapper's DW_BF16_CHAIN_ROWS / 8)
constexpr int kChainGroups = 4;
// named barriers: fragment buffer k full (1 + k) and free (3 + k), among all
// threads; the converters' own (5)
constexpr int kBarFull = 1, kBarFree = 1 + kFrags, kBarConv = 1 + 2 * kFrags;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Arrives without waiting; the caller's shared-memory writes before it are
// visible to the threads that wait at bar_sync on the same barrier.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + mid + lo with each term a bf16 number, for two values x0 and x1
// at once: the B pairs of each, (hi, mid) and (lo, 0), the lower slot in the
// low half. Packed conversions (cvt.rn.bf16x2.f32) and byte permutes.
__device__ __forceinline__ void split3x2(float x0, float x1, uint2& b0, uint2& b1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hi);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mid);
  const uint32_t lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
  b0 = make_uint2(__byte_perm(bits(hi), bits(mid), 0x5410), lo & 0xffffu);
  b1 = make_uint2(__byte_perm(bits(hi), bits(mid), 0x7632), lo >> 16);
}

// The A fragment of a lane from its word (bf16 h(g) low, bf16 h(g + 8) high):
// each twice, for the slots (hi, mid) of its row and again for (lo, 0).
__device__ __forceinline__ uint4 a_frag(uint32_t u) {
  const uint32_t lo = __byte_perm(u, u, 0x1010), hi = __byte_perm(u, u, 0x3232);
  return make_uint4(lo, hi, lo, hi);
}

// kSl k16 slices (4 batch rows each) a group; kMulti: G groups of 8 rows
// (B > 8) a run, in C chunks a step (C > 1: one step a run), else one group.
// S steps a run (kSteps unless kMulti), vec: h rows 16-byte aligned (H % 4 ==
// 0).
template <int kSl, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1)
lstm_dw_bf16_kernel(const float* __restrict__ hs, const float* __restrict__ da,
                    float* __restrict__ dwhh, int B, int T, int H, int G_arg, int S_arg,
                    int C_arg, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = 4 * kSl;  // rows of a group
  constexpr int kSteps = kSl == 1 ? 2 * kS : kS;
  const int G = kMulti ? G_arg : 1;
  const int S = kMulti ? S_arg : kSteps;
  const int C = kMulti ? C_arg : 1;
  const int Bp = R * G;  // staged rows of a run (a chunk), padded with zeros
  const int H4 = 4 * H;
  const int i0 = blockIdx.x * kI, c0 = blockIdx.y * kC, d = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int runs = T > 1 ? (T - 1 + S - 1) / S * C : 0;
  const int slabs = S * G * kSl;  // (step, group, slice) a run

  // [kStages staged runs: h (S, Bp, kHRow), da (S, Bp, kARow)] [kFrags
  // fragment buffers: A (slabs, 4 m tiles, 32 lanes) uint32, then B (slabs)
  // as wgmma reads it, K-major without swizzle: 8-column core matrices of 8
  // columns x 16 bytes, (n tile, slots 0-7 or 8-15) at 256 n tile + 128
  // half bytes]
  const int stage = S * Bp * (kHRow + kARow);
  uint32_t* const frags = reinterpret_cast<uint32_t*>(smem + kStages * stage);
  const int frag = slabs * 384;  // uint32 of one buffer

  // rows past B are never staged and fragments of those rows never written:
  // zeros, once
  for (int k = tid; k < kStages * stage + frag * kFrags; k += kThreads) smem[k] = 0.f;
  hopper::fence_proxy_async();  // the zeros of the B tiles, for wgmma's reads
  __syncthreads();

  if (warp >= kMmaWarps) {
    // converters: stage run r + 1 by cp.async while run r is turned into
    // fragments, a run ahead of the multiplying warps
    const int tc = tid - 32 * kMmaWarps, cw = tc >> 5;
    // run -> (its steps, its chunk's rows lo .. hi - 1)
    auto rows_of = [&](int run, int& lo, int& hi) {
      lo = (run % C) * Bp;
      hi = min(B, lo + Bp);
    };
    auto start = [&](int run) {
      float* const h_s = smem + (run % kStages) * stage;
      float* const a_s = h_s + S * Bp * kHRow;
      const int t_hi = T - 1 - run / C * S;
      int lo, hi;
      rows_of(run, lo, hi);
      // a run's rows of h (16 pieces of 4 floats) and da (8 pieces) for every
      // batch row: a thread's piece is its step and place in the row, its
      // rows every kRows-th
      {
        constexpr int kPieces = 16 * kSteps;
        constexpr int kRows = kConvThreads > kPieces ? kConvThreads / kPieces : 1;
#pragma unroll
        for (int it = 0; it * kConvThreads < kPieces; ++it) {
          const int idx = tc % kPieces + it * kConvThreads, b0 = tc / kPieces;
          const int k = idx & 15, s = idx >> 4, t = t_hi - s, i = i0 + 4 * k;
          if (s >= S) continue;
          float* dst = h_s + (s * Bp + b0) * kHRow + 4 * k;
          const float* src =
              hs + ((size_t)d * B + lo + b0) * T * H + (ptrdiff_t)(t - 1) * H + i;
          const size_t step_b = (size_t)kRows * T * H;
          if (vec) {
            const bool ok = t >= 1 && i < H;
            for (int b = lo + b0; b < hi; b += kRows, dst += kRows * kHRow, src += step_b)
              cp_async16(dst, ok ? src : hs, ok ? 16 : 0);
          } else {
            for (int b = lo + b0; b < hi; b += kRows, dst += kRows * kHRow, src += step_b) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const bool ok = t >= 1 && i + e < H;
                cp_async4(dst + e, ok ? src + e : hs, ok ? 4 : 0);
              }
            }
          }
        }
      }
      {
        constexpr int kPieces = 8 * kSteps;
        constexpr int kRows = kConvThreads > kPieces ? kConvThreads / kPieces : 1;
#pragma unroll
        for (int it = 0; it * kConvThreads < kPieces; ++it) {
          const int idx = tc % kPieces + it * kConvThreads, b0 = tc / kPieces;
          const int k = idx & 7, s = idx >> 3, t = t_hi - s, c = c0 + 4 * k;
          if (s >= S) continue;
          const bool ok = t >= 1 && c < H4;
          float* dst = a_s + (s * Bp + b0) * kARow + 4 * k;
          const float* src = da + ((size_t)d * B + lo + b0) * T * H4 + (ptrdiff_t)t * H4 + c;
          const size_t step_b = (size_t)kRows * T * H4;
          for (int b = lo + b0; b < hi; b += kRows, dst += kRows * kARow, src += step_b)
            cp_async16(dst, ok ? src : da, ok ? 16 : 0);
        }
      }
      cp_async_commit();
    };
    if (runs == 0) return;
    for (int run = 0; run < kStages - 1; ++run) {
      if (run < runs) start(run); else cp_async_commit();
    }
    // A warp's role, one tile of every slab: A of m tile `tile` (kind 0) or
    // B of n tile `tile`. Lane 4g + q takes row q of the slice: A its word
    // (bf16 h at inputs g and g + 8), B the pairs (hi, mid) and (lo, 0) of
    // da at column g. Rows past B are skipped: their zeros stand.
    const int kind = cw >> 2, tile = cw & 3, g = lane >> 2, q = lane & 3;
    for (int run = 0; run < runs; ++run) {
      cp_async_wait<kStages - 2>();  // this thread's copies of the run have landed
      // every converter's have, and every converter is done with run - 1,
      // whose staged buffer the copies of run + kStages - 1 take
      bar_sync(kBarConv, kConvThreads);
      if (run + kStages - 1 < runs) start(run + kStages - 1); else cp_async_commit();
      const int k = run % kFrags;
      if (run >= kFrags) bar_sync(kBarFree + k, kThreads);
      const float* h_s = smem + (run % kStages) * stage;
      const float* a_s = h_s + S * Bp * kHRow;
      uint32_t* const fa = frags + k * frag + tile * 32 + lane;
      uint32_t* const fb = frags + k * frag + slabs * 128 + tile * 64 + lane;
      const float* ha = h_s + q * kHRow + tile * 16 + g;
      const float* ab = a_s + q * kARow + tile * 8 + g;
      if (!kMulti) {
        // all of the run's values are read before the first store, which the
        // compiler cannot move them past; slab j is step j / kSl, slice j % kSl
        constexpr int kN = kSteps * kSl;
        auto row = [&](int j) { return (j / kSl) * Bp + (j % kSl) * 4; };
        if (kind == 0) {
          float x[kN][2];
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            x[j][0] = ha[row(j) * kHRow];
            x[j][1] = ha[row(j) * kHRow + 8];
          }
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            if ((j % kSl) * 4 + q < B)
              fa[j * 128] = bits(__floats2bfloat162_rn(x[j][0], x[j][1]));
          }
        } else {
          float x[kN];
#pragma unroll
          for (int j = 0; j < kN; ++j) x[j] = ab[row(j) * kARow];
#pragma unroll
          for (int j = 0; j < kN; j += 2) {
            uint2 b0, b1;
            split3x2(x[j], x[j + 1], b0, b1);
            if ((j % kSl) * 4 + q < B) {
              fb[j * 256] = b0.x;
              fb[j * 256 + 32] = b0.y;
            }
            if (((j + 1) % kSl) * 4 + q < B) {
              fb[(j + 1) * 256] = b1.x;
              fb[(j + 1) * 256 + 32] = b1.y;
            }
          }
        }
      } else {
        int lo, hi;
        rows_of(run, lo, hi);
        int sb = 0;
        for (int s = 0; s < S; ++s)
          for (int grp = 0; grp < G; ++grp)
#pragma unroll
            for (int sl = 0; sl < kSl; ++sl, ++sb) {
              const int r = grp * R + sl * 4;
              if (lo + r + q >= hi) {
                // past B: zeros stand in a buffer that no chunk wrote
                // before; in one an earlier chunk wrote, zeros are written
                if (C > 1) {
                  if (kind == 0) {
                    fa[sb * 128] = 0u;
                  } else {
                    fb[sb * 256] = 0u;
                    fb[sb * 256 + 32] = 0u;
                  }
                }
                continue;
              }
              if (kind == 0) {
                const float* src = ha + (s * Bp + r) * kHRow;
                fa[sb * 128] = bits(__floats2bfloat162_rn(src[0], src[8]));
              } else {
                uint2 b0, b1;
                split3x2(ab[(s * Bp + r) * kARow], 0.f, b0, b1);
                fb[sb * 256] = b0.x;
                fb[sb * 256 + 32] = b0.y;
              }
            }
      }
      hopper::fence_proxy_async();  // the B tiles, for wgmma's reads
      bar_arrive(kBarFull + k, kThreads);
    }
    return;
  }

  // the multiplying warpgroup: warp w the m tile w (inputs i0 + 16 w ..),
  // all 4 n tiles; lane = 4 g + q. A step's slices are chained wgmma into
  // sum (m64n32, f32), issued kAhead steps ahead of the carry; the carries
  // stay in registers, in the accumulator's layout.
  const uint32_t frag_addr = hopper::smem_u32(frags);
  __nv_bfloat162 acc[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = __floats2bfloat162_rn(0.f, 0.f);
  // a step in flight keeps its accumulators and its A registers: ptxas
  // otherwise waits for the wgmma before it reuses them
  constexpr int kAhead = 3;  // steps in flight beyond the one carried
  float sum[kAhead + 1][16];
  uint32_t a_regs[kAhead + 1][kSl][4];
  // groups g0 .. g1 - 1 of step s chained into dst from zero
  auto issue = [&](const uint32_t* fa, uint32_t fb, int s, float (&dst)[16],
                   uint32_t (&a)[kSl][4], int g0, int g1) {
    for (int grp = g0; grp < g1; ++grp) {
      // the step's A registers are written before wgmma.fence, and the
      // slices issued back to back
#pragma unroll
      for (int sl = 0; sl < kSl; ++sl) {
        const uint4 a4 = a_frag(fa[((s * G + grp) * kSl + sl) * 128]);
        a[sl][0] = a4.x, a[sl][1] = a4.y, a[sl][2] = a4.z, a[sl][3] = a4.w;
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < kSl; ++sl) {
        const int slab = (s * G + grp) * kSl + sl;
        // B: K-major, no swizzle; 128 bytes from slots 0-7 to 8-15 (LBO),
        // 256 from one n tile to the next (SBO)
        const uint64_t b = hopper::smem_desc(fb + slab * 1024, 128, 256, 0);
        hopper::wgmma_rs<32, 0>(dst, a[sl], b, grp > g0 || sl > 0);
      }
    }
    hopper::wgmma_commit();
  };
  auto retire = [](uint32_t (&a)[kSl][4]) {
#pragma unroll
    for (int sl = 0; sl < kSl; ++sl)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[sl][e])::"memory");
  };
  auto carry = [&](float (&src)[16]) {
    hopper::fence_regs(src);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[n][0] = __hadd2(acc[n][0], __floats2bfloat162_rn(src[4 * n], src[4 * n + 1]));
      acc[n][1] = __hadd2(acc[n][1], __floats2bfloat162_rn(src[4 * n + 2], src[4 * n + 3]));
    }
  };
  for (int run = 0; run < runs; ++run) {
    const int k = run % kFrags;
    bar_sync(kBarFull + k, kThreads);
    const uint32_t* fa = frags + k * frag + warp * 32 + lane;
    const uint32_t fb = frag_addr + 4 * (k * frag + slabs * 128);
    if (!kMulti) {
#pragma unroll
      for (int s = 0; s < kAhead; ++s) issue(fa, fb, s, sum[s], a_regs[s], 0, G);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        constexpr int kSets = kAhead + 1;
        if (s + kAhead < kSteps) {
          const int next = (s + kAhead) % kSets;
          issue(fa, fb, s + kAhead, sum[next], a_regs[next], 0, G);
          hopper::wgmma_wait<kAhead>();
        } else if (s + 2 < kSteps) {
          hopper::wgmma_wait<2>();
        } else if (s + 1 < kSteps) {
          hopper::wgmma_wait<1>();
        } else {
          hopper::wgmma_wait<0>();
        }
        retire(a_regs[s % kSets]);
        carry(sum[s % kSets]);
      }
    } else if (C == 1) {
      for (int s = 0; s < S; ++s) {
        issue(fa, fb, s, sum[0], a_regs[0], 0, G);
        hopper::wgmma_wait<0>();
        retire(a_regs[0]);
        carry(sum[0]);
      }
    } else {
      // one step a run, one chunk of its rows: the step's first chain sums
      // into sum[0], each later one into sum[1] from zero, then added to
      // sum[0] (f32, to nearest); the carry follows the last chunk
      const int chunk = run % C;
      for (int g0 = 0; g0 < G; g0 += kChainGroups) {
        const int g1 = min(G, g0 + kChainGroups);
        if (chunk == 0 && g0 == 0) {
          issue(fa, fb, 0, sum[0], a_regs[0], g0, g1);
          hopper::wgmma_wait<0>();
          retire(a_regs[0]);
        } else {
          issue(fa, fb, 0, sum[1], a_regs[0], g0, g1);
          hopper::wgmma_wait<0>();
          retire(a_regs[0]);
          hopper::fence_regs(sum[1]);
#pragma unroll
          for (int e = 0; e < 16; ++e) sum[0][e] += sum[1][e];
        }
      }
      if (chunk == C - 1) carry(sum[0]);
    }
    if (run + kFrags < runs) bar_arrive(kBarFree + k, kThreads);
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = c0 + n * 8 + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + warp * 16 + g + 8 * half;
      if (i < H && c < H4)
        *reinterpret_cast<float2*>(dwhh + ((size_t)d * H + i) * H4 + c) =
            __bfloat1622float2(acc[n][half]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kSl, bool kMulti>
int launch(const float* hs, const float* da, float* dwhh, int ndir, int B, int T, int H, int G,
           int S, int C, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_dw_bf16_kernel<kSl, kMulti>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kI - 1) / kI, (4 * H + kC - 1) / kC, ndir);
  lstm_dw_bf16_kernel<kSl, kMulti><<<grid, kThreads, smem, stream>>>(
      hs, da, dwhh, B, T, H, G, S, C, H % 4 == 0 && aligned16(hs));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hs (ndir, B, T, H) and da (ndir, B, T, 4H): contiguous f32 device pointers
// on `device`, da 16-byte aligned; dwhh (ndir, H, 4H) f32, 16-byte aligned, is
// written in full with bf16 values. Any H, any B (past kChunkRows, 136 on an
// H100, a step's rows in chunks).
// One launch on `stream`; returns the first non-zero status, 0 on success.
// Does not synchronise.
int lstm_dw_bf16_f32(const void* hs, const void* da, void* dwhh, int ndir, int B, int T, int H,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndir <= 0 || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (!(aligned16(da) && aligned16(dwhh))) return (int)cudaErrorMisalignedAddress;
  int smem_optin = 0;
  if ((err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)))
    return (int)err;
  // groups of 8 rows: all in one run, or in C chunks of Gc groups each when
  // one step's rows do not fit (then one step a run)
  const int G = B <= 8 ? 1 : (B + 7) / 8;
  const int fit = smem_optin / kRowBytes / 8;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int C = G > fit ? (G + fit - 1) / fit : 1;
  const int Gc = (G + C - 1) / C;
  const int Bp = B <= 4 ? 4 : 8 * Gc;
  const int steps = B <= 4 ? 2 * kS : kS;  // kSteps of the instance
  int S = C > 1 ? 1 : steps;
  while (S > 1 && (size_t)S * Bp * kRowBytes > (size_t)smem_optin) S >>= 1;
  const size_t smem = (size_t)S * Bp * kRowBytes;
  if (smem > (size_t)smem_optin || (B <= 8 && S != steps)) return (int)cudaErrorInvalidValue;
  auto h = static_cast<const float*>(hs);
  auto a = static_cast<const float*>(da);
  auto w = static_cast<float*>(dwhh);
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 4) return launch<1, false>(h, a, w, ndir, B, T, H, Gc, S, C, smem, s);
  if (B <= 8) return launch<2, false>(h, a, w, ndir, B, T, H, Gc, S, C, smem, s);
  return launch<2, true>(h, a, w, ndir, B, T, H, Gc, S, C, smem, s);
}

const char* lstm_dw_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
