// Shared by B3's bf16 kernels on Hopper (flash_attn.cu: B3 fwd bf16;
// flash_attn_bwd.cu: B3 bwd bf16): the tensor maps of head tiles, the key
// bias, the aligned shared window, and the error code of a tensor map
// cuTensorMapEncodeTiled refuses.
#pragma once

#include "flash_attn_common.cuh"
#include "hopper.cuh"

namespace flash_bf16 {

// A launch that fails to encode a tensor map returns this plus the
// CUresult (cudaGetErrorString knows no such code; the error-string entries
// of the two libraries name it).
constexpr int kMapError = 10000;

// A (B, T, N * D) bf16 operand at `base`, batch stride sb and time stride st
// in elements, unit stride in a row, as TMA sees it: the 4-D tensor (D, N,
// T, B) whose box is `rows` time rows of one head, one panel of Panels<D>
// wide (a D = 128 tile is two boxes). Rows t >= T load as zeros. The base must
// be 16-byte aligned and sb, st multiples of 8 (the wrapper's tma_ready).
template <int D>
int encode_heads(CUtensorMap* map, const void* base, int B, int T, int N, long long sb,
                 long long st, int rows) {
  using P = hopper::Panels<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * (cuuint64_t)st, 2ull * (cuuint64_t)sb};
  const cuuint32_t box[4] = {(cuuint32_t)P::kCols, 1u, (cuuint32_t)rows, 1u};
  const int err = hopper::encode_bf16_4d(map, base, dims, strides, box, P::kSwizzle);
  return err ? kMapError + err : 0;
}

// The key bias of key t in batch row b: kbias[b * T + t], 0 where kbias is
// null (no bias given), -inf for keys t >= T.
__device__ __forceinline__ float key_bias(const float* kbias, int b, int t, int T) {
  return t >= T ? -INFINITY : kbias == nullptr ? 0.f : kbias[(long long)b * T + t];
}

// The shared window of a kernel's dynamic shared memory rounded up to 1024
// bytes (the launch asks for 1024 more): its address, and the same place as a
// generic pointer.
struct AlignedSmem {
  uint32_t addr;
  uint8_t* ptr;
};

__device__ __forceinline__ AlignedSmem align_smem(uint8_t* raw) {
  const uint32_t at = hopper::smem_u32(raw);
  const uint32_t up = (at + 1023u) & ~1023u;
  return {up, raw + (up - at)};
}

}  // namespace flash_bf16
