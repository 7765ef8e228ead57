// Host-side work a kernel's C entry needs once per device, not once per
// launch: the SM count, the opt-in limit of shared memory a block, and the
// kernel allowed dynamic shared memory up to that limit. At one row of audio
// a launch of the DSP kernels takes microseconds, so attribute queries and
// sets on every call would be a sizeable share of it.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kMaxDevices = 64;

struct KernelSetup {
  std::once_flag once;
  int sms = 0;
  int smem_optin = 0;
  cudaError_t err = cudaSuccess;
};

// Makes `device` the calling thread's current device (where it is not
// already) and returns in *out the setup of `kernel` there, done on the first
// call for that device and kept in `slots` (the kernel's own table, one
// entry a device). Returns the first non-zero CUDA status, which a failed
// setup keeps returning.
template <class Kernel>
cudaError_t setup_on(int device, KernelSetup* slots, Kernel kernel, const KernelSetup** out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  KernelSetup& s = slots[device];
  std::call_once(s.once, [&] {
    s.err = cudaDeviceGetAttribute(&s.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   device);
    if (s.err == cudaSuccess)
      s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, device);
    if (s.err == cudaSuccess)
      s.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   s.smem_optin);
  });
  *out = &s;
  return s.err;
}

}  // namespace
