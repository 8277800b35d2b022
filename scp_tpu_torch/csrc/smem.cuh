// Dynamic shared memory above the 48 KB a kernel gets without asking: every
// launcher of the package raises a kernel's limit through ensure_dyn_smem.
#pragma once

#include <cuda_runtime.h>

namespace scpk {

constexpr int kMaxDevices = 64;
constexpr int kDefaultDynSmem = 48 * 1024;

// Raises `kernel`'s dynamic shared-memory limit only when a launch needs more
// than the largest size already granted on the current device (48 KB are
// granted without asking), so the usual launch makes no attribute call.
// `granted` is the kernel's own table, one entry per device, zero-initialised.
template <typename Kernel>
cudaError_t ensure_dyn_smem(Kernel kernel, int* granted, long smem_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int have = granted[dev] > kDefaultDynSmem ? granted[dev]
                                                  : kDefaultDynSmem;
  if (smem_bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err == cudaSuccess) granted[dev] = (int)smem_bytes;
  return err;
}

}  // namespace scpk
