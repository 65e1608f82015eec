// Raises a kernel's dynamic shared-memory limit once per device, for the kernels
// that take more than the default 48 KB (flash_attention_bwd.cu, wkv6_bwd.cu,
// mamba_scan_bwd.cu).
// The attribute stays set for the process, and setting it on every launch was
// seen to cost ~1.4 ms a launch on short calls (PERF.md §6).  Each caller keeps
// one `static bool done[MAX_DEVICES]` per kernel; the build's digest covers this
// header.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t opt_in_once(Kernel kern, int smem, bool (&done)[MAX_DEVICES]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

}  // namespace
