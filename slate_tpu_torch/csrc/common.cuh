// Shared by every kernel source of slate_tpu_torch: the C entry point that
// turns an error code into text, the launch prologue, and the count of
// thread-block clusters a kernel can hold resident (K2, K4, K5, K6, K7 and
// K8).
//
// Each source is built alone into a shared library with a plain C interface
// (slate_tpu_torch/internal/kernels.py). Every entry point takes the device
// index and PyTorch's current stream first, launches there, allocates nothing,
// and returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

extern "C" const char* slate_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// A refused runtime call also becomes the runtime's last error, which the
// next launch's cudaGetLastError() would report: clear it before returning.
#define SLATE_RETURN_IF_ERROR(expr)      \
  do {                                   \
    cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) {             \
      cudaGetLastError();                \
      return static_cast<int>(e_);       \
    }                                    \
  } while (0)

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: select the operands' device before every launch.
#define SLATE_SET_DEVICE(dev) SLATE_RETURN_IF_ERROR(cudaSetDevice(dev))

// Opt a kernel into more than 48 KB of dynamic shared memory.
#define SLATE_SET_SMEM(kernel, bytes)                \
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(        \
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(bytes)))

// *n = how many clusters of c CTAs of the kernel (threads a CTA, smem bytes
// of dynamic shared memory) the card holds at once, as
// cudaOccupancyMaxActiveClusters counts, cached per (kernel, device, c,
// threads, smem). A size the card does not support at all counts as 0
// clusters; any other error is returned.
template <class Kernel>
cudaError_t active_clusters(Kernel kernel, int device, int c, int threads,
                            int smem, int* n) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int, int, int>, int> cache;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel),
                                   device, c, threads, smem);
  {
    std::lock_guard<std::mutex> g(lock);
    const auto it = cache.find(key);
    if (it != cache.end()) {
      *n = it->second;
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(c, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (e == cudaErrorInvalidClusterSize) {
    cudaGetLastError();  // this call's own error, reported as *n = 0
    *n = 0;
  } else if (e != cudaSuccess) {
    return e;
  }
  std::lock_guard<std::mutex> g(lock);
  cache[key] = *n;
  return cudaSuccess;
}

// *fits = 1 when the card places one cluster of c CTAs of `kernel`
// (threads, smem bytes of dynamic shared memory each): smem within a
// block's opt-in limit, and cudaOccupancyMaxActiveClusters > 0. Opts the
// kernel into that shared memory.
template <class Kernel>
int cluster_fits(Kernel kernel, int device, int c, int threads, size_t smem,
                 int* fits) {
  int limit = 0, placed = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = 0;
  if (smem > (size_t)limit) return 0;
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  SLATE_RETURN_IF_ERROR(
      active_clusters(kernel, device, c, threads, (int)smem, &placed));
  *fits = placed > 0;
  return 0;
}
