// Shared by every kernel source of slate_tpu_torch: the C entry point that
// turns an error code into text, and the launch prologue.
//
// Each source is built alone into a shared library with a plain C interface
// (slate_tpu_torch/internal/kernels.py). Every entry point takes the device
// index and PyTorch's current stream first, launches there, allocates nothing,
// and returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_runtime.h>

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
