// Shared by every kernel library of ft_mpc_torch (one copy per .so).
#pragma once

#include <cuda_runtime.h>

// Text of a cudaError_t returned by a launcher, for the Python wrapper.
extern "C" const char* ftmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Raise a kernel's dynamic shared-memory cap when it needs more than 48 KB.
template <typename Kernel>
static cudaError_t ftmpc_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
