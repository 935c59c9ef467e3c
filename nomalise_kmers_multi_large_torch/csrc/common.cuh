// Shared by every kernel library of the port: the exported-symbol macro, the
// error-string entry point the Python side uses to explain a failed launch,
// and the device selection each entry point performs before it launches.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NKM_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kSentinel = 0xffffffffu;  // sort key of an invalid window

// Each library links its own CUDA runtime: select the tensors' device in it.
static inline int nkm_select_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

NKM_EXPORT const char* nkm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
