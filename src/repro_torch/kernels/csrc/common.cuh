// Shared pieces of the port's CUDA sources: the export macro and the error
// text lookup every library exposes to its ctypes wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
