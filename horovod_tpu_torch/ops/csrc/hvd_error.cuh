// The one error-string entry point that every library of ops/csrc exports,
// under the same name, so that ops/_build.py binds it whatever the source:
// hvd_error_string(cudaError_t as int) -> cudaGetErrorString of it.
// Include it from exactly one translation unit of each library (each .cu
// builds alone into its own library).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* hvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
