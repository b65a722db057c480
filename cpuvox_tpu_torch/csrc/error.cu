// The message of a CUDA error code, for the wrappers' exceptions
// (ops/_build.py::check).

#include <cuda_runtime.h>

extern "C" const char* cpuvox_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
