// The error text of a CUDA error code, for the Python launch wrapper.
#include <cuda_runtime.h>

extern "C" const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
