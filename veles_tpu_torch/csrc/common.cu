// Helpers shared by the kernel library's C interface.

#include <cuda_runtime.h>

extern "C" const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
