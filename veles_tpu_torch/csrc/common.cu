// Helpers shared by the kernel library's C interface, and the empty
// kernel whose device time is the launch floor: the least time any
// launch takes on the card's clock, which bounds every kernel's time
// from below beside its bytes and operations.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* veles_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block of one warp that does nothing, on the caller's stream.
extern "C" int veles_empty(int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
