// Uniform [0, 1) float32 from a counter-based generator, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/random.py:211
// (hardware_uniform -> _hw_uniform_kernel), which draws the TPU's
// hardware random bits.  Those bits cannot be reproduced here, so the
// kernel keeps the JAX function's contract instead: deterministic per
// seed, values in [0, 1), each the top 24 bits of a random word times
// 2^-24.  The words come from Philox4x32-10 (Salmon et al., "Parallel
// random numbers: as easy as 1, 2, 3", SC'11) keyed by (seed as uint32,
// 0); counter i = (low word of i, high word of i, 0, 0) gives elements 4i
// to 4i + 3.  veles_tpu_torch/ops/random.py computes the same words on
// int64 tensors as the plain version, bit for bit.
//
// What bounds it on the card: bytes, the output written once ((4096,
// 4096) is 67 MB, 0.020 ms at 3.35 TB/s); ten rounds of two 32 x 32
// multiplies a 16-byte store keep the integer units below that.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float unit(uint32_t w) {
  return __uint2float_rn(w >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(THREADS)
uniform_kernel(float* __restrict__ out, long long n, uint32_t k0,
               uint32_t k1) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       i < groups; i += stride) {
    const uint4 w = philox(
        make_uint4(static_cast<uint32_t>(i),
                   static_cast<uint32_t>(static_cast<unsigned long long>(i)
                                         >> 32), 0u, 0u),
        k0, k1);
    const long long e = 4 * i;
    if (e + 4 <= n) {
      reinterpret_cast<float4*>(out)[i] =
          make_float4(unit(w.x), unit(w.y), unit(w.z), unit(w.w));
    } else {
      const uint32_t v[4] = {w.x, w.y, w.z, w.w};
      for (int j = 0; e + j < n; ++j) out[e + j] = unit(v[j]);
    }
  }
}

}  // namespace

// out: n float32 (16-byte aligned); key = (k0, k1).
extern "C" int veles_uniform(void* out, long long n, unsigned int k0,
                             unsigned int k1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long groups = (n + 3) / 4;
  const long long blocks = (groups + THREADS - 1) / THREADS;
  uniform_kernel<<<static_cast<unsigned>(blocks < 0x7fffffffLL
                                             ? blocks : 0x7fffffffLL),
                   THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, k0, k1);
  return static_cast<int>(cudaGetLastError());
}
