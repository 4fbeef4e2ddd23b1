// Mean/dispersion normalization with a cast, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/normalize.py:39
// (mean_disp_normalize -> _normalize_kernel): for a (B, F) input in its
// storage dtype (uint8, int8, int32, float32, bfloat16 or float16) and
// (F,) float32 mean and rdisp,
//     out[b, f] = (float(x[b, f]) - mean[f]) * rdisp[f]
// in float32, the subtraction and the product each rounded to nearest
// (__fsub_rn / __fmul_rn, which the compiler never contracts into an
// FMA), so the result is bit-equal to the plain PyTorch version and to
// the JAX kernel.  The TPU kernel pads the batch and the features to its
// (bm, 128) tiles and slices the padding off; here the grid covers
// (column chunks) x (row groups) and the edges are masked, so nothing is
// padded or copied.  A block walks 1 to 8 rows (row_groups.cuh: as few
// as keep ~4 blocks an SM in flight).  A thread owns 4 consecutive features when the row
// width is a multiple of 4 and the pointers are aligned for it (a 4-byte
// uchar4 or a 16-byte float4 load, float4 mean/rdisp loads held in
// registers across the rows of its group, a 16-byte store), else 1.
// Each output element is written once, by one thread; no atomics.
//
// What bounds it on the card: bytes, one read of x, mean and rdisp and
// one write of out.  At the unit graph's (100, 784) uint8 minibatch that
// is 398,272 bytes, 0.12 us at 3.35 TB/s, so a launch costs more than
// the work; (4096, 3072) uint8 moves 62.9 MB, 18.8 us.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "row_groups.cuh"

namespace {

constexpr int THREADS = 256;

// input dtype codes shared with veles_tpu_torch/ops/normalize.py
enum Code { U8 = 0, I8 = 1, I32 = 2, F32 = 3, BF16 = 4, F16 = 5 };

__device__ __forceinline__ float widen(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float widen(int32_t v) { return __int2float_rn(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ float apply(float x, float m, float r) {
  return __fmul_rn(__fsub_rn(x, m), r);
}

// 4 consecutive elements of type T in one load of 4 * sizeof(T) bytes
template <typename T> struct alignas(4 * sizeof(T)) Aligned4 { T v[4]; };

template <typename In>
__global__ void __launch_bounds__(THREADS)
normalize_vec4(const In* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ rdisp, float* __restrict__ out,
               long long batch, long long width, int rows) {
  const long long groups = width / 4;
  const long long g = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (g >= groups) return;
  const float4 m = reinterpret_cast<const float4*>(mean)[g];
  const float4 r = reinterpret_cast<const float4*>(rdisp)[g];
  for (long long row0 = blockIdx.y * static_cast<long long>(rows);
       row0 < batch; row0 += gridDim.y * static_cast<long long>(rows)) {
    for (int k = 0; k < rows; ++k) {
      const long long row = row0 + k;
      if (row >= batch) break;
      const Aligned4<In> v =
          reinterpret_cast<const Aligned4<In>*>(x + row * width)[g];
      float4 o;
      o.x = apply(widen(v.v[0]), m.x, r.x);
      o.y = apply(widen(v.v[1]), m.y, r.y);
      o.z = apply(widen(v.v[2]), m.z, r.z);
      o.w = apply(widen(v.v[3]), m.w, r.w);
      reinterpret_cast<float4*>(out + row * width)[g] = o;
    }
  }
}

template <typename In>
__global__ void __launch_bounds__(THREADS)
normalize_scalar(const In* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rdisp, float* __restrict__ out,
                 long long batch, long long width, int rows) {
  const long long f = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (f >= width) return;
  const float m = mean[f];
  const float r = rdisp[f];
  for (long long row0 = blockIdx.y * static_cast<long long>(rows);
       row0 < batch; row0 += gridDim.y * static_cast<long long>(rows)) {
    for (int k = 0; k < rows; ++k) {
      const long long row = row0 + k;
      if (row >= batch) break;
      out[row * width + f] = apply(widen(x[row * width + f]), m, r);
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename In>
cudaError_t launch(const void* x, const float* mean, const float* rdisp,
                   float* out, long long batch, long long width, int device,
                   cudaStream_t stream) {
  const In* xs = static_cast<const In*>(x);
  const bool vec = width % 4 == 0 && aligned(x, 4 * sizeof(In)) &&
                   aligned(mean, 16) && aligned(rdisp, 16) &&
                   aligned(out, 16);
  const long long units = vec ? width / 4 : width;
  const long long chunks = (units + THREADS - 1) / THREADS;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // a block's rows reuse the mean and rdisp it holds in registers
  RowGroups g;
  const cudaError_t err = row_groups(batch, chunks, device, &g);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(chunks), g.groups);
  if (vec)
    normalize_vec4<In><<<grid, THREADS, 0, stream>>>(xs, mean, rdisp, out,
                                                      batch, width, g.rows);
  else
    normalize_scalar<In><<<grid, THREADS, 0, stream>>>(xs, mean, rdisp, out,
                                                        batch, width, g.rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int veles_mean_disp_normalize(const void* x, const void* mean,
                                         const void* rdisp, void* out,
                                         long long batch, long long width,
                                         int in_code, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rdisp);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case U8:
      return launch<uint8_t>(x, m, r, o, batch, width, device, s);
    case I8:
      return launch<int8_t>(x, m, r, o, batch, width, device, s);
    case I32:
      return launch<int32_t>(x, m, r, o, batch, width, device, s);
    case F32:
      return launch<float>(x, m, r, o, batch, width, device, s);
    case BF16:
      return launch<__nv_bfloat16>(x, m, r, o, batch, width, device, s);
    case F16:
      return launch<__half>(x, m, r, o, batch, width, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
