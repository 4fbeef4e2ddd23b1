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
// (feature groups) x (row groups) and the edges are masked, so nothing is
// padded or copied.
//
// A thread loads 4 consecutive features of a row at once (16 bytes of
// f32/int32, 8 of bf16/f16, 4 of uint8/int8) when the row width is a
// multiple of 4 and the pointers are aligned for it, else 1.  It keeps
// their f32 means and rdisps in registers across the rows of its block,
// issues all of its rows' loads (up to 4, row_groups.cuh) before the
// first store, and writes a 16-byte store a row.  A block has as many
// threads as its row has groups, rounded up to a warp, up to 256.  Each
// output element is written once, by one thread; no atomics.
//
// Two other designs were built and timed on an H100 and measured no
// faster, so they are not kept: a 16-byte load a thread for every dtype
// (16 uint8 or 8 bf16 features, their outputs regrouped with warp
// shuffles so that each store instruction of a warp still wrote 512
// contiguous bytes), and streaming stores (st.global.cs); PERF.md holds
// their times.
//
// What bounds it on the card: bytes, one read of x, mean and rdisp and
// one write of out.  At the unit graph's (100, 784) uint8 minibatch that
// is 398,272 bytes, 0.12 us at 3.35 TB/s, so a launch costs more than
// the work; (4096, 3072) uint8 moves 62.9 MB, 18.8 us.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "row_groups.cuh"

namespace {

constexpr int MAX_THREADS = 256;

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

// the unsigned type of one load of BYTES bytes
template <int BYTES> struct Load;
template <> struct Load<16> { using type = uint4; };
template <> struct Load<8> { using type = uint2; };
template <> struct Load<4> { using type = unsigned; };
template <> struct Load<2> { using type = unsigned short; };
template <> struct Load<1> { using type = unsigned char; };

// `active`, `live` and the `f >= groups` test always pass past the early
// return.  They stay because with them nvcc issues all MAX_ROWS loads of
// a row group before its first store (read in the SASS).  Without them it
// stores row 0 before it loads rows 1-3, which ran 3 % slower at (4096,
// 3072) uint8 on an H100 (PERF.md); dropping __restrict__ from x did not
// restore the order.
template <typename In, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
normalize_kernel(const In* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rdisp, float* __restrict__ out,
                 long long batch, long long width, int rows) {
  using Raw = typename Load<VEC * sizeof(In)>::type;
  const int lane = threadIdx.x % 32;
  const long long groups = width / VEC;
  const long long g0 =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x - lane;
  const bool active = g0 + lane < groups;
  if (!active) return;
  const long long f = g0 + lane;
  const bool live = f < groups;
  float m[VEC], r[VEC];
  if constexpr (VEC == 4) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 mq = live ? reinterpret_cast<const float4*>(mean)[f] : zero;
    const float4 rq = live ? reinterpret_cast<const float4*>(rdisp)[f] : zero;
    m[0] = mq.x, m[1] = mq.y, m[2] = mq.z, m[3] = mq.w;
    r[0] = rq.x, r[1] = rq.y, r[2] = rq.z, r[3] = rq.w;
  } else {
    m[0] = live ? mean[f] : 0.f;
    r[0] = live ? rdisp[f] : 0.f;
  }
  for (long long row0 = blockIdx.y * static_cast<long long>(rows);
       row0 < batch; row0 += gridDim.y * static_cast<long long>(rows)) {
    Raw raw[MAX_ROWS];
#pragma unroll
    for (int k = 0; k < MAX_ROWS; ++k)
      raw[k] = active && k < rows && row0 + k < batch
                   ? reinterpret_cast<const Raw*>(x + (row0 + k) *
                                                  width)[g0 + lane]
                   : Raw{};
#pragma unroll
    for (int k = 0; k < MAX_ROWS; ++k) {
      if (k >= rows || row0 + k >= batch) break;
      float* dst = out + (row0 + k) * width;
      In v[VEC];
      memcpy(v, &raw[k], sizeof(Raw));
      if (f >= groups) continue;
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = apply(widen(v[i]), m[i], r[i]);
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(dst + 4 * f) =
            make_float4(o[0], o[1], o[2], o[3]);
      else
        dst[f] = o[0];
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename In, int VEC>
cudaError_t launch_vec(const In* x, const float* mean, const float* rdisp,
                       float* out, long long batch, long long width,
                       int device, cudaStream_t stream) {
  const long long groups = width / VEC;
  const long long threads =
      std::min<long long>(MAX_THREADS, (groups + 31) / 32 * 32);
  const long long chunks = (groups + threads - 1) / threads;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // a block's rows reuse the mean and rdisp it holds in registers
  RowGroups rg;
  const cudaError_t err = row_groups(batch, chunks, device, &rg);
  if (err != cudaSuccess) return err;
  normalize_kernel<In, VEC><<<dim3(static_cast<unsigned>(chunks), rg.groups),
                              static_cast<unsigned>(threads), 0, stream>>>(
      x, mean, rdisp, out, batch, width, rg.rows);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch(const void* x, const float* mean, const float* rdisp,
                   float* out, long long batch, long long width, int device,
                   cudaStream_t stream) {
  const In* xs = static_cast<const In*>(x);
  const bool coeffs = aligned(mean, 16) && aligned(rdisp, 16) &&
                      aligned(out, 16);
  if (coeffs && width % 4 == 0 && aligned(x, 4 * sizeof(In)))
    return launch_vec<In, 4>(xs, mean, rdisp, out, batch, width, device,
                             stream);
  return launch_vec<In, 1>(xs, mean, rdisp, out, batch, width, device,
                           stream);
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
