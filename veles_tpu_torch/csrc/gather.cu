// Minibatch row gather with a dtype cast, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/gather.py:59
// (gather_minibatch -> _gather_kernel): out[b, :] = cast(src[idx[b], :])
// for a (N, F) dataset and (B,) int32 indices.  The TPU kernel
// scalar-prefetches the indices and DMAs one lane-aligned row per grid
// step; rows whose width is not a multiple of 128 go to jnp.take there.
// Here a block row (blockIdx.x) owns one output row, reads its own index
// and copies the row with all of its threads; long rows are cut into
// segments along blockIdx.y so that a 32-row minibatch of 150,528-wide
// VGG16 images still fills the card.  Any row width works: rows whose
// width is a multiple of 4 move 4 elements per thread per step (16-byte
// stores for f32, 16-byte loads too where the source is f32 or int32),
// other rows one element at a time.
//
// An index outside [0, N) is clamped to the nearest row, so the kernel
// never reads outside the dataset; the plain PyTorch version clamps the
// same way.
//
// What bounds it on the card: bytes.  Each output element is one read
// and one write; 32 VGG16 rows in f32 move 38.5 MB, 11.5 us at 3.35 TB/s.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// elements (or 4-element groups) each block handles along a row
constexpr long long SEGMENT = THREADS * 16;

// dtype codes shared with veles_tpu_torch/ops/gather.py
enum Code { U8 = 0, I8 = 1, I32 = 2, F32 = 3 };

template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

__device__ __forceinline__ long long clamp_row(const int* idx, int b,
                                               long long n_rows) {
  long long row = idx[b];
  return row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
}

template <typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
gather_scalar(const In* __restrict__ src, const int* __restrict__ idx,
              Out* __restrict__ dst, long long n_rows, long long width) {
  const int b = blockIdx.x;
  const In* s = src + clamp_row(idx, b, n_rows) * width;
  Out* d = dst + static_cast<long long>(b) * width;
  const long long begin = blockIdx.y * SEGMENT;
  const long long end = min(begin + SEGMENT, width);
  for (long long e = begin + threadIdx.x; e < end; e += THREADS)
    d[e] = static_cast<Out>(s[e]);
}

template <typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
gather_vec4(const In* __restrict__ src, const int* __restrict__ idx,
            Out* __restrict__ dst, long long n_rows, long long width) {
  using VIn = typename Vec4<In>::type;
  using VOut = typename Vec4<Out>::type;
  const int b = blockIdx.x;
  const long long groups = width / 4;
  const VIn* s = reinterpret_cast<const VIn*>(
      src + clamp_row(idx, b, n_rows) * width);
  VOut* d = reinterpret_cast<VOut*>(dst + static_cast<long long>(b) * width);
  const long long begin = blockIdx.y * SEGMENT;
  const long long end = min(begin + SEGMENT, groups);
  for (long long g = begin + threadIdx.x; g < end; g += THREADS) {
    const VIn v = s[g];
    VOut o;
    o.x = static_cast<Out>(v.x);
    o.y = static_cast<Out>(v.y);
    o.z = static_cast<Out>(v.z);
    o.w = static_cast<Out>(v.w);
    d[g] = o;
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* src, const int* idx, void* dst,
                   long long n_rows, long long batch, long long width,
                   cudaStream_t stream) {
  const In* s = static_cast<const In*>(src);
  Out* d = static_cast<Out*>(dst);
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % (4 * sizeof(In)) == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % (4 * sizeof(Out)) == 0;
  const long long units = vec ? width / 4 : width;
  const long long segments = (units + SEGMENT - 1) / SEGMENT;
  if (batch > 0x7fffffffLL || segments > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>(segments));
  if (vec)
    gather_vec4<In, Out><<<grid, THREADS, 0, stream>>>(s, idx, d, n_rows,
                                                        width);
  else
    gather_scalar<In, Out><<<grid, THREADS, 0, stream>>>(s, idx, d, n_rows,
                                                          width);
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch_out(int out_code, const void* src, const int* idx,
                         void* dst, long long n_rows, long long batch,
                         long long width, cudaStream_t stream) {
  switch (out_code) {
    case F32:
      return launch<In, float>(src, idx, dst, n_rows, batch, width, stream);
    case U8:
      return launch<In, uint8_t>(src, idx, dst, n_rows, batch, width,
                                 stream);
    case I8:
      return launch<In, int8_t>(src, idx, dst, n_rows, batch, width, stream);
    case I32:
      return launch<In, int32_t>(src, idx, dst, n_rows, batch, width,
                                 stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int veles_gather_rows(const void* src, const void* idx, void* dst,
                                 long long n_rows, long long batch,
                                 long long width, int in_code, int out_code,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // a row is copied as it is or widened to f32, never narrowed
  if (out_code != F32 && out_code != in_code)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* i = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case U8:
      err = dispatch_out<uint8_t>(out_code, src, i, dst, n_rows, batch,
                                  width, s);
      break;
    case I8:
      err = dispatch_out<int8_t>(out_code, src, i, dst, n_rows, batch, width,
                                 s);
      break;
    case I32:
      err = dispatch_out<int32_t>(out_code, src, i, dst, n_rows, batch,
                                  width, s);
      break;
    case F32:
      err = dispatch_out<float>(out_code, src, i, dst, n_rows, batch, width,
                                s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
