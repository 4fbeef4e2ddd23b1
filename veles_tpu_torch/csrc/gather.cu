// Minibatch row gather with a dtype cast, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/gather.py:59
// (gather_minibatch -> _gather_kernel): out[b, :] = cast(src[idx[b], :])
// for a (N, F) dataset and (B,) int32 or int64 indices.  The TPU kernel
// scalar-prefetches the indices and DMAs one lane-aligned row per grid
// step; rows whose width is not a multiple of 128 go to jnp.take there.
// Here a block row (blockIdx.x) owns one output row, reads its own index
// and copies the row with all of its threads; long rows are cut into
// segments along blockIdx.y so that a 32-row minibatch of 150,528-wide
// VGG16 images still fills the card.  Any row width works: on path VEC4
// (rows whose width is a multiple of 4, both bases aligned to 4
// elements) a thread moves 4 elements per step (16-byte stores for f32,
// 16-byte loads too where the source is f32 or int32), on path SCALAR
// one element at a time.  The wrapper (ops/gather.py, plan_gather) picks
// the path; the kernel checks it.
//
// An index outside [0, N) is clamped to the nearest row, so the kernel
// never reads outside the dataset; the plain PyTorch version clamps the
// same way.  int64 indices are read as they are (a second instantiation),
// so the host neither clamps nor casts them.
//
// What bounds it on the card: bytes.  Each output element is one read
// and one write; 32 VGG16 rows in f32 move 38.5 MB, 11.5 us at 3.35 TB/s.
// Timed cold on the card, this loop reaches 84 % of that bound and runs
// level with index_select.  Two designs with more loads in flight
// measured slower (PERF.md): 16-byte loads of every dtype, four a
// thread (f32 4 % slower, uint8 -> f32 twice as slow: a thread's 64
// contiguous bytes of stores coalesce worse than these float4 stores),
// and this loop unrolled to four loads a thread (f32 4 % slower).
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
// paths, in the order of PATHS in veles_tpu_torch/ops/gather.py
enum Path { VEC4 = 0, SCALAR = 1 };

template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

template <typename Idx>
__device__ __forceinline__ long long clamp_row(const Idx* idx, int b,
                                               long long n_rows) {
  long long row = idx[b];
  return row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
}

template <typename In, typename Out, typename Idx>
__global__ void __launch_bounds__(THREADS)
gather_scalar(const In* __restrict__ src, const Idx* __restrict__ idx,
              Out* __restrict__ dst, long long n_rows, long long width) {
  const int b = blockIdx.x;
  const In* s = src + clamp_row(idx, b, n_rows) * width;
  Out* d = dst + static_cast<long long>(b) * width;
  const long long begin = blockIdx.y * SEGMENT;
  const long long end = min(begin + SEGMENT, width);
  for (long long e = begin + threadIdx.x; e < end; e += THREADS)
    d[e] = static_cast<Out>(s[e]);
}

template <typename In, typename Out, typename Idx>
__global__ void __launch_bounds__(THREADS)
gather_vec4(const In* __restrict__ src, const Idx* __restrict__ idx,
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

template <typename In, typename Out, typename Idx>
cudaError_t launch(int path, const void* src, const Idx* idx, void* dst,
                   long long n_rows, long long batch, long long width,
                   cudaStream_t stream) {
  const In* s = static_cast<const In*>(src);
  Out* d = static_cast<Out*>(dst);
  const bool vec = path == VEC4;
  if (vec && !(width % 4 == 0 &&
               reinterpret_cast<uintptr_t>(src) % (4 * sizeof(In)) == 0 &&
               reinterpret_cast<uintptr_t>(dst) % (4 * sizeof(Out)) == 0))
    return cudaErrorInvalidValue;
  if (!vec && path != SCALAR) return cudaErrorInvalidValue;
  const long long units = vec ? width / 4 : width;
  const long long segments = (units + SEGMENT - 1) / SEGMENT;
  if (batch > 0x7fffffffLL || segments > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>(segments));
  if (vec)
    gather_vec4<In, Out, Idx><<<grid, THREADS, 0, stream>>>(s, idx, d,
                                                             n_rows, width);
  else
    gather_scalar<In, Out, Idx><<<grid, THREADS, 0, stream>>>(s, idx, d,
                                                               n_rows, width);
  return cudaGetLastError();
}

// A row is copied as it is or widened to f32, never narrowed.
template <typename In, typename Idx>
cudaError_t dispatch_out(int out_code, int in_code, int path,
                         const void* src, const Idx* idx, void* dst,
                         long long n_rows, long long batch, long long width,
                         cudaStream_t stream) {
  if (out_code == F32)
    return launch<In, float, Idx>(path, src, idx, dst, n_rows, batch, width,
                                  stream);
  if (out_code == in_code)
    return launch<In, In, Idx>(path, src, idx, dst, n_rows, batch, width,
                               stream);
  return cudaErrorInvalidValue;
}

template <typename Idx>
cudaError_t dispatch_in(int in_code, int out_code, int path, const void* src,
                        const void* idx, void* dst, long long n_rows,
                        long long batch, long long width,
                        cudaStream_t stream) {
  const Idx* i = static_cast<const Idx*>(idx);
  switch (in_code) {
    case U8:
      return dispatch_out<uint8_t, Idx>(out_code, in_code, path, src, i,
                                        dst, n_rows, batch, width, stream);
    case I8:
      return dispatch_out<int8_t, Idx>(out_code, in_code, path, src, i,
                                       dst, n_rows, batch, width, stream);
    case I32:
      return dispatch_out<int32_t, Idx>(out_code, in_code, path, src, i,
                                        dst, n_rows, batch, width, stream);
    case F32:
      return dispatch_out<float, Idx>(out_code, in_code, path, src, i,
                                      dst, n_rows, batch, width, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// index_bytes: 4 (int32 indices) or 8 (int64); path: VEC4 or SCALAR.
extern "C" int veles_gather_rows(const void* src, const void* idx, void* dst,
                                 long long n_rows, long long batch,
                                 long long width, int in_code, int out_code,
                                 int index_bytes, int path, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 4)
    err = dispatch_in<int32_t>(in_code, out_code, path, src, idx, dst,
                               n_rows, batch, width, s);
  else if (index_bytes == 8)
    err = dispatch_in<long long>(in_code, out_code, path, src, idx, dst,
                                 n_rows, batch, width, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
