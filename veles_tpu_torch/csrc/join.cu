// Concatenation along the feature axis with a cast, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/join.py:47 (join ->
// _make_join_kernel): N inputs of (B, F_i), each in its own dtype, go to
// the column windows [offset_i, offset_i + F_i) of one (B, sum F_i)
// output, cast to the output dtype.  The TPU kernel unrolls the N inputs
// at trace time; here one launch takes a by-value table of up to
// MAX_INPUTS (pointer, width, column offset, dtype code) entries, and the
// wrapper cuts a longer list into launches that write disjoint column
// windows.  The grid is (column chunks, row groups, input): a block
// copies a chunk of one input's columns over a group of 1 to 8 rows
// (row_groups.cuh: as few as keep ~4 blocks an SM in flight), so every output element is
// written once, by one thread, with no atomics.
//
// Casts follow the JAX package's kernel_cast: to a float output every
// input goes through float32 (integers and bf16/f16 widen exactly, int32
// rounds to nearest), then rounds to nearest even into bf16/f16 as XLA's
// convert does; to an integer output an integer input widens exactly (the
// wrapper refuses float -> int and narrowing int casts).
//
// An input whose width and column offset are multiples of 4, with the
// output width a multiple of 4 and the pointers aligned, moves 4
// elements a thread per step (4- to 16-byte loads and stores); others 1.
//
// What bounds it on the card: bytes, each input read once and the output
// written once.  The unit graph's (100, 100) + (100, 100) f32 join moves
// 160 KB, well under a launch; (4096, 784) uint8 + (4096, 100) f32 +
// (4096, 10) f32 -> f32 moves 19.7 MB, 5.9 us at 3.35 TB/s.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "row_groups.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_INPUTS = 16;     // table entries a launch takes

// dtype codes shared with veles_tpu_torch/ops/join.py
enum Code { U8 = 0, I8 = 1, I32 = 2, F32 = 3, BF16 = 4, F16 = 5 };

struct Table {
  const void* src[MAX_INPUTS];
  long long width[MAX_INPUTS];
  long long offset[MAX_INPUTS];
  int code[MAX_INPUTS];
  int vec[MAX_INPUTS];
};

template <typename T> struct alignas(4 * sizeof(T)) Aligned4 { T v[4]; };

// element i of a code-typed buffer, as float32 (exact for all but int32,
// which rounds to nearest)
__device__ __forceinline__ float load_f32(int code, const void* p,
                                          long long i) {
  switch (code) {
    case U8: return static_cast<float>(static_cast<const uint8_t*>(p)[i]);
    case I8: return static_cast<float>(static_cast<const int8_t*>(p)[i]);
    case I32: return __int2float_rn(static_cast<const int32_t*>(p)[i]);
    case BF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case F16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// element i of an integer-coded buffer, widened exactly
__device__ __forceinline__ int32_t load_i32(int code, const void* p,
                                            long long i) {
  switch (code) {
    case U8: return static_cast<const uint8_t*>(p)[i];
    case I8: return static_cast<const int8_t*>(p)[i];
    default: return static_cast<const int32_t*>(p)[i];
  }
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, long long g, float* v) {
  const Aligned4<T> a = reinterpret_cast<const Aligned4<T>*>(p)[g];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      v[k] = __bfloat162float(a.v[k]);
    else if constexpr (std::is_same<T, __half>::value)
      v[k] = __half2float(a.v[k]);
    else if constexpr (std::is_same<T, int32_t>::value)
      v[k] = __int2float_rn(a.v[k]);
    else
      v[k] = static_cast<float>(a.v[k]);
  }
}

// 4 consecutive elements (group g) of a code-typed buffer, as float32
__device__ __forceinline__ void load4_f32(int code, const void* p,
                                          long long g, float* v) {
  switch (code) {
    case U8: load4(static_cast<const uint8_t*>(p), g, v); break;
    case I8: load4(static_cast<const int8_t*>(p), g, v); break;
    case I32: load4(static_cast<const int32_t*>(p), g, v); break;
    case BF16: load4(static_cast<const __nv_bfloat16*>(p), g, v); break;
    case F16: load4(static_cast<const __half*>(p), g, v); break;
    default: load4(static_cast<const float*>(p), g, v);
  }
}

__device__ __forceinline__ void load4_i32(int code, const void* p,
                                          long long g, int32_t* v) {
  for (int k = 0; k < 4; ++k) v[k] = load_i32(code, p, 4 * g + k);
}

template <typename Out> struct IsFloatOut {
  static constexpr bool value = std::is_same<Out, float>::value ||
                                std::is_same<Out, __nv_bfloat16>::value ||
                                std::is_same<Out, __half>::value;
};

template <typename Out>
__device__ __forceinline__ Out from_f32(float v) {
  if constexpr (std::is_same<Out, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else if constexpr (std::is_same<Out, __half>::value)
    return __float2half_rn(v);
  else
    return v;
}

template <typename Out>
__device__ __forceinline__ Out element(int code, const void* p,
                                       long long i) {
  if constexpr (IsFloatOut<Out>::value)
    return from_f32<Out>(load_f32(code, p, i));
  else
    return static_cast<Out>(load_i32(code, p, i));
}

template <typename Out>
__global__ void __launch_bounds__(THREADS)
join_kernel(Table t, Out* __restrict__ out, long long batch,
            long long out_width, int rows) {
  const int j = blockIdx.z;
  const void* src = t.src[j];
  const int code = t.code[j];
  const long long width = t.width[j];
  const long long offset = t.offset[j];
  const bool vec = t.vec[j] != 0;
  const long long u = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (u >= (vec ? width / 4 : width)) return;
  for (long long row0 = blockIdx.y * static_cast<long long>(rows);
       row0 < batch; row0 += gridDim.y * static_cast<long long>(rows)) {
    for (int k = 0; k < rows; ++k) {
      const long long row = row0 + k;
      if (row >= batch) break;
      Out* o = out + row * out_width + offset;
      if (!vec) {
        o[u] = element<Out>(code, src, row * width + u);
        continue;
      }
      const long long g = row * (width / 4) + u;   // input 4-group
      Aligned4<Out> w;
      if constexpr (IsFloatOut<Out>::value) {
        float v[4];
        load4_f32(code, src, g, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) w.v[e] = from_f32<Out>(v[e]);
      } else {
        int32_t v[4];
        load4_i32(code, src, g, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) w.v[e] = static_cast<Out>(v[e]);
      }
      reinterpret_cast<Aligned4<Out>*>(o)[u] = w;
    }
  }
}

int element_size(int code) {
  switch (code) {
    case U8: case I8: return 1;
    case BF16: case F16: return 2;
    default: return 4;
  }
}

template <typename Out>
cudaError_t launch(Table t, int n, void* out, long long batch,
                   long long out_width, int device, cudaStream_t stream) {
  long long units = 0;
  for (int j = 0; j < n; ++j) {
    const long long u = t.vec[j] ? t.width[j] / 4 : t.width[j];
    if (u > units) units = u;
  }
  if (units == 0) return cudaSuccess;
  const long long chunks = (units + THREADS - 1) / THREADS;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  RowGroups g;
  const cudaError_t err = row_groups(batch, chunks * n, device, &g);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(chunks), g.groups, n);
  join_kernel<Out><<<grid, THREADS, 0, stream>>>(
      t, static_cast<Out*>(out), batch, out_width, g.rows);
  return cudaGetLastError();
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" int veles_join(const void* const* srcs, const long long* widths,
                          const long long* offsets, const int* codes, int n,
                          void* out, long long batch, long long out_width,
                          int out_code, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > MAX_INPUTS || out_code < U8 || out_code > F16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || out_width <= 0) return static_cast<int>(cudaSuccess);
  Table t = {};
  const int out_size = element_size(out_code);
  for (int j = 0; j < n; ++j) {
    if (codes[j] < U8 || codes[j] > F16 || widths[j] < 0 ||
        offsets[j] < 0 || offsets[j] + widths[j] > out_width)
      return static_cast<int>(cudaErrorInvalidValue);
    t.src[j] = srcs[j];
    t.width[j] = widths[j];
    t.offset[j] = offsets[j];
    t.code[j] = codes[j];
    t.vec[j] = widths[j] % 4 == 0 && offsets[j] % 4 == 0 &&
               out_width % 4 == 0 &&
               aligned(srcs[j], 4LL * element_size(codes[j])) &&
               aligned(out, 4LL * out_size);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case U8: err = launch<uint8_t>(t, n, out, batch, out_width, device, s); break;
    case I8: err = launch<int8_t>(t, n, out, batch, out_width, device, s); break;
    case I32: err = launch<int32_t>(t, n, out, batch, out_width, device, s); break;
    case F32: err = launch<float>(t, n, out, batch, out_width, device, s); break;
    case BF16:
      err = launch<__nv_bfloat16>(t, n, out, batch, out_width, device, s);
      break;
    default: err = launch<__half>(t, n, out, batch, out_width, device, s);
  }
  return static_cast<int>(err);
}
