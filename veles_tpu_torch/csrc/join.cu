// Concatenation along the feature axis with a cast, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/join.py:47 (join ->
// _make_join_kernel): N inputs of (B, F_i), each in its own dtype, go to
// the column windows [offset_i, offset_i + F_i) of one (B, sum F_i)
// output, cast to the output dtype.  The TPU kernel unrolls the N inputs
// at trace time; here one launch takes a by-value table of up to
// MAX_INPUTS (pointer, width, column offset, dtype code) entries, and the
// wrapper cuts a longer list into launches that write disjoint, adjacent
// column windows.
//
// One flat copy: a launch's 1-D grid covers its window of the output,
// (B, W) flattened, in groups of G = 4 consecutive elements (16 bytes of
// an f32 output), one group a thread and no more threads than groups.  A
// thread finds the input of its first element by comparing the column
// against the table's offsets, and walks on from there; so every output
// element is written once, by one thread, with no atomics.  A group that
// lies in one input, 4-aligned there, reads it with one vector load; a
// launch that covers whole rows (up to 16 inputs) writes every group with
// one vector store, whatever the row width, since the flat output is
// 4-aligned.  Index math is 32-bit where the output allows it, the row
// a multiply-high by a magic number the host works out (no division); a
// launch of up to 4 inputs picks its input's table entry with selects
// on fixed indices, so no load waits on the input's index; and the
// common case, every input of the output's dtype, copies without a
// cast.  On an H100 each of these, and 128-thread blocks over 64, 256 or
// 512, took device time off the (100, 100) + (100, 100) f32 join named
// below, which is launch-bound.
//
// Casts follow the JAX package's kernel_cast: to a float output every
// input goes through float32 (integers and bf16/f16 widen exactly, int32
// rounds to nearest), then rounds to nearest even into bf16/f16 as XLA's
// convert does; to an integer output an integer input widens exactly (the
// wrapper refuses float -> int and narrowing int casts).  An input of the
// output's dtype is copied bit for bit.
//
// What bounds it on the card: bytes, each input read once and the output
// written once.  The unit graph's (100, 100) + (100, 100) f32 join moves
// 160 KB, 0.048 us at 3.35 TB/s, well under a launch; (4096, 784) uint8 +
// (4096, 100) f32 + (4096, 10) f32 -> f32 moves 19.7 MB, 5.9 us.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_INPUTS = 16;     // table entries a launch takes
constexpr int G = 4;               // output elements a thread

// dtype codes shared with veles_tpu_torch/ops/join.py
enum Code { U8 = 0, I8 = 1, I32 = 2, F32 = 3, BF16 = 4, F16 = 5 };

// A launch's inputs; offsets are columns of the launch's window, kept
// once more side by side for the search.
struct Entry {
  const void* src;
  long long width;
  long long offset;
  int code;
  int vload;   // width % G == 0 and the pointer G-aligned
};
struct Table {
  long long offset[MAX_INPUTS];
  Entry e[MAX_INPUTS];
};

template <typename T> struct alignas(G * sizeof(T)) Aligned4 { T v[G]; };

// element i of a code-typed buffer, as float32 (exact for all but int32,
// which rounds to nearest)
template <typename I>
__device__ __forceinline__ float load_f32(int code, const void* p, I i) {
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
template <typename I>
__device__ __forceinline__ int32_t load_i32(int code, const void* p, I i) {
  switch (code) {
    case U8: return static_cast<const uint8_t*>(p)[i];
    case I8: return static_cast<const int8_t*>(p)[i];
    default: return static_cast<const int32_t*>(p)[i];
  }
}

template <typename T, typename I>
__device__ __forceinline__ void load4(const T* p, I g, float* v) {
  const Aligned4<T> a = reinterpret_cast<const Aligned4<T>*>(p)[g];
#pragma unroll
  for (int k = 0; k < G; ++k) {
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

// G consecutive elements (group g) of a code-typed buffer, as float32
template <typename I>
__device__ __forceinline__ void load4_f32(int code, const void* p, I g,
                                          float* v) {
  switch (code) {
    case U8: load4(static_cast<const uint8_t*>(p), g, v); break;
    case I8: load4(static_cast<const int8_t*>(p), g, v); break;
    case I32: load4(static_cast<const int32_t*>(p), g, v); break;
    case BF16: load4(static_cast<const __nv_bfloat16*>(p), g, v); break;
    case F16: load4(static_cast<const __half*>(p), g, v); break;
    default: load4(static_cast<const float*>(p), g, v);
  }
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

// element i of input p as Out; SAME: p holds Out already
template <typename Out, bool SAME, typename I>
__device__ __forceinline__ Out element(int code, const void* p, I i) {
  if constexpr (SAME)
    return static_cast<const Out*>(p)[i];
  else if constexpr (IsFloatOut<Out>::value)
    return from_f32<Out>(load_f32(code, p, i));
  else
    return static_cast<Out>(load_i32(code, p, i));
}

// group g (G elements, G-aligned) of input p as Out
template <typename Out, bool SAME, typename I>
__device__ __forceinline__ void group(int code, const void* p, I g,
                                      Out (&v)[G]) {
  if constexpr (SAME) {
    const Aligned4<Out> a = reinterpret_cast<const Aligned4<Out>*>(p)[g];
#pragma unroll
    for (int e = 0; e < G; ++e) v[e] = a.v[e];
  } else if constexpr (IsFloatOut<Out>::value) {
    float f[G];
    load4_f32(code, p, g, f);
#pragma unroll
    for (int e = 0; e < G; ++e) v[e] = from_f32<Out>(f[e]);
  } else {
#pragma unroll
    for (int e = 0; e < G; ++e)
      v[e] = static_cast<Out>(load_i32(code, p, G * g + e));
  }
}

// The launch's window, columns [first, first + win) of every row of the
// (B, out_width) output, flattened into `total` = B win elements; the
// thread's group starts at element i0 of it.  `vstore`: the window is
// the whole row and the output G-aligned, so the group is G consecutive,
// aligned output elements.  (mul, shift): i / win as (umulhi(i, mul) + i)
// >> shift, exact for i < 2^31 (the 32-bit path).  The input is the last
// whose offset is at or below the column (offsets never decrease; an
// empty input gives way to the next); NMAX bounds the search.
template <typename Out, bool SAME, typename I, int NMAX>
__global__ void __launch_bounds__(THREADS)
join_kernel(const __grid_constant__ Table t, int n, Out* __restrict__ out,
            I out_width, I first, I win, I total, int vstore,
            unsigned mul, int shift) {
  const I i0 = (static_cast<I>(blockIdx.x) * THREADS +
                static_cast<I>(threadIdx.x)) * G;
  if (i0 >= total) return;
  I row;
  if constexpr (sizeof(I) == 4)
    row = static_cast<I>((__umulhi(static_cast<unsigned>(i0), mul) +
                          static_cast<unsigned>(i0)) >> shift);
  else
    row = i0 / win;
  I col = i0 - row * win;
  int j = 0;
  Entry en = t.e[0];
#pragma unroll
  for (int k = 1; k < NMAX; ++k)
    if (k < n && col >= static_cast<I>(t.offset[k])) {
      j = k;
      en = t.e[k];
    }
  I off = static_cast<I>(en.offset);
  I width = static_cast<I>(en.width);
  const bool full = i0 + G <= total;
  Out v[G];
  if (full && en.vload && (col - off) % G == 0 && col - off + G <= width) {
    group<Out, SAME>(en.code, en.src, (row * width + col - off) / G, v);
    if (vstore) {
      Aligned4<Out> w;
#pragma unroll
      for (int e = 0; e < G; ++e) w.v[e] = v[e];
      *reinterpret_cast<Aligned4<Out>*>(out + i0) = w;
    } else {
      Out* o = out + row * out_width + first + col;
#pragma unroll
      for (int e = 0; e < G; ++e) o[e] = v[e];
    }
    return;
  }
  // a group across inputs or rows, or not aligned: element by element
#pragma unroll
  for (int e = 0; e < G; ++e) {
    if (i0 + e >= total) break;
    while (col - off >= width) {   // the next input (or past empty ones)
      en = t.e[++j];
      off = static_cast<I>(en.offset);
      width = static_cast<I>(en.width);
    }
    v[e] = element<Out, SAME>(en.code, en.src, row * width + col - off);
    if (!vstore) out[row * out_width + first + col] = v[e];
    if (++col == win) {
      col = 0;
      ++row;
      j = 0;
      en = t.e[0];
      off = static_cast<I>(en.offset);
      width = static_cast<I>(en.width);
    }
  }
  if (vstore) {
    if (full) {
      Aligned4<Out> w;
#pragma unroll
      for (int e = 0; e < G; ++e) w.v[e] = v[e];
      *reinterpret_cast<Aligned4<Out>*>(out + i0) = w;
    } else {
#pragma unroll
      for (int e = 0; e < G; ++e)
        if (i0 + e < total) out[i0 + e] = v[e];
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

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// A launch's arguments after the table.
struct Args {
  void* out;
  long long out_width, first, win, total;
  int vstore;
  cudaStream_t stream;
};

template <typename Out, bool SAME, typename I, int NMAX>
cudaError_t launch_as(const Table& t, int n, const Args& a) {
  const long long blocks = (a.total + G * THREADS - 1) / (G * THREADS);
  // row = (umulhi(i, mul) + i) >> shift = i / win for i < 2^31
  int shift = 0;
  while ((1LL << shift) < a.win) ++shift;
  const unsigned mul = static_cast<unsigned>(
      ((1ULL << 32) * ((1ULL << shift) - a.win)) / a.win + 1);
  join_kernel<Out, SAME, I, NMAX><<<static_cast<unsigned>(blocks), THREADS,
                                    0, a.stream>>>(
      t, n, static_cast<Out*>(a.out), static_cast<I>(a.out_width),
      static_cast<I>(a.first), static_cast<I>(a.win),
      static_cast<I>(a.total), a.vstore, mul, shift);
  return cudaGetLastError();
}

template <typename Out, int NMAX>
cudaError_t launch_n(const Table& t, int n, bool same, bool small,
                     const Args& a) {
  if (same)
    return small ? launch_as<Out, true, int, NMAX>(t, n, a)
                 : launch_as<Out, true, long long, NMAX>(t, n, a);
  return small ? launch_as<Out, false, int, NMAX>(t, n, a)
               : launch_as<Out, false, long long, NMAX>(t, n, a);
}

template <typename Out>
cudaError_t launch(const Table& t, int n, bool same, void* out,
                   long long batch, long long out_width, long long first,
                   long long win, cudaStream_t stream) {
  const long long total = batch * win;
  if ((total + G * THREADS - 1) / (G * THREADS) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Args a = {out, out_width, first, win, total,
                  win == out_width &&
                      aligned(out, G * static_cast<long long>(sizeof(Out))),
                  stream};
  // 32-bit indices when every output index (and so every input index)
  // and every thread's first element fit
  const bool small = batch * out_width + G * THREADS <= INT_MAX;
  return n <= 4 ? launch_n<Out, 4>(t, n, same, small, a)
                : launch_n<Out, MAX_INPUTS>(t, n, same, small, a);
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
  const long long first = offsets[0];
  bool same = true;
  for (int j = 0; j < n; ++j) {
    // the inputs lie side by side in the window [first, first + win)
    if (codes[j] < U8 || codes[j] > F16 || widths[j] < 0 ||
        offsets[j] != (j ? offsets[j - 1] + widths[j - 1] : first) ||
        first < 0 || offsets[j] + widths[j] > out_width)
      return static_cast<int>(cudaErrorInvalidValue);
    t.offset[j] = offsets[j] - first;
    t.e[j].src = srcs[j];
    t.e[j].width = widths[j];
    t.e[j].offset = offsets[j] - first;
    t.e[j].code = codes[j];
    t.e[j].vload = widths[j] % G == 0 &&
                 aligned(srcs[j], G * static_cast<long long>(
                                      element_size(codes[j])));
    same = same && codes[j] == out_code;
  }
  const long long win = offsets[n - 1] + widths[n - 1] - first;
  if (win == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case U8:
      err = launch<uint8_t>(t, n, same, out, batch, out_width, first, win, s);
      break;
    case I8:
      err = launch<int8_t>(t, n, same, out, batch, out_width, first, win, s);
      break;
    case I32:
      err = launch<int32_t>(t, n, same, out, batch, out_width, first, win, s);
      break;
    case F32:
      err = launch<float>(t, n, same, out, batch, out_width, first, win, s);
      break;
    case BF16:
      err = launch<__nv_bfloat16>(t, n, same, out, batch, out_width, first,
                                  win, s);
      break;
    default:
      err = launch<__half>(t, n, same, out, batch, out_width, first, win, s);
  }
  return static_cast<int>(err);
}
