// Column and row sums of a matrix, for Hopper (sm_90a).
//
// Replaces the Pallas kernels veles_tpu/ops/reduce.py:47 (reduce_cols ->
// _reduce_cols_kernel) and veles_tpu/ops/reduce.py:85 (reduce_rows ->
// _reduce_rows_kernel): (M, N) float32, bfloat16 or float16 in, the sums
// accumulated in float32 and written in the input's dtype (round to
// nearest even).  The TPU kernels walk the reduced axis in order on one
// core, carrying an f32 accumulator in scratch; here blocks run in
// parallel, and each sum is still taken in an order fixed by the shape
// (the same inputs give the same bits):
//
//   columns: one launch.  A block sums a tile of columns over a chunk of
//     rows: warp w takes the chunk's rows w, w + 8, ..., each lane one
//     16-byte word a row (4 f32 or 8 bf16/f16 columns, VEC f32
//     accumulators) with 8 rows' loads in flight, and the 8 warps' sums
//     meet in shared memory, added in warp order.  Where every row
//     starts on a 16-byte boundary (784 f32 of the MNIST train set,
//     4,096 bf16) a tile is 32 lanes' words; else (rows of 3,001 f32
//     start anywhere) 31 lanes' columns, read as 32 words from the
//     boundary before the tile, each warp at its rows' own skew.  With
//     enough tiles a block owns its columns whole ("whole_col", no
//     scratch: 32 x 25,088 f32 is 196 tiles); too few tiles to fill the
//     card (60,000 x 784 f32 is 7) are split over chunks of rows
//     ("split_col"): each block writes its tile's f32 partial to a
//     scratch (chunks, tiles x tile) and takes its tile's ticket; the
//     block that draws the last ticket adds the tile's partials (warp w
//     the chunks w, w + 8, ..., then the warps in order), writes the
//     tile and sets its ticket back to 0.
//   rows: one launch.  A row is summed by a group of threads: a warp, a
//     few warps or the whole block of 256, as few as give each thread
//     one round of up to 8 16-byte loads (8 rows a block at the MNIST
//     train set's 60,000 x 784, 2 at 3,001 f32), more when the rows are
//     too few to fill the card (2 at the 100 x 784 of a minibatch).  A
//     thread peels the row's head to a 16-byte boundary (rows of 3,001
//     f32 start anywhere), then loads 4 f32 or 8 bf16/f16 a load, 8
//     loads in flight, and the tail; a shuffle tree
//     and the group's warps, in warp order, give the row's sum, which
//     the group writes (the "whole_row" design, no scratch).  Few long
//     rows, such as the 32 of 25,088 of VGG16's fc1 input at batch 32,
//     are split over blocks ("split"): each block writes its chunk's
//     f32 partial to a scratch (M, chunks), then takes a ticket of its
//     row (__threadfence, atomicAdd); the block that draws the last
//     ticket sums the row's partials (lane l the chunks l, l + 32, ...,
//     then a shuffle tree: an order fixed by chunk index, not by
//     arrival), writes the row and sets its ticket back to 0 for the
//     next launch.
//
// The wrapper chooses the design, the group or lane shape and the chunks
// (from the SM count), allocates the output and, when split, the
// partials, and keeps one zeroed ticket array per (device, stream) of
// 4 x SMs entries, which row and column launches share (launches on one
// stream run in order, and each leaves its tickets at 0).  What bounds
// it on the card: bytes, the input read once; (60000, 784) f32 is 188
// MB, 0.056 ms at 3.35 TB/s, (3001, 3001) f32 36 MB, 0.0108 ms.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

// dtype codes shared with veles_tpu_torch/ops/reduce.py
enum Code { F32 = 0, BF16 = 1, F16 = 2 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL_COLS = 8;  // column sums: rows a lane loads at once
constexpr int UNROLL_ROWS = 8;  // row sums: 16-byte loads in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(v);
  else
    return v;
}

// What a lane loads of one row: VEC elements of T as 16-byte words.
template <typename T, int VEC>
struct Lane {
  static_assert(VEC * sizeof(T) % 16 == 0, "a lane loads 16-byte words");
  static constexpr int WORDS = VEC * sizeof(T) / 16;
  uint4 w[WORDS];
};

// CG: through L2 only, for what other blocks of this launch wrote
template <bool CG>
__device__ __forceinline__ uint4 load_word(const uint4* p) {
  if constexpr (CG)
    return __ldcg(p);
  else
    return *p;
}

// acc[k] += p[i * stride + k] over the rows i = r, r + WARPS, ... below
// r1, in order, with U rows' loads in flight (p + i * stride 16-byte
// aligned)
template <typename T, int VEC, int U, bool CG>
__device__ __forceinline__ void sum_rows(const T* p, long long stride,
                                         long long r, long long r1,
                                         float (&acc)[VEC]) {
  using L = Lane<T, VEC>;
  for (; r < r1; r += U * WARPS) {
    L raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = r + static_cast<long long>(u) * WARPS;
      const uint4* src = reinterpret_cast<const uint4*>(p + i * stride);
#pragma unroll
      for (int k = 0; k < L::WORDS; ++k)
        raw[u].w[k] = i < r1 ? load_word<CG>(src + k)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + static_cast<long long>(u) * WARPS >= r1) break;
      T v[VEC];
      memcpy(v, raw[u].w, sizeof(v));
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], to_f32(v[k]));
    }
  }
}

// A lane's VEC sums into its warp's row of the tile in shared memory:
// element k is the tile's column lane * VEC + k - skew; the elements
// outside [0, TILE) belong to the tiles beside it.  A tile of 32 lanes
// has no skew and stores 16 bytes at a time.
template <int VEC, int TILE>
__device__ __forceinline__ void stash(float* row, int lane, int skew,
                                      const float (&acc)[VEC]) {
  if constexpr (TILE == 32 * VEC) {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      reinterpret_cast<float4*>(row + lane * VEC)[k] = make_float4(
          acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int col = lane * VEC + k - skew;
      if (col >= 0 && col < TILE) row[col] = acc[k];
    }
  }
}

// thread t < TILE: column t's sum over the warps' rows, in warp order
template <int TILE>
__device__ __forceinline__ float warps_total(const float (&sums)[WARPS][TILE],
                                             int t) {
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total = __fadd_rn(total, sums[w][t]);
  return total;
}

// Column sums.  Block (t, c) sums tile t, the TILE = LANES * VEC columns
// from t * TILE, over chunk c of the rows; out = the tile's sums,
// written by the block (one chunk) or by the tile's last block to
// finish (several).  A lane loads one 16-byte word (VEC elements) a row.
// LANES 32: every row starts on a 16-byte boundary, and lane l's word
// is the columns l * VEC to l * VEC + VEC - 1.  LANES 31: rows start
// anywhere, but warp w's rows r0 + w, r0 + w + 8, ... lie the same skew
// past a 16-byte boundary (8 rows are a multiple of 16 bytes), so the
// warp reads its 32 words from the boundary at or before the tile's
// first column, skew elements early: lane l's element k is column l *
// VEC + k - skew, and 32 words cover the tile's 31 * VEC columns
// whatever the skew.  (The first word of a row may start before x, in
// the 16-byte granule that holds x[0]; a word past a row's end is not
// read, and one that holds its end adds the next row's elements to
// columns past n, which are never written out.)
template <typename T, int LANES>
__global__ void __launch_bounds__(THREADS, 4)
cols_kernel(const T* __restrict__ x, float* __restrict__ partial,
            unsigned* __restrict__ tickets, T* __restrict__ out,
            long long m, long long n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TILE = LANES * VEC;
  __shared__ __align__(16) float sums[WARPS][TILE];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const long long tile0 = static_cast<long long>(blockIdx.x) * TILE;
  const long long col = tile0 + t;  // the column thread t < TILE writes
  const int c = blockIdx.y;
  const int chunks = gridDim.y;
  const long long r0 = m * c / chunks + warp;
  const int skew =
      LANES == 32 ? 0
                  : static_cast<int>(
                        reinterpret_cast<uintptr_t>(x + r0 * n) % 16 /
                        sizeof(T));
  float acc[VEC] = {};
  if (lane * VEC - skew < n - tile0)
    sum_rows<T, VEC, UNROLL_COLS, false>(x + tile0 - skew + lane * VEC, n,
                                         r0, m * (c + 1) / chunks, acc);
  stash<VEC, TILE>(sums[warp], lane, skew, acc);
  __syncthreads();
  const float total = t < TILE ? warps_total(sums, t) : 0.f;
  if (chunks == 1) {
    if (t < TILE && col < n) out[col] = from_f32<T>(total);
    return;
  }
  // the partials (chunks, tiles * TILE), 16-byte aligned rows
  const long long width = static_cast<long long>(gridDim.x) * TILE;
  if (t < TILE) partial[c * width + col] = total;
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(tickets + blockIdx.x, 1u) ==
           static_cast<unsigned>(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the tile's last block: warp w adds the chunks w, w + WARPS, ... in
  // order, then the warps meet as above (an order fixed by chunk index)
  float fin[VEC] = {};
  if (lane < LANES)
    sum_rows<float, VEC, VEC == 8 ? 4 : 8, true>(
        partial + tile0 + lane * VEC, width, warp, chunks, fin);
  stash<VEC, TILE>(sums[warp], lane, 0, fin);
  __syncthreads();
  if (t < TILE && col < n) out[col] = from_f32<T>(warps_total(sums, t));
  if (t == 0) tickets[blockIdx.x] = 0u;
}

// the float32 sum of the VEC elements of one 16-byte load, in order
template <typename T>
__device__ __forceinline__ float add_vec(float acc, const uint4& raw) {
  constexpr int VEC = 16 / sizeof(T);
  T v[VEC];
  memcpy(v, &raw, 16);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc = __fadd_rn(acc, to_f32(v[i]));
  return acc;
}

// Row sums.  A block holds 1 << group_log2 rows of THREADS >> group_log2
// threads each; grid.y splits each row into chunks (only with one row a
// block).  out[i] = the sum of row i, written by its group (one chunk)
// or by the row's last block to finish (several).
template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const T* __restrict__ x, float* __restrict__ partial,
            unsigned* __restrict__ tickets, T* __restrict__ out,
            long long m, long long n, int group_log2) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float warp_sums[THREADS / 32];
  const int group_threads = THREADS >> group_log2;
  const int g = threadIdx.x / group_threads;
  const int t = threadIdx.x % group_threads;
  const int lane = threadIdx.x % 32;
  const long long row = (static_cast<long long>(blockIdx.x) << group_log2) +
                        g;
  const int c = blockIdx.y;
  const int chunks = gridDim.y;
  float acc = 0.f;
  if (row < m) {
    const T* p = x + row * n;
    const long long skew = (reinterpret_cast<uintptr_t>(p) % 16) / sizeof(T);
    const long long head = min((VEC - skew) % VEC, n);
    const long long vecs = (n - head) / VEC;
    const long long body_end = head + vecs * VEC;
    if (c == 0 && t < head) acc = to_f32(p[t]);
    const uint4* body = reinterpret_cast<const uint4*>(p + head);
    const long long v1 = vecs * (c + 1) / chunks;
    for (long long v = vecs * c / chunks + t; v < v1;
         v += UNROLL_ROWS * group_threads) {
      uint4 raw[UNROLL_ROWS];
#pragma unroll
      for (int u = 0; u < UNROLL_ROWS; ++u) {
        const long long w = v + static_cast<long long>(u) * group_threads;
        raw[u] = w < v1 ? body[w] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL_ROWS; ++u)
        if (v + static_cast<long long>(u) * group_threads < v1)
          acc = add_vec<T>(acc, raw[u]);
    }
    if (c == chunks - 1 && t < n - body_end)
      acc = __fadd_rn(acc, to_f32(p[body_end + t]));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (row >= m || t >= 32) return;
  // the group's first warp: its lane 0 adds the group's warp sums in order
  float total = 0.f;
  if (t == 0) {
    const int warps = group_threads / 32;
    for (int w = 0; w < warps; ++w)
      total = __fadd_rn(total, warp_sums[g * warps + w]);
  }
  if (chunks == 1) {
    if (t == 0) out[row] = from_f32<T>(total);
    return;
  }
  unsigned ticket = 0;
  if (t == 0) {
    partial[row * chunks + c] = total;
    __threadfence();
    ticket = atomicAdd(tickets + row, 1u);
  }
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  if (ticket != static_cast<unsigned>(chunks - 1)) return;
  __threadfence();
  float sum = 0.f;
  for (int k = t; k < chunks; k += 32)
    sum = __fadd_rn(sum, __ldcg(partial + row * chunks + k));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off));
  if (t == 0) {
    out[row] = from_f32<T>(sum);
    tickets[row] = 0u;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* partial, unsigned* tickets,
                   void* out, long long m, long long n, int chunks, int rows,
                   int layout, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (rows) {
    const long long blocks = ((m - 1) >> layout) + 1;
    rows_kernel<T><<<dim3(static_cast<unsigned>(blocks), chunks), THREADS,
                     0, s>>>(xt, partial, tickets, ot, m, n, layout);
  } else {
    const long long tile = layout * static_cast<long long>(16 / sizeof(T));
    const dim3 grid(static_cast<unsigned>((n - 1) / tile + 1), chunks);
    if (layout == 32)
      cols_kernel<T, 32><<<grid, THREADS, 0, s>>>(xt, partial, tickets, ot,
                                                  m, n);
    else
      cols_kernel<T, 31><<<grid, THREADS, 0, s>>>(xt, partial, tickets, ot,
                                                  m, n);
  }
  return cudaGetLastError();
}

}  // namespace

// rows == 0: out (N,) = column sums of x (M, N), layout lanes a tile:
// 32 (then x 16-byte aligned and N * sizeof(T) a multiple of 16) or 31,
// a tile layout * 16 / sizeof(T) columns, and when chunks > 1 partial an
// f32 scratch of chunks * tiles * that many elements and tickets one
// zeroed counter a tile, left zeroed.
// rows == 1: out (M,) = row sums, 1 << layout rows a block (layout in
// [0, 3]), and when chunks > 1 (one row a block) partial an f32 scratch
// of M * chunks elements and tickets M zeroed counters, left zeroed.
// chunks in [1, 65535]; a split may take at most 4 x SMs tickets (the
// wrapper's array per stream), so tiles (columns) or M (rows) <= 4 x SMs.
extern "C" int veles_reduce(const void* x, void* partial, void* tickets,
                            void* out, long long m, long long n, int chunks,
                            int rows, int layout, int code, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = code == F32 ? 4 : 2;
  if (code < F32 || code > F16 || chunks < 1 || chunks > 65535 || m < 0 ||
      n < 0 || m > 0x7fffffffLL || n > 0x7fffffffLL * 32 ||
      (chunks > 1 && (!partial || !tickets)) ||
      (rows && (layout < 0 || layout > 3 || (chunks > 1 && layout != 0))) ||
      (!rows && layout != 31 &&
       (layout != 32 || n * size % 16 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (chunks > 1) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items = rows ? m : (n - 1) / (layout * 16LL / size) + 1;
    if (items > 4LL * sms) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  unsigned* t = static_cast<unsigned*>(tickets);
  switch (code) {
    case F32:
      err = launch<float>(x, p, t, out, m, n, chunks, rows, layout, s);
      break;
    case BF16:
      err = launch<__nv_bfloat16>(x, p, t, out, m, n, chunks, rows, layout,
                                  s);
      break;
    default:
      err = launch<__half>(x, p, t, out, m, n, chunks, rows, layout, s);
  }
  return static_cast<int>(err);
}
