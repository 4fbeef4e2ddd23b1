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
//   columns: pass 1 gives each thread one column of one chunk of rows
//     (loads coalesce along the row; grid.y splits the rows so that a few
//     hundred columns, such as the 784 of the MNIST train set, still fill
//     the SMs) and writes the chunk's f32 partial to a scratch
//     (chunks, N); pass 2 sums the chunks of a column in order.
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
// The wrapper chooses the design, the group and the chunks (from the SM
// count), allocates the output and, when split, the partials, and keeps
// one zeroed ticket array per (device, stream).  What bounds it on the
// card: bytes, the input read once; (60000, 784) f32 is 188 MB, 0.056 ms
// at 3.35 TB/s, (3001, 3001) f32 36 MB, 0.0108 ms.
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
constexpr int UNROLL = 8;       // column sums: rows a thread loads at once
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

// partial[c, j] = sum of x[i, j] over the rows i of chunk c, in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
cols_partial(const T* __restrict__ x, float* __restrict__ partial,
             long long m, long long n, long long rows_per_chunk) {
  const long long j = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (j >= n) return;
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, m);
  const T* p = x + j;
  float acc = 0.f;
  long long i = r0;
  for (; i + UNROLL <= r1; i += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = to_f32(p[(i + u) * n]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; i < r1; ++i) acc = __fadd_rn(acc, to_f32(p[i * n]));
  partial[blockIdx.y * n + j] = acc;
}

// out[j] = sum over c of partial[c, j], in order of c
template <typename T>
__global__ void __launch_bounds__(THREADS)
cols_final(const float* __restrict__ partial, T* __restrict__ out,
           long long n, int chunks) {
  const long long j = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (j >= n) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc = __fadd_rn(acc, partial[c * n + j]);
  out[j] = from_f32<T>(acc);
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
                   int group_log2, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (rows) {
    const long long blocks = ((m - 1) >> group_log2) + 1;
    rows_kernel<T><<<dim3(static_cast<unsigned>(blocks), chunks), THREADS,
                     0, s>>>(xt, partial, tickets, ot, m, n, group_log2);
  } else {
    const long long per = (m + chunks - 1) / chunks;
    const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) /
                                                  THREADS);
    cols_partial<T><<<dim3(blocks, chunks), THREADS, 0, s>>>(xt, partial,
                                                             m, n, per);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cols_final<T><<<blocks, THREADS, 0, s>>>(partial, ot, n, chunks);
  }
  return cudaGetLastError();
}

}  // namespace

// rows == 0: out (N,) = column sums of x (M, N), partial an f32 scratch
// of chunks * N elements; rows == 1: out (M,) = row sums, 1 << group_log2
// rows a block (group_log2 in [0, 3]), and when chunks > 1 (one row a
// block) partial an f32 scratch of M * chunks elements and tickets M
// zeroed counters, left zeroed.  chunks in [1, 65535].
extern "C" int veles_reduce(const void* x, void* partial, void* tickets,
                            void* out, long long m, long long n, int chunks,
                            int rows, int group_log2, int code, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (code < F32 || code > F16 || chunks < 1 || chunks > 65535 || m < 0 ||
      n < 0 || m > 0x7fffffffLL || n > 0x7fffffffLL * THREADS ||
      (rows && (group_log2 < 0 || group_log2 > 3 ||
                (chunks > 1 && (group_log2 != 0 || !tickets)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  unsigned* t = static_cast<unsigned*>(tickets);
  switch (code) {
    case F32:
      err = launch<float>(x, p, t, out, m, n, chunks, rows, group_log2, s);
      break;
    case BF16:
      err = launch<__nv_bfloat16>(x, p, t, out, m, n, chunks, rows,
                                  group_log2, s);
      break;
    default:
      err = launch<__half>(x, p, t, out, m, n, chunks, rows, group_log2, s);
  }
  return static_cast<int>(err);
}
