// Column and row sums of a matrix, for Hopper (sm_90a).
//
// Replaces the Pallas kernels veles_tpu/ops/reduce.py:47 (reduce_cols ->
// _reduce_cols_kernel) and veles_tpu/ops/reduce.py:85 (reduce_rows ->
// _reduce_rows_kernel): (M, N) float32, bfloat16 or float16 in, the sums
// accumulated in float32 and written in the input's dtype (round to
// nearest even).  The TPU kernels walk the reduced axis in order on one
// core, carrying an f32 accumulator in scratch; here blocks run in
// parallel, so each sum is taken in two passes and a fixed order, with no
// atomics (the same inputs give the same bits):
//
//   columns: pass 1 gives each thread one column of one chunk of rows
//     (loads coalesce along the row; grid.y splits the rows so that a few
//     hundred columns, such as the 784 of the MNIST train set, still fill
//     the SMs) and writes the chunk's f32 partial to a scratch
//     (chunks, N); pass 2 sums the chunks of a column in order.
//   rows: pass 1 gives a block of 256 threads one chunk of columns of one
//     row (grid.y splits long rows, such as the 25,088 of VGG16's fc1
//     input at batch 32, when there are few of them); each thread sums a
//     strided share, a shuffle tree and a shared-memory tree combine the
//     block's 256 sums, and the chunk's partial goes to a scratch
//     (M, chunks); pass 2 sums a row's chunks in order.
//
// The wrapper chooses the chunks (from the SM count) and allocates the
// scratch.  What bounds it on the card: bytes, the input read once;
// (60000, 784) f32 is 188 MB, 0.056 ms at 3.35 TB/s.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

// dtype codes shared with veles_tpu_torch/ops/reduce.py
enum Code { F32 = 0, BF16 = 1, F16 = 2 };

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

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

// partial[i, c] = sum of x[i, j] over the columns j of chunk c
template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_partial(const T* __restrict__ x, float* __restrict__ partial,
             long long n, long long cols_per_chunk) {
  __shared__ float warp_sums[THREADS / 32];
  const long long row = blockIdx.x;
  const int c = blockIdx.y;
  const long long j0 = c * cols_per_chunk;
  const long long j1 = min(j0 + cols_per_chunk, n);
  const T* p = x + row * n;
  float acc = 0.f;
  long long j = j0 + threadIdx.x;
  for (; j + (UNROLL - 1) * THREADS < j1; j += UNROLL * THREADS) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = to_f32(p[j + u * THREADS]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; j < j1; j += THREADS) acc = __fadd_rn(acc, to_f32(p[j]));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w)
      total = __fadd_rn(total, warp_sums[w]);
    partial[row * gridDim.y + c] = total;
  }
}

// out[i] = sum over c of partial[i, c], in order of c
template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_final(const float* __restrict__ partial, T* __restrict__ out,
           long long m, int chunks) {
  const long long i = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (i >= m) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c)
    acc = __fadd_rn(acc, partial[i * chunks + c]);
  out[i] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, float* partial, void* out, long long m,
                   long long n, int chunks, int rows, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (rows) {
    const long long per = (n + chunks - 1) / chunks;
    rows_partial<T><<<dim3(static_cast<unsigned>(m), chunks), THREADS, 0,
                      s>>>(xt, partial, n, per);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rows_final<T><<<static_cast<unsigned>((m + THREADS - 1) / THREADS),
                    THREADS, 0, s>>>(partial, ot, m, chunks);
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

// rows == 0: out (N,) = column sums of x (M, N); rows == 1: out (M,) =
// row sums.  partial: f32 scratch of chunks * N (columns) or M * chunks
// (rows) elements; chunks in [1, 65535].
extern "C" int veles_reduce(const void* x, void* partial, void* out,
                            long long m, long long n, int chunks, int rows,
                            int code, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (code < F32 || code > F16 || chunks < 1 || chunks > 65535 || m < 0 ||
      n < 0 || m > 0x7fffffffLL || n > 0x7fffffffLL * THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  switch (code) {
    case F32: err = launch<float>(x, p, out, m, n, chunks, rows, s); break;
    case BF16:
      err = launch<__nv_bfloat16>(x, p, out, m, n, chunks, rows, s);
      break;
    default: err = launch<__half>(x, p, out, m, n, chunks, rows, s);
  }
  return static_cast<int>(err);
}
