// int8 x int8 -> int32 matrix product with a fused dequant epilogue,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/matmul_int8.py:183
// (_matmul_int8_jit -> _matmul_int8_kernel): out[i, j] =
// f32(sum_k a[i, k] * b[k, j]) * scale[j] + bias[j], with a (M, K) int8,
// b (K, N) int8, scale and bias (N,) f32, out (M, N) f32, all row-major.
// The TPU kernel carries an int32 accumulator in VMEM scratch across a
// sequential K grid axis and pads every operand to its tile.  Here each
// block owns one BM x BN output tile and walks K itself, so nothing is
// carried between blocks, and it masks the ragged M, N and K edges
// instead of padding the operands.
//
// Products accumulate in int32 with __dp4a on 4-packed int8 words, so
// the sum is exact under any order.  The epilogue is one
// __fmaf_rn(float(acc), scale[j], bias[j]): the JAX side contracts its
// mul + add into an FMA in compiled programs, and this keeps that single
// rounding.
//
// What bounds it on the card: at the serving shapes it is memory-bound.
// VGG16 at batch 32: conv1_2's patch matrix (M 1,605,632, K 576, N 64)
// moves 0.92 GB of int8 in and 0.41 GB of f32 out, about 0.40 ms at
// 3.35 TB/s, against 0.06 ms of int8 tensor-core work; fc1 (32 x 25088
// @ 25088 x 4096) reads 103 MB of weights, about 31 us.  This first
// kernel is simple and exact: A and B tiles staged through shared memory
// (B repacked so that four consecutive k of one column share a word),
// 4 x 4 outputs per thread, no tensor cores, no TMA, no pipelining, one
// fixed tile.  Tall-thin products such as fc1 get only N / 64 blocks.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 64;  // int8 values of K per shared-memory stage
constexpr int TM = 4;   // output rows per thread
constexpr int TN = 4;   // output columns per thread
constexpr int THREADS_X = BN / TN;
constexpr int THREADS_Y = BM / TM;
constexpr int THREADS = THREADS_X * THREADS_Y;
constexpr int KQ = BK / 4;  // packed 4 x int8 words per tile row

__global__ void __launch_bounds__(THREADS)
matmul_int8_kernel(const int8_t* __restrict__ a,
                   const int8_t* __restrict__ b,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   float* __restrict__ out,
                   long long m, long long n, long long k) {
  // as[q][row] holds a[row, 4q .. 4q+3]; the +1 spreads the transposing
  // stores over the banks.  bs[q][col] holds b[4q .. 4q+3, col].
  __shared__ int as[KQ][BM + 1];
  __shared__ int bs[KQ][BN];

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_X;
  const int ty = tid / THREADS_X;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const long long n0 = static_cast<long long>(blockIdx.y) * BN;
  const bool a_words =
      (k % 4 == 0) && ((reinterpret_cast<uintptr_t>(a) & 3) == 0);

  int acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0;

  for (long long k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * KQ; i += THREADS) {
      const int row = i / KQ;
      const int q = i % KQ;
      const long long gm = m0 + row;
      const long long gk = k0 + 4 * q;
      unsigned word = 0;
      if (gm < m && gk < k) {
        const int8_t* src = a + gm * k + gk;
        if (a_words) {
          word = *reinterpret_cast<const unsigned*>(src);
        } else {
          for (int r = 0; r < 4; ++r)
            if (gk + r < k)
              word |= static_cast<unsigned>(static_cast<uint8_t>(src[r]))
                      << (8 * r);
        }
      }
      as[q][row] = static_cast<int>(word);
    }
    for (int i = tid; i < KQ * BN; i += THREADS) {
      const int q = i / BN;
      const int col = i % BN;
      const long long gn = n0 + col;
      const long long gk = k0 + 4 * q;
      unsigned word = 0;
      if (gn < n) {
        for (int r = 0; r < 4; ++r)
          if (gk + r < k)
            word |= static_cast<unsigned>(
                        static_cast<uint8_t>(b[(gk + r) * n + gn]))
                    << (8 * r);
      }
      bs[q][col] = static_cast<int>(word);
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      int av[TM];
      int bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = as[q][ty + r * THREADS_Y];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = bs[q][tx + c * THREADS_X];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          acc[r][c] = __dp4a(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const long long row = m0 + ty + r * THREADS_Y;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const long long col = n0 + tx + c * THREADS_X;
      if (col < n)
        out[row * n + col] =
            __fmaf_rn(__int2float_rn(acc[r][c]), scale[col], bias[col]);
    }
  }
}

}  // namespace

extern "C" int veles_matmul_int8(const void* a, const void* b,
                                 const void* scale, const void* bias,
                                 void* out, long long m, long long n,
                                 long long k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const long long grid_x = (m + BM - 1) / BM;
  const long long grid_y = (n + BN - 1) / BN;
  if (grid_x > 0x7fffffffLL || grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  matmul_int8_kernel<<<grid, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
