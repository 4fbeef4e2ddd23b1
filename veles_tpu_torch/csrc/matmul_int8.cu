// int8 x int8 -> int32 matrix product with a fused dequant epilogue,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/matmul_int8.py:183
// (_matmul_int8_jit -> _matmul_int8_kernel): out[i, j] =
// f32(sum_k a[i, k] * b[k, j]) * scale[j] + bias[j], with a (M, K) int8
// row-major, b given K-major as bt (N, K) int8 row-major (the wrapper,
// or the engine once per weight, makes that copy: the tensor cores'
// 8-bit B operand is K-major), scale and bias (N,) f32, out (M, N) f32.
// K is a multiple of 16 (the wrapper pads both operands with zeros,
// which is exact in int32), so every row is whole 16-byte chunks.
//
// The TPU kernel carries an int32 accumulator in VMEM scratch across a
// sequential K grid axis.  Here a block owns one BM x BN output tile and
// a range of K: a ring of STAGES shared-memory stages is filled with
// 16-byte cp.async copies (zero-filled past the M, N and K edges) while
// the tensor cores run mma.sync m16n8k32 s8 -> s32 on the stage that
// has landed.  Integer sums are exact in any order, so the bits do not
// depend on the tiling.  The tile is sized to the layer: 128 x 64 for
// conv1_x (N = 64), 128 x 128 for the wider convs, 32 x 128 for the fc
// layers at small batch.
//
// Tall, thin products (fc1-fc3 at rung 32: 32 x 128 tiles give only
// N / 128 blocks) split K across blocks: split s sums its K-steps into
// its own int32 slice of a workspace, and a second launch adds the
// slices (exactly, in split order) and applies the epilogue once.
//
// The epilogue is one __fmaf_rn(float(acc), scale[j], bias[j]): the JAX
// side contracts its mul + add into an FMA in compiled programs, and
// this keeps that single rounding.
//
// What bounds it on the card: bytes.  conv1_2 at rung 8 (M 401,408, K
// 576, N 64) moves 231 MB of int8 in and 103 MB of f32 out, 0.0997 ms at
// 3.35 TB/s, against 0.015 ms of int8 tensor-core work; fc1 at rung 32
// (32 x 25088 @ 25088 x 4096) reads 103 MB of weights, 0.031 ms.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.  Every kernel's name holds
// "matmul_int8" (the serve profile sums device time by that name).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int BK = 64;          // int8 values of K a stage holds
constexpr int ROW = BK + 16;    // bytes a shared row: 80, so that the
                                // fragment loads hit 32 distinct banks
constexpr int STAGES = 4;

template <int BM, int BN, int WM, int WN>
struct Tile {
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int WTM = BM / WM;   // a warp's rows
  static constexpr int WTN = BN / WN;   // a warp's columns
  static constexpr int MT = WTM / 16;
  static constexpr int NT = WTN / 8;
  static constexpr int STAGE_BYTES = (BM + BN) * ROW;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ uint32_t word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_int8_tc_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ bt,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int* __restrict__ ws,
                      long long m, long long n, long long k, int n_tiles,
                      int splits) {
  using T = Tile<BM, BN, WM, WN>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / WN) * T::WTM, wn = (warp % WN) * T::WTN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x % n_tiles) * BN;
  const int split = blockIdx.y;
  long long s0, s1;
  gemm::split_range(split, splits, (k + BK - 1) / BK, &s0, &s1);
  const int steps = static_cast<int>(s1 - s0);

  // Stage `stage` <- K-step `step`: A rows then B rows, four 16-byte
  // chunks each; chunks past an edge read nothing and land as zeros.
  auto load = [&](int stage, long long step) {
    uint8_t* as = smem + stage * T::STAGE_BYTES;
    const long long k0 = step * BK;
    for (int c = tid; c < (BM + BN) * 4; c += T::THREADS) {
      const int row = c >> 2, ch = c & 3;
      const long long kk = k0 + ch * 16;
      const int8_t* src;
      bool in;
      if (row < BM) {
        in = m0 + row < m && kk < k;
        src = a + (m0 + row) * k + kk;
      } else {
        in = n0 + row - BM < n && kk < k;
        src = bt + (n0 + row - BM) * k + kk;
      }
      gemm::cp_async16(as + row * ROW + ch * 16, in ? src : a, in ? 16 : 0);
    }
  };

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s0 + s);
    gemm::cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    gemm::cp_async_wait<STAGES - 2>();
    __syncthreads();   // step i landed; step i - 1's stage is free
    if (i + STAGES - 1 < steps)
      load((i + STAGES - 1) % STAGES, s0 + i + STAGES - 1);
    gemm::cp_async_commit();
    const uint8_t* as = smem + (i % STAGES) * T::STAGE_BYTES;
    const uint8_t* bs = as + BM * ROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[T::MT][4], bf[T::NT][2];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const uint8_t* p = as + (wm + mt * 16 + g) * ROW + kk + 4 * t;
        af[mt][0] = word(p);
        af[mt][1] = word(p + 8 * ROW);
        af[mt][2] = word(p + 16);
        af[mt][3] = word(p + 8 * ROW + 16);
      }
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const uint8_t* q = bs + (wn + nt * 8 + g) * ROW + kk + 4 * t;
        bf[nt][0] = word(q);
        bf[nt][1] = word(q + 16);
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
          gemm::mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }

  // Each thread holds column pairs (2t, 2t + 1): one 8-byte store a
  // pair where both columns exist and n is even (aligned), else two.
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + mt * 16 + g + h * 8;
        const long long col = n0 + wn + nt * 8 + 2 * t;
        if (row >= m || col >= n) continue;
        const int* v = acc[mt][nt] + 2 * h;
        if (splits > 1) {
          int* w = ws + (split * m + row) * n + col;
          if (pairs) {
            *reinterpret_cast<int2*>(w) = make_int2(v[0], v[1]);
          } else {
            w[0] = v[0];
            if (col + 1 < n) w[1] = v[1];
          }
          continue;
        }
        const float x = __fmaf_rn(__int2float_rn(v[0]), scale[col],
                                  bias[col]);
        float* o = out + row * n + col;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(
              x, __fmaf_rn(__int2float_rn(v[1]), scale[col + 1],
                           bias[col + 1]));
        } else {
          o[0] = x;
          if (col + 1 < n)
            o[1] = __fmaf_rn(__int2float_rn(v[1]), scale[col + 1],
                             bias[col + 1]);
        }
      }
}

// The splits' int32 slices summed in split order, then the epilogue.
__global__ void matmul_int8_splitk_epilogue(const int* __restrict__ ws,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias,
                                            float* __restrict__ out,
                                            long long m, long long n,
                                            int splits) {
  const long long mn = m * n;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += ws[s * mn + i];
    const long long col = i % n;
    out[i] = __fmaf_rn(__int2float_rn(acc), scale[col], bias[col]);
  }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const int8_t* a, const int8_t* bt, const float* scale,
                   const float* bias, float* out, int* ws, long long m,
                   long long n, long long k, int splits, cudaStream_t s) {
  using T = Tile<BM, BN, WM, WN>;
  const long long mt = (m + BM - 1) / BM, nt = (n + BN - 1) / BN;
  if (mt * nt > INT_MAX || splits > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_int8_tc_kernel<BM, BN, WM, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(mt * nt),
                  static_cast<unsigned>(splits));
  matmul_int8_tc_kernel<BM, BN, WM, WN><<<grid, T::THREADS, T::SMEM, s>>>(
      a, bt, scale, bias, out, ws, m, n, k, static_cast<int>(nt), splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long blocks = (m * n + 255) / 256;
  matmul_int8_splitk_epilogue<<<
      static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      ws, scale, bias, out, m, n, splits);
  return cudaGetLastError();
}

}  // namespace

// out (m, n) = dequant(a (m, k) @ bt (n, k)^T).  k a multiple of 16,
// a and bt 16-byte aligned; `config` the tile (0: 128 x 64, 1: 128 x
// 128, 2: 32 x 128) and `splits` the K split, both from the planner in
// ops/matmul_int8.py; ws holds splits * m * n int32 when splits > 1.
extern "C" int veles_matmul_int8(const void* a, const void* bt,
                                 const void* scale, const void* bias,
                                 void* out, void* ws, long long m,
                                 long long n, long long k, int config,
                                 int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0 || k % 16 != 0 || splits < 1 || (splits > 1 && !ws) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bt)) %
              16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(bt);
  const auto* ps = static_cast<const float*>(scale);
  const auto* pbias = static_cast<const float*>(bias);
  auto* po = static_cast<float*>(out);
  auto* pw = static_cast<int*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0:
      err = launch<128, 64, 4, 2>(pa, pb, ps, pbias, po, pw, m, n, k,
                                  splits, s);
      break;
    case 1:
      err = launch<128, 128, 2, 4>(pa, pb, ps, pbias, po, pw, m, n, k,
                                   splits, s);
      break;
    case 2:
      err = launch<32, 128, 1, 4>(pa, pb, ps, pbias, po, pw, m, n, k,
                                  splits, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
