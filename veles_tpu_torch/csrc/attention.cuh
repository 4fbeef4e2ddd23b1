// Pieces shared by csrc/attention_fwd.cu and csrc/attention_bwd.cu.
//
// Tiles.  A block of THREADS = 256 threads works on B x B score tiles,
// B = 64.  Thread (ty, tx), ty and tx in [0, 16), owns the score rows
// ty + 16 i and the score columns tx + 16 j (i, j < R = B / 16 = 4), and
// the output columns tx * 4 + 64 nv .. + 3 (nv < NV) of its R rows.  The
// head dimension is padded in shared memory to DHP = 64 * NV (64 or 128)
// with zeros, whose products add exactly +0 to every sum.
//
// Shared-memory layouts.  Operand tiles are row-major [B][DHP + 4] f32;
// probability tiles [B][B + 4].  The +4 keeps every row 16-byte aligned
// for float4 reads and spreads the rows of neighbouring threads over the
// banks.  Rows at or past T load as zeros, so nothing past T reaches a
// sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int B = 64;        // q and k rows of a tile
constexpr int R = B / 16;    // score rows (and columns) of a thread
constexpr int LDP = B + 4;   // row stride of a probability tile
// finite -inf stand-in for masked key columns (veles_tpu/ops/attention.py
// _MASK_FLOOR): exp(-1e30 - m) is an exact 0, and -1e30 - -1e30 is 0
constexpr float MASK_FLOOR = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The 16 lanes of a half-warp hold one score row between them.
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dst[r][d] = src[row0 + r][d] in f32 for rows below t and d < dh, else
// 0.  src is a (t, dh) row-major matrix.
template <int DHP, typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int row0, int t, int dh) {
  constexpr int LD = DHP + 4;
  for (int idx = threadIdx.x; idx < B * DHP; idx += THREADS) {
    const int r = idx / DHP;
    const int d = idx % DHP;
    const int row = row0 + r;
    float v = 0.f;
    if (row < t && d < dh)
      v = to_f32(src[static_cast<long long>(row) * dh + d]);
    dst[r * LD + d] = v;
  }
}

// s[i][j] = sum over d, in order, of a[ty + 16 i][d] * b[tx + 16 j][d]:
// the q.k (or do.v) dot products of one score tile, true-f32 FMA.
template <int DHP>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&s)[R][R]) {
  constexpr int LD = DHP + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DHP; d += 4) {
    float4 av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < R; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float acc = s[i][j];
        acc = __fmaf_rn(av[i].x, bv[j].x, acc);
        acc = __fmaf_rn(av[i].y, bv[j].y, acc);
        acc = __fmaf_rn(av[i].z, bv[j].z, acc);
        acc = __fmaf_rn(av[i].w, bv[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// acc[i][4 nv + e] += sum over c, in order, of p[ty + 16 i][c] *
// x[c][64 nv + 4 tx + e]: a probability tile (B x B) times an operand
// tile (B x DHP), into the thread's output columns.
template <int NV>
__device__ __forceinline__ void tile_acc(const float* p, const float* x,
                                         int ty, int tx,
                                         float (&acc)[R][4 * NV]) {
  constexpr int LD = 64 * NV + 4;
#pragma unroll 2
  for (int c = 0; c < B; c += 4) {
    float4 pr[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      pr[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * LDP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const float4 xv = *reinterpret_cast<const float4*>(
            x + (c + cc) * LD + nv * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float pv = lane(pr[i], cc);
          acc[i][nv * 4 + 0] = __fmaf_rn(pv, xv.x, acc[i][nv * 4 + 0]);
          acc[i][nv * 4 + 1] = __fmaf_rn(pv, xv.y, acc[i][nv * 4 + 1]);
          acc[i][nv * 4 + 2] = __fmaf_rn(pv, xv.z, acc[i][nv * 4 + 2]);
          acc[i][nv * 4 + 3] = __fmaf_rn(pv, xv.w, acc[i][nv * 4 + 3]);
        }
      }
  }
}

// The thread's R x (4 NV) outputs, acc / div, into rows row0 + ty + 16 i
// of a (t, dh) matrix; rows at or past t are not written.
template <int NV, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&acc)[R][4 * NV],
                                           const float (&div)[R], int row0,
                                           int t, int dh, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = nv * 64 + tx * 4 + e;
        if (d < dh)
          dst[static_cast<long long>(row) * dh + d] =
              from_f32<T>(__fdiv_rn(acc[i][nv * 4 + e], div[i]));
      }
  }
}

// The preamble of every C entry point: the device, then the arguments
// checked against the kernels' domain.
inline cudaError_t prepare(int device, long long b, long long t,
                           long long dh, int dtype) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b < 1 || b > 2147483647LL || t < 1 || dh < 1 || dh > 128 ||
      t * dh > 2147483647LL || (t + B - 1) / B > 65535 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// L<NV, T>(...) for the head width and the dtype code: NV = 1 for
// dh <= 64 (tiles padded to 64 columns), else 2; T = float for dtype 0,
// __nv_bfloat16 for 1.
#define ATTENTION_DISPATCH(L, dh, dtype, ...)                        \
  ((dtype) == 1 ? ((dh) <= 64 ? L<1, __nv_bfloat16>(__VA_ARGS__)     \
                              : L<2, __nv_bfloat16>(__VA_ARGS__))    \
                : ((dh) <= 64 ? L<1, float>(__VA_ARGS__)             \
                              : L<2, float>(__VA_ARGS__)))
