// Flash-attention forward for Hopper (sm_90a): out and the row logsumexp.
//
// Replaces the Pallas kernel veles_tpu/ops/attention.py:145
// (_flash_fwd_jit -> _fwd_kernel).  For q, k, v of shape (BH, T, dh)
// (batch x heads folded) it computes, row by row,
//   s[r][c] = dot(q[r], k[c]) * scale      (c >= T: -1e30, never -inf)
//   out[r]  = sum_c exp(s[r][c] - m[r]) v[c] / l[r]
//   lse[r]  = m[r] + log(l[r])             (m the row max, l the row sum)
// with out in the operands' dtype (f32 or bf16, loaded into f32) and lse
// (BH, T) f32.
//
// What differs from the TPU kernel, and why:
// - The TPU grid walks (batch-head, q-tile, k-tile) with the k axis
//   sequential, carrying the running max, sum and output in VMEM scratch.
//   Here one block owns one (batch-head, q-tile) and walks the k-tiles in
//   a loop; the running max m and sum l live in registers (each of the 16
//   threads sharing a row holds a copy, reduced with shuffles), the
//   output accumulator in registers, K and V tiles in shared memory.
// - The TPU pads dh to 128 lanes and T to the tile, and writes the padded
//   lse lane-broadcast as (BH, T_pad, 128).  Here nothing is padded in
//   device memory: tiles load exactly dh columns (zero-filled to 64 or 128
//   in shared memory) and stop at T, and lse is (BH, T).
// - Tiles are 64 x 64 against the TPU's 256 x 256 clamped to T, so at the
//   transformer's T = 128 the online rescale runs over two k-tiles.
//
// Numerics: every product is a true-f32 FMA (tighter than the TPU's level
// 0 bf16x3, equal to its levels 1 and 2); the rescale, the differences and
// the scale are rounded on their own (no FMA contraction) and exp/log are
// expf/logf, as the plain PyTorch version computes them.
//
// What bounds it on the card: operations.  4 BH T^2 dh FLOP against
// 16 BH T dh bytes: at the transformer's (512, 128, 64), 2.15 GFLOP is a
// 0.032 ms bound at the 67 TFLOP/s f32 rate (TF32 is off) against 8.7 MB
// (0.0026 ms).  This first kernel is plain SIMT f32: 4 x 4 scores and
// 4 x 4 outputs per thread from float4 shared-memory reads, no tensor
// cores, no pipelining of the tile loads.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include "attention.cuh"

namespace {

template <int NV, typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, int t, int dh, float scale) {
  constexpr int DHP = 64 * NV;
  constexpr int LD = DHP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + B * LD;
  float* vs = ks + B * LD;
  float* ps = vs + B * LD;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * B;
  const long long base = bh * t * dh;
  load_tile<DHP>(qs, q + base, q0, t, dh);

  float m[R], l[R], acc[R][4 * NV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = MASK_FLOOR;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += B) {
    __syncthreads();  // the previous K, V and P tiles are consumed
    load_tile<DHP>(ks, k + base, k0, t, dh);
    load_tile<DHP>(vs, v + base, k0, t, dh);
    __syncthreads();
    float s[R][R];
    tile_dot<DHP>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float smax = MASK_FLOOR;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = k0 + tx + 16 * j < t ? __fmul_rn(s[i][j], scale)
                                       : MASK_FLOOR;
        smax = fmaxf(smax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(smax));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs = __fadd_rn(rs, p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), sum16(rs));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncthreads();
    tile_acc<NV>(ps, vs, ty, tx, acc);
  }

  float l_safe[R];
#pragma unroll
  for (int i = 0; i < R; ++i) l_safe[i] = l[i] == 0.f ? 1.f : l[i];
  store_rows<NV, T>(out + base, acc, l_safe, q0, t, dh, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < t) lse[bh * t + row] = __fadd_rn(m[i], logf(l_safe[i]));
    }
  }
}

template <int NV, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, long long b, int t, int dh, float scale,
                   cudaStream_t stream) {
  constexpr int LD = 64 * NV + 4;
  const int smem = (3 * B * LD + B * LDP) * static_cast<int>(sizeof(float));
  auto kernel = fwd_kernel<NV, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(b), (t + B - 1) / B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, dh, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int veles_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   long long b, long long t, long long dh,
                                   int dtype, float scale, int device,
                                   void* stream) {
  cudaError_t e = prepare(device, b, t, dh, dtype);
  if (e == cudaSuccess)
    e = ATTENTION_DISPATCH(launch, dh, dtype, q, k, v, out, lse, b,
                           static_cast<int>(t), static_cast<int>(dh), scale,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
