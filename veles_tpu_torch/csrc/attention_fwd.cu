// Flash-attention forward for Hopper (sm_90a): out and the row logsumexp.
//
// Replaces the Pallas kernel veles_tpu/ops/attention.py:145
// (_flash_fwd_jit -> _fwd_kernel).  For q, k, v of shape (BH, T, dh)
// (batch x heads folded) it computes, row by row,
//   s[r][c] = dot(q[r], k[c]) * scale      (c >= T: -1e30, never -inf)
//   out[r]  = sum_c exp(s[r][c] - m[r]) v[c] / l[r]
//   lse[r]  = m[r] + log(l[r])             (m the row max, l the row sum)
// with out in the operands' dtype (f32 or bf16) and lse (BH, T) f32.
//
// What differs from the TPU kernel, and why:
// - The TPU grid walks (batch-head, q-tile, k-tile) with the k axis
//   sequential, carrying the running max, sum and output in VMEM scratch.
//   Here a block takes one (batch-head, 64-row q tile) at a time and
//   walks the 64-row k tiles in a loop, the running max m, sum l and
//   output in registers: each k tile rescales them by alpha =
//   exp(m_prev - m_new).
// - The TPU pads dh to 128 lanes and T to the tile, and writes the padded
//   lse lane-broadcast as (BH, T_pad, 128).  Here nothing is padded in
//   device memory: a tile reads exactly T rows and dh columns (zeros past
//   them in shared memory only), and lse is (BH, T).
// - Tiles are 64 x 64 against the TPU's 256 x 256 clamped to T, so at the
//   transformer's T = 128 the online rescale runs over two k tiles where
//   the TPU takes one.
//
// Two designs, chosen per call by ops/attention.py (`path`, the
// backward's rule and codes):
//
//   TC_BF16X3 (1)  precision level 0, the TPU kernel's own arithmetic
//                  (veles_tpu/ops/common.py:91 mxu_partial_dot): both
//                  products, q k^T and p v, are hi.lo + lo.hi + hi.hi of
//                  the operands' bf16 splits on the tensor cores (wgmma
//                  m64n64k16, f32 accumulate).  It is the backward's dq
//                  kernel without do and ds (attention_tc.cuh, described
//                  at the top of attention_bwd.cu), made persistent: one
//                  warpgroup a block, as many blocks as the card holds,
//                  each walking (batch-head, q tile) items; q staged once
//                  an item and split into 128-byte swizzled bf16 planes,
//                  the k and v tiles staged by 16-byte cp.async and split
//                  once, the next tiles always in flight (the next item's
//                  q, k and v during an item's store), the scores
//                  read K-major with each k16 step added with __fadd_rn,
//                  p split in registers as wgmma's register A operand and
//                  v's planes read MN-major; each tile's p v product
//                  starts from zero and is added, rounded to nearest, to
//                  the accumulator scaled by alpha.  bf16 operands have no
//                  lo plane: q k^T is one bf16 product and p v is p_hi v +
//                  p_lo v, as in JAX.  The row max and row sum reduce over
//                  the 4 threads that share a row in wgmma's accumulator
//                  layout.
//   SIMT (0)       levels 1 and 2: true-f32 FMA products (the TPU's
//                  levels 1 and 2), 256 threads, 4 x 4 scores and 4 x 4
//                  outputs a thread from float4 shared-memory reads, K and
//                  V tiles loaded through registers; the running max and
//                  sum held by each of the 16 threads sharing a row and
//                  reduced with shuffles.
//
// In both, the scale, the rescale and the differences are rounded on
// their own (no FMA contraction) and exp/log are expf/logf, as the plain
// PyTorch version computes them.
//
// What bounds it on the card: bytes at level 0, operations at levels 1
// and 2.  It reads q, k, v and writes out and lse, 16 BH T dh + 4 BH T
// bytes: at the transformer's (512, 128, 64) f32 67 MB, 0.0201 ms at
// 3.35 TB/s.  Its two products are 4 BH T^2 dh FLOP, 2.15 GFLOP there:
// at level 0 three bf16 products each, 6.4 GFLOP, 0.0065 ms at 989
// TFLOP/s; at levels 1 and 2 true f32, 0.032 ms at 67 TFLOP/s (TF32 is
// off).
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <algorithm>
#include <atomic>

#include "attention.cuh"
#include "attention_tc.cuh"

namespace {

// the devices launch_tc keeps a grid size for
constexpr int MAX_DEVICES = 64;

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

// ---------------------------------------------------------------------
// Tensor cores, level 0: bf16x3 (see the top of the file).

// The rows' max (or sum) over the 4 threads of a quad: the threads that
// hold one accumulator row between them.
__device__ __forceinline__ float max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float sum4(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// out and lse of 64-row q tiles, one (batch-head, q tile) work item at a
// time; the block walks items blockIdx.x, + gridDim.x, ... (the grid
// holds as many blocks as fit on the card at once), and the k and v
// tiles stream past each.  Planes: q (resident for an item), then the
// streamed k and v.  Staging: k and v in 0 and 1, the next item's q in
// 2.  A block's next tiles are in flight while it works: k and v tile
// j + 1 during tile j, and the next item's q and first k and v tiles
// while this item's out is stored.
template <int NV, typename T>
__global__ void __launch_bounds__(TC_THREADS, 2)
fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int t, int dh, float scale, int vec,
              int items) {
  using M = TcLayout<NV, T, 3, 3>;
  constexpr bool SPLIT = M::SPLIT;
  extern __shared__ uint8_t tc_smem_raw[];
  const M m(tc_smem_raw);
  const uint8_t *qh = m.hi(0), *ql = m.lo(0);
  const uint8_t *kh = m.hi(1), *kl = m.lo(1);
  const uint8_t *vh = m.hi(2), *vl = m.lo(2);

  const int tid = threadIdx.x;
  const int qtiles = (t + B - 1) / B;
  const int rr = 16 * (tid / 32) + (tid % 32) / 4;   // rows rr and rr + 8
  const int c = 2 * (tid % 4);
  const long long tdh = static_cast<long long>(t) * dh;
  // the first item's q, k and v tiles
  int item = blockIdx.x;
  stage_tile<NV>(m.stage(2), q + item / qtiles * tdh, item % qtiles * B, t,
                 dh, vec);
  stage_tile<NV>(m.stage(0), k + item / qtiles * tdh, 0, t, dh, vec);
  stage_tile<NV>(m.stage(1), v + item / qtiles * tdh, 0, t, dh, vec);
  gemm::cp_async_commit();

  for (; item < items; item += gridDim.x) {
    const long long bh = item / qtiles;
    const int q0 = item % qtiles * B;
    const long long base = bh * tdh;
    const int r0 = q0 + rr;
    const int next = item + gridDim.x;
    float acc[NV][32], s[32], part[32];
    float m_run[2] = {MASK_FLOOR, MASK_FLOOR}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = part[e] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NV; ++nb) acc[nb][e] = 0.f;
    }

    for (int k0 = 0; k0 < t; k0 += B) {
      gemm::cp_async_wait<0>();
      __syncthreads();   // the tiles are staged; the last products are done
      if (k0 == 0) split_staged<NV>(m.hi(0), m.lo(0), m.stage(2));
      split_staged<NV>(m.hi(1), m.lo(1), m.stage(0));
      split_staged<NV>(m.hi(2), m.lo(2), m.stage(1));
      gemm::fence_proxy_async();   // the stores, before wgmma reads them
      __syncthreads();   // the planes are whole; the staging is free
      if (k0 + B < t) {
        stage_tile<NV>(m.stage(0), k + base, k0 + B, t, dh, vec);
        stage_tile<NV>(m.stage(1), v + base, k0 + B, t, dh, vec);
      }
      gemm::cp_async_commit();
      score_tile<NV, SPLIT>(s, part, qh, ql, kh, kl);
      // element e: row r0 + 8 h (h = (e >> 1) & 1), key k0 + 8 (e >> 2) +
      // c + (e & 1); masked keys take the floor, and their expf is 0
      float smax[2] = {MASK_FLOOR, MASK_FLOOR};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        const int col = k0 + 8 * (e >> 2) + c + (e & 1);
        s[e] = col < t ? __fmul_rn(s[e], scale) : MASK_FLOOR;
        smax[h] = fmaxf(smax[h], s[e]);
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_run[h], max4(smax[h]));
        alpha[h] = expf(__fsub_rn(m_run[h], m_new));
        m_run[h] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        s[e] = expf(__fsub_rn(s[e], m_run[h]));
        rs[h] = __fadd_rn(rs[h], s[e]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l_run[h] = __fadd_rn(__fmul_rn(l_run[h], alpha[h]), sum4(rs[h]));
      uint32_t p_hi[4][4], p_lo[4][4];
      split_fragments(s, p_hi, p_lo);
      // acc = acc * alpha + p v, the tile's product from zero
#pragma unroll
      for (int nb = 0; nb < NV; ++nb) {
        gemm::wgmma_fence();
        issue_output<SPLIT>(part, p_hi, p_lo, vh, vl, nb);
        gemm::wgmma_commit();
        gemm::wgmma_wait<0>();
        gemm::fence_operands<32>(part);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[nb][e] = __fadd_rn(__fmul_rn(acc[nb][e], alpha[(e >> 1) & 1]),
                                 part[e]);
      }
    }

    // the next item's q, k and v tiles load while this one's out is
    // stored; issued in the loop's last tile instead, they took a
    // single-wave call, (8, 1024, 64) on an H100, from 0.051 to 0.057 ms
    if (next < items) {
      const long long nbase = next / qtiles * tdh;
      stage_tile<NV>(m.stage(2), q + nbase, next % qtiles * B, t, dh, vec);
      stage_tile<NV>(m.stage(0), k + nbase, 0, t, dh, vec);
      stage_tile<NV>(m.stage(1), v + nbase, 0, t, dh, vec);
    }
    gemm::cp_async_commit();
    float l_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) l_safe[h] = l_run[h] == 0.f ? 1.f : l_run[h];
#pragma unroll
    for (int nb = 0; nb < NV; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        acc[nb][e] = __fdiv_rn(acc[nb][e], l_safe[(e >> 1) & 1]);
    store_staged<NV>(out + base, acc, reinterpret_cast<float*>(m.hi(1)), q0,
                     t, dh, vec);
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < t)
          lse[bh * t + row] = __fadd_rn(m_run[h], logf(l_safe[h]));
      }
    }
  }
}

template <int NV, typename T>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      void* out, void* lse, long long b, int t, int dh,
                      float scale, int grid_blocks, int device,
                      cudaStream_t stream) {
  using M = TcLayout<NV, T, 3, 3>;
  auto kernel = fwd_tc_kernel<NV, T>;
  // as many blocks as the card holds at once, each walking its items:
  // worked out once a device, with the shared-memory attribute, so that a
  // launch makes no other host API call
  static std::atomic<int> resident[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int blocks = resident[device].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, M::SMEM);
    if (e != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, TC_THREADS, M::SMEM)) != cudaSuccess)
      return e;
    blocks = std::max(per_sm, 1) * sms;
    resident[device].store(blocks, std::memory_order_relaxed);
  }
  const long long items = b * ((t + B - 1) / B);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  // a tuned schedule's block count (veles_tpu_torch.tune), else the
  // resident count; an item is computed by one block either way
  const long long grid =
      std::min<long long>(items, grid_blocks > 0 ? grid_blocks : blocks);
  kernel<<<static_cast<unsigned>(grid), TC_THREADS, M::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, dh, scale,
      vector_loads<T>(dh, q, k, v, out), static_cast<int>(items));
  return cudaGetLastError();
}

}  // namespace

// grid: the persistent blocks of the TC_BF16X3 design (0: as many as
// the card holds at once); the SIMT design takes one block an item and
// only 0
extern "C" int veles_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int grid, long long b, long long t,
                                   long long dh, int dtype, float scale,
                                   int path, int device, void* stream) {
  cudaError_t e = prepare(device, b, t, dh, dtype);
  if (e == cudaSuccess &&
      ((path != SIMT && path != TC_BF16X3) || grid < 0 ||
       (path == SIMT && grid != 0)))
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ti = static_cast<int>(t), di = static_cast<int>(dh);
  if (path == TC_BF16X3)
    e = ATTENTION_DISPATCH(launch_tc, dh, dtype, q, k, v, out, lse, b, ti,
                           di, scale, grid, device, s);
  else
    e = ATTENTION_DISPATCH(launch, dh, dtype, q, k, v, out, lse, b, ti, di,
                           scale, s);
  return static_cast<int>(e);
}
