// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv.
//
// Replaces the Pallas kernels veles_tpu/ops/attention.py:257
// (_flash_bwd_jit -> _bwd_dq_kernel) and :279 (-> _bwd_dkv_kernel).  From
// q, k, v, the output cotangent do (all (BH, T, dh), f32 or bf16), the
// forward's lse and delta = rowsum(do * out) (both (BH, T) f32) it
// recomputes the probabilities instead of storing them:
//   p[r][c]  = exp(dot(q[r], k[c]) * scale - lse[r])  (c >= T: the -1e30
//              floor, so p is an exact 0; rows r >= T of a tile: 0)
//   dp[r][c] = dot(do[r], v[c])
//   ds[r][c] = p[r][c] * (dp[r][c] - delta[r]) * scale
//   dq = ds k,   dk = ds^T q,   dv = p^T do
//
// What differs from the TPU kernels, and why:
// - The TPU grids walk their reduction axis sequentially and carry the
//   sums in VMEM.  Here a dq block owns one (batch-head, 64-row q tile)
//   and loops over the k tiles; a dk/dv block owns one (batch-head,
//   64-row k tile) and loops over the q tiles.  Each output element is
//   summed by one block in a fixed order, with no atomics, so both
//   kernels give the same bits on every run.
// - The dk/dv block computes the transposed score tile (k rows by q
//   columns) directly, so p^T and ds^T come out in the rows the dk and dv
//   products need.
// - Nothing is padded in device memory (the TPU pads dh to 128 lanes and T
//   to its tiles); lse and delta are (BH, T), not lane-broadcast.  A tile
//   reads T rows and dh columns and no more; the rest is zero in shared
//   memory only.
//
// Two designs, chosen per call by ops/attention.py (`path`):
//
//   TC_BF16X3 (1)  precision level 0, the TPU kernels' own arithmetic
//                  (veles_tpu/ops/common.py:91 mxu_partial_dot) and what
//                  the transformer's train step runs.  Every operand is
//                  split once into hi = bf16_rn(x) and lo = bf16_rn(x -
//                  hi), and every product is hi.lo + lo.hi + hi.hi on the
//                  tensor cores (wgmma m64n64k16, f32 accumulate).  q, k,
//                  v and do tiles are staged raw by 16-byte cp.async (the
//                  next tile's copies in flight while the current tile's
//                  products run) and split into 128-byte swizzled bf16
//                  planes in shared memory (dh contiguous); the score
//                  products read them K-major, and the output products
//                  read the same planes MN-major.  p and ds are split in
//                  registers: the score accumulator's layout is wgmma's
//                  register A operand, so they feed dq = ds k, dv = p^T
//                  do and dk = ds^T q with no trip through shared memory.
//                  bf16 operands have no lo plane, and the products with
//                  it are skipped (a bf16 q k^T is one product, as in
//                  JAX).  The tensor cores' own accumulation does not
//                  round to nearest, and the bf16 split of p and ds turns
//                  a last-bit difference of a score into a step of 2^-17:
//                  so the score products keep their cross terms in a
//                  chain of their own and sum each k16 step's hi.hi
//                  product from zero with TwoSum (score_tile's
//                  COMPENSATED sum, attention_tc.cuh), and each tile's
//                  output product starts from zero and is added to its
//                  f32 sum with __fadd_rn.  One warpgroup a block, 64
//                  rows (two warpgroups sharing each streamed tile
//                  measured the same).
//   SIMT (0)       levels 1 and 2: true-f32 FMA products, 256 threads,
//                  4 x 4 score elements a thread, float4 shared-memory
//                  reads, no tensor cores; the scale, the difference
//                  dp - delta and the products of ds rounded on their own,
//                  expf, not the fast intrinsic (both designs).
//
// What bounds them on the card: bytes.  dq reads q, k, v, do, lse and
// delta and writes dq, dk/dv writes dk and dv: at the transformer's
// (512, 128, 64) f32 84 MB and 101 MB, 0.0252 and 0.0302 ms at 3.35 TB/s.
// dq does three products of 2 BH T^2 dh FLOP, dk/dv four: at level 0
// three bf16 products each, 9.66 and 12.9 GFLOP, 0.0098 and 0.0130 ms at
// 989 TFLOP/s; at levels 1 and 2 true f32, 0.048 and 0.064 ms at 67
// TFLOP/s, which then bound them.  The tensor-core design keeps
// 196-255 registers a thread (dh <= 64; the f32 dk/dv build spills 96
// bytes), so two 4-warp blocks share an SM, and its time goes mostly to
// the elementwise work around the products (p, ds, their splits, expf
// and the compensated score sums) rather than to the bytes or the
// products: a branch around expf, or tiles loaded through registers
// instead of cp.async, each cost it 12-14 %; the compensated sums cost
// dq 26 % and dk/dv 20 % (an H100, (512, 128, 64) f32).
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include "attention.cuh"
#include "attention_tc.cuh"

namespace {

// p and ds for score tile element (i, j) of a thread: `row` the query,
// `col` the key, s the raw dot, dp the do.v dot.
__device__ __forceinline__ void prob_ds(float s, float dp, int row, int col,
                                        int t, float lse_r, float delta_r,
                                        float scale, float& p, float& ds) {
  p = 0.f;
  if (row < t) {
    const float sv = col < t ? __fmul_rn(s, scale) : MASK_FLOOR;
    p = expf(__fsub_rn(sv, lse_r));
  }
  ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta_r)), scale);
}

template <int NV, typename T>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int t, int dh, float scale) {
  constexpr int DHP = 64 * NV;
  constexpr int LD = DHP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + B * LD;
  float* ks = dos + B * LD;
  float* vs = ks + B * LD;
  float* dss = vs + B * LD;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * B;
  const long long base = bh * t * dh;
  load_tile<DHP>(qs, q + base, q0, t, dh);
  load_tile<DHP>(dos, dout + base, q0, t, dh);
  float lse_r[R], delta_r[R], one[R], acc[R][4 * NV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < t ? lse[bh * t + row] : 0.f;
    delta_r[i] = row < t ? delta[bh * t + row] : 0.f;
    one[i] = 1.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += B) {
    __syncthreads();  // the previous K and ds tiles are consumed
    load_tile<DHP>(ks, k + base, k0, t, dh);
    load_tile<DHP>(vs, v + base, k0, t, dh);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<DHP>(qs, ks, ty, tx, s);
    tile_dot<DHP>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float p, ds;
        prob_ds(s[i][j], dp[i][j], q0 + ty + 16 * i, k0 + tx + 16 * j,
                t, lse_r[i], delta_r[i], scale, p, ds);
        dss[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    __syncthreads();
    tile_acc<NV>(dss, ks, ty, tx, acc);
  }
  store_rows<NV, T>(dq + base, acc, one, q0, t, dh, ty, tx);
}

template <int NV, typename T>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int t, int dh,
           float scale) {
  constexpr int DHP = 64 * NV;
  constexpr int LD = DHP + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + B * LD;
  float* qs = vs + B * LD;
  float* dos = qs + B * LD;
  float* pts = dos + B * LD;
  float* dsts = pts + B * LDP;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * B;
  const long long base = bh * t * dh;
  load_tile<DHP>(ks, k + base, k0, t, dh);
  load_tile<DHP>(vs, v + base, k0, t, dh);
  float one[R], dk_acc[R][4 * NV], dv_acc[R][4 * NV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    one[i] = 1.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < t; q0 += B) {
    __syncthreads();  // the previous Q, dO, p^T and ds^T tiles are consumed
    load_tile<DHP>(qs, q + base, q0, t, dh);
    load_tile<DHP>(dos, dout + base, q0, t, dh);
    float lse_c[R], delta_c[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = q0 + tx + 16 * j;
      lse_c[j] = row < t ? lse[bh * t + row] : 0.f;
      delta_c[j] = row < t ? delta[bh * t + row] : 0.f;
    }
    __syncthreads();
    // transposed tiles: element (i, j) is key k0 + ty + 16 i, query
    // q0 + tx + 16 j
    float st[R][R], dpt[R][R];
    tile_dot<DHP>(ks, qs, ty, tx, st);
    tile_dot<DHP>(vs, dos, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float p, ds;
        prob_ds(st[i][j], dpt[i][j], q0 + tx + 16 * j, k0 + ty + 16 * i,
                t, lse_c[j], delta_c[j], scale, p, ds);
        pts[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        dsts[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    __syncthreads();
    tile_acc<NV>(pts, dos, ty, tx, dv_acc);
    tile_acc<NV>(dsts, qs, ty, tx, dk_acc);
  }
  store_rows<NV, T>(dk + base, dk_acc, one, k0, t, dh, ty, tx);
  store_rows<NV, T>(dv + base, dv_acc, one, k0, t, dh, ty, tx);
}

template <int NV, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, long long b, int t, int dh, float scale,
                      cudaStream_t stream) {
  constexpr int LD = 64 * NV + 4;
  const int smem = (4 * B * LD + B * LDP) * static_cast<int>(sizeof(float));
  auto kernel = dq_kernel<NV, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(b), (t + B - 1) / B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, dh, scale);
  return cudaGetLastError();
}

template <int NV, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, long long b, int t, int dh,
                       float scale, cudaStream_t stream) {
  constexpr int LD = 64 * NV + 4;
  const int smem =
      (4 * B * LD + 2 * B * LDP) * static_cast<int>(sizeof(float));
  auto kernel = dkv_kernel<NV, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(b), (t + B - 1) / B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, dh, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Tensor cores, level 0: bf16x3 (see the top of the file; the pieces
// shared with the forward are in attention_tc.cuh).

__device__ __forceinline__ void fold(float* acc, const float* part) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
}

// The block's prologue: stages the resident tiles of a and b (rows
// row0..), splits them into planes 0 and 1, then stages the first
// streamed pair (rows 0.. of c and d).
template <int NV, typename T>
__device__ __forceinline__ void prologue(const TcLayout<NV, T>& m,
                                         const T* a, const T* b,
                                         const T* c, const T* d, int row0,
                                         int t, int dh, bool vec) {
  stage_tile<NV>(m.stage(0), a, row0, t, dh, vec);
  stage_tile<NV>(m.stage(1), b, row0, t, dh, vec);
  gemm::cp_async_commit();
  gemm::cp_async_wait<0>();
  __syncthreads();
  split_staged<NV>(m.hi(0), m.lo(0), m.stage(0));
  split_staged<NV>(m.hi(1), m.lo(1), m.stage(1));
  __syncthreads();   // the staging is free
  stage_tile<NV>(m.stage(0), c, 0, t, dh, vec);
  stage_tile<NV>(m.stage(1), d, 0, t, dh, vec);
  gemm::cp_async_commit();
}

// rows row0..row0 + 63 of a (t, dh) matrix <- the warpgroup's NV
// accumulators: thread (w, g, c) holds element 4 j + e of column block
// nb at row 16 w + g + 8 (e / 2), column 64 nb + 8 j + 2 c + e % 2 of
// the tile.
template <int NV, typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const float (&acc)[NV][32],
                                           int row0, int t, int dh) {
  const int tid = threadIdx.x;
  const int r = row0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int c = 2 * (tid % 4);
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e / 2);
        const int col = 64 * nb + 8 * j + c + (e & 1);
        if (row < t && col < dh)
          dst[static_cast<long long>(row) * dh + col] =
              from_f32<T>(acc[nb][4 * j + e]);
      }
}

// The streamed pair at rows row0.. (staged) -> planes 2 and 3, and the
// pair at row0 + 64 staged in its place.
template <int NV, typename T>
__device__ __forceinline__ void next_pair(const TcLayout<NV, T>& m,
                                          const T* c, const T* d, int row0,
                                          int t, int dh, bool vec) {
  split_staged<NV>(m.hi(2), m.lo(2), m.stage(0));
  split_staged<NV>(m.hi(3), m.lo(3), m.stage(1));
  gemm::fence_proxy_async();   // the stores, before wgmma reads them
  __syncthreads();   // the planes are whole; the staging is free
  if (row0 + B < t) {
    stage_tile<NV>(m.stage(0), c, row0 + B, t, dh, vec);
    stage_tile<NV>(m.stage(1), d, row0 + B, t, dh, vec);
  }
  gemm::cp_async_commit();
}

// dq for one 64-row q tile; the k and v tiles stream past it.
template <int NV, typename T>
__global__ void __launch_bounds__(TC_THREADS, 2)
dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int t, int dh, float scale, int vec) {
  using M = TcLayout<NV, T>;
  constexpr bool SPLIT = M::SPLIT;
  extern __shared__ uint8_t tc_smem_raw[];
  const M m(tc_smem_raw);
  const uint8_t *qh = m.hi(0), *ql = m.lo(0);
  const uint8_t *doh = m.hi(1), *dol = m.lo(1);
  const uint8_t *kh = m.hi(2), *kl = m.lo(2);
  const uint8_t *vh = m.hi(3), *vl = m.lo(3);

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * B;
  const long long base = bh * t * dh;
  const int r0 = q0 + 16 * (tid / 32) + (tid % 32) / 4;   // and r0 + 8
  const int c = 2 * (tid % 4);
  prologue<NV>(m, q + base, dout + base, k + base, v + base, q0, t, dh,
               vec);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse_r[h] = row < t ? lse[bh * t + row] : 0.f;
    delta_r[h] = row < t ? delta[bh * t + row] : 0.f;
  }
  float acc[NV][32], s[32], dp[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = dp[e] = part[e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) acc[nb][e] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += B) {
    gemm::cp_async_wait<0>();
    __syncthreads();   // the pair is staged; the previous products are done
    next_pair<NV>(m, k + base, v + base, k0, t, dh, vec);
    score_tile<NV, SPLIT, true>(s, part, qh, ql, kh, kl);
    score_tile<NV, SPLIT, true>(dp, part, doh, dol, vh, vl);
    // p and ds; the masks are selects around an expf taken everywhere
    // (rows past t read lse 0 and zero operands, so their expf is finite
    // and then dropped): a branch around expf cost 14 % of the kernel
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      const int col = k0 + 8 * (e >> 2) + c + (e & 1);
      const float sv = col < t ? __fmul_rn(s[e], scale) : MASK_FLOOR;
      const float ex = expf(__fsub_rn(sv, lse_r[h]));
      const float p = r0 + 8 * h < t ? ex : 0.f;
      dp[e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[e], delta_r[h])), scale);
    }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    split_fragments(dp, ds_hi, ds_lo);
    // dq += ds k
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) {
      gemm::wgmma_fence();
      issue_output<SPLIT>(part, ds_hi, ds_lo, kh, kl, nb);
      gemm::wgmma_commit();
      gemm::wgmma_wait<0>();
      gemm::fence_operands<32>(part);
      fold(acc[nb], part);
    }
  }
  store_tile<NV>(dq + base, acc, q0, t, dh);
}

// dk and dv for one 64-row k tile; the q and do tiles (with their lse
// and delta) stream past it.
template <int NV, typename T>
__global__ void __launch_bounds__(TC_THREADS, 2)
dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, int t, int dh, float scale, int vec) {
  using M = TcLayout<NV, T>;
  constexpr bool SPLIT = M::SPLIT;
  extern __shared__ uint8_t tc_smem_raw[];
  const M m(tc_smem_raw);
  const uint8_t *kh = m.hi(0), *kl = m.lo(0);
  const uint8_t *vh = m.hi(1), *vl = m.lo(1);
  const uint8_t *qh = m.hi(2), *ql = m.lo(2);
  const uint8_t *doh = m.hi(3), *dol = m.lo(3);
  float* lse_s = m.rows();
  float* delta_s = lse_s + B;

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * B;
  const long long base = bh * t * dh;
  const int r0 = k0 + 16 * (tid / 32) + (tid % 32) / 4;   // and r0 + 8
  const int c = 2 * (tid % 4);
  prologue<NV>(m, k + base, v + base, q + base, dout + base, k0, t, dh,
               vec);
  // part and pd: the dv and dk products of a tile, issued together
  float dk_acc[NV][32], dv_acc[NV][32], st[32], dpt[32], part[32],
      pd[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    st[e] = dpt[e] = part[e] = pd[e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;
  }

  for (int q0 = 0; q0 < t; q0 += B) {
    gemm::cp_async_wait<0>();
    __syncthreads();   // the pair is staged; the previous products are done
    if (tid < B) {
      const int row = q0 + tid;
      lse_s[tid] = row < t ? lse[bh * t + row] : 0.f;
      delta_s[tid] = row < t ? delta[bh * t + row] : 0.f;
    }
    next_pair<NV>(m, q + base, dout + base, q0, t, dh, vec);
    // transposed tiles: element e is key r0 + 8 ((e >> 1) & 1), query
    // q0 + 8 (e >> 2) + c + (e & 1)
    score_tile<NV, SPLIT, true>(st, part, kh, kl, qh, ql);
    score_tile<NV, SPLIT, true>(dpt, part, vh, vl, doh, dol);
    // p, the masks as selects around an expf taken everywhere (see dq)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = r0 + 8 * ((e >> 1) & 1);
      const int col = 8 * (e >> 2) + c + (e & 1);
      const float sv = key < t ? __fmul_rn(st[e], scale) : MASK_FLOOR;
      const float p = expf(__fsub_rn(sv, lse_s[col]));
      st[e] = q0 + col < t ? p : 0.f;
    }
    uint32_t p_hi[4][4], p_lo[4][4];
    split_fragments(st, p_hi, p_lo);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e >> 2) + c + (e & 1);
      dpt[e] = __fmul_rn(__fmul_rn(st[e], __fsub_rn(dpt[e], delta_s[col])),
                         scale);
    }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    split_fragments(dpt, ds_hi, ds_lo);
    // dv += p^T do and dk += ds^T q, issued together
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) {
      gemm::wgmma_fence();
      issue_output<SPLIT>(part, p_hi, p_lo, doh, dol, nb);
      issue_output<SPLIT>(pd, ds_hi, ds_lo, qh, ql, nb);
      gemm::wgmma_commit();
      gemm::wgmma_wait<0>();
      gemm::fence_operands<32>(part);
      gemm::fence_operands<32>(pd);
      fold(dv_acc[nb], part);
      fold(dk_acc[nb], pd);
    }
  }
  store_tile<NV>(dk + base, dk_acc, k0, t, dh);
  store_tile<NV>(dv + base, dv_acc, k0, t, dh);
}

template <int NV, typename T>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, long long b, int t,
                         int dh, float scale, cudaStream_t stream) {
  using M = TcLayout<NV, T>;
  auto kernel = dq_tc_kernel<NV, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, M::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(b), (t + B - 1) / B);
  kernel<<<grid, TC_THREADS, M::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, dh, scale,
      vector_loads<T>(dh, q, k, v, dout));
  return cudaGetLastError();
}

template <int NV, typename T>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          long long b, int t, int dh, float scale,
                          cudaStream_t stream) {
  using M = TcLayout<NV, T>;
  auto kernel = dkv_tc_kernel<NV, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, M::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(b), (t + B - 1) / B);
  kernel<<<grid, TC_THREADS, M::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, dh, scale,
      vector_loads<T>(dh, q, k, v, dout));
  return cudaGetLastError();
}

}  // namespace

extern "C" int veles_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, long long b, long long t,
                                  long long dh, int dtype, float scale,
                                  int path, int device, void* stream) {
  cudaError_t e = prepare(device, b, t, dh, dtype);
  if (e == cudaSuccess && path != SIMT && path != TC_BF16X3)
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ti = static_cast<int>(t), di = static_cast<int>(dh);
  if (path == TC_BF16X3)
    e = ATTENTION_DISPATCH(launch_dq_tc, dh, dtype, q, k, v, dout, lse,
                           delta, dq, b, ti, di, scale, s);
  else
    e = ATTENTION_DISPATCH(launch_dq, dh, dtype, q, k, v, dout, lse, delta,
                           dq, b, ti, di, scale, s);
  return static_cast<int>(e);
}

extern "C" int veles_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, long long b,
                                   long long t, long long dh, int dtype,
                                   float scale, int path, int device,
                                   void* stream) {
  cudaError_t e = prepare(device, b, t, dh, dtype);
  if (e == cudaSuccess && path != SIMT && path != TC_BF16X3)
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ti = static_cast<int>(t), di = static_cast<int>(dh);
  if (path == TC_BF16X3)
    e = ATTENTION_DISPATCH(launch_dkv_tc, dh, dtype, q, k, v, dout, lse,
                           delta, dk, dv, b, ti, di, scale, s);
  else
    e = ATTENTION_DISPATCH(launch_dkv, dh, dtype, q, k, v, dout, lse,
                           delta, dk, dv, b, ti, di, scale, s);
  return static_cast<int>(e);
}
