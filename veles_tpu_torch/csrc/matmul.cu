// Tiled matrix product with precision levels 0/1/2, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/matmul.py:228 (matmul ->
// _matmul_kernel, product step veles_tpu/ops/common.py:91
// mxu_partial_dot).  It computes what that kernel computes, not its
// blocks: out = A @ B with A (M, K) and B (K, N), each element an f32
// accumulator over K-tiles of `bk` columns (the JAX kernel's
// min(bk, ceil_mult(K, 128))), where each K-tile's partial product is
// folded into the accumulator by the level's rule:
//
//   level 0: acc += partial
//   level 1: Kahan:    y = partial - c; t = acc + y; c = (t - acc) - y;
//                      acc = t
//   level 2: Neumaier: t = acc + partial; c += |acc| >= |partial| ?
//                      (acc - t) + partial : (partial - t) + acc;
//                      acc = t; the store writes acc + c
//
// The fold is written with __fadd_rn / __fsub_rn, which no compiler
// flag contracts or reassociates.  The partial products:
//
//   f32 operands, level 0: bf16x3.  Each operand splits into hi =
//     bf16_rn(x) and lo = bf16_rn(x - hi); the partial is hi.hi + hi.lo
//     + lo.hi, three bf16 tensor-core products (f32 accumulation) into
//     one f32 partial.  A product of two bf16 values is exact in f32.
//     |x| >= the bf16 maximum splits into inf and -inf and gives
//     non-finite output, as the JAX decomposition does.
//   bf16 operands, any level: one bf16 tensor-core pass.
//   f32 operands, levels 1 and 2: true f32 products (fmaf), SIMT.
//
// Four designs, chosen per call by the planner in ops/matmul.py (its
// rule is written there) and named by `path`:
//
//   SPLIT_K (1)   tall, thin products (one side <= 64: VGG16 fc1 through
//                 gemm), memory-bound: 32 x 128 tiles, K split across
//                 blocks in whole K-tiles, a cp.async ring, mma.sync;
//                 f32 split into hi and lo in registers.
//   TMA_WGMMA (2) large products of bf16 operands or f32 at level 0:
//                 K-major bf16 planes of a 16-byte pitch, TMA into an
//                 mbarrier ring, wgmma m64n128k16 in two consumer
//                 warpgroups, one producer thread.
//   SIMT (3)      f32 at levels 1 and 2: 128 x 128 tiles, 8 x 8 outputs
//                 a thread, a cp.async ring, conflict-free float4 reads.
//   GENERAL (0)   what the others do not take (K below one 64-deep step,
//                 a K-tile that is not a multiple of 64): operands read
//                 through any strides and staged through registers.
//
// When a product has too few output tiles for the card, paths 1-3 split
// K across blocks: each split covers whole K-tiles, folds them as above
// and writes its (acc, comp) to an f32 workspace; a second launch folds
// the splits in split order by the same level's rule.  No float atomics
// anywhere: the same inputs give the same bits.
//
// What bounds it on the card: at 3001^3 the operations (level 0: three
// bf16 products at 989 TFLOP/s, 0.164 ms; levels 1 and 2: f32 at 67
// TFLOP/s, 0.807 ms); at VGG16 fc1 through gemm, (32, 25088) @ (25088,
// 4096), the 411 MB weight (0.124 ms).
//
// C interface: launches on the caller's stream, allocates nothing (the
// wrapper passes the workspace and the planes), and returns
// cudaGetLastError() as int.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

// dtype and path codes shared with veles_tpu_torch/ops/matmul.py
enum Code { F32 = 0, BF16 = 1, F16 = 2 };
enum Path { GENERAL = 0, SPLIT_K = 1, TMA_WGMMA = 2, SIMT = 3 };

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int TC_BK = 32;           // K columns a tensor-core step stages
constexpr int TC_THREADS = 128;     // 4 warps, 2 x 2, a 32 x 32 tile each
constexpr int SROW = TC_BK + 8;     // bf16 a shared row (80 bytes)
constexpr int SIMT_BK = 16;
constexpr int SIMT_THREADS = 128;   // 8 x 16 threads, 8 x 4 outputs each
constexpr int SPAD = BM + 4;        // f32 a shared row

struct Operands {
  const void* a;
  const void* b;
  void* out;
  long long m, n, k;
  long long sam, sak;   // A (m, k) element strides
  long long sbk, sbn;   // B (k, n) element strides
  int bk;               // K-tile of the level's fold
};

// The walk over K: steps [k0, k1) of at most STEP columns that never
// straddle a K-tile [tile_start, tile_stop) of `bk` columns.
struct Walk {
  long long k0, k1, tile_stop;

  __device__ __forceinline__ void start(int step, int bk, long long k) {
    k0 = 0;
    tile_stop = min(static_cast<long long>(bk), k);
    k1 = min(static_cast<long long>(step), tile_stop);
  }
  __device__ __forceinline__ void next(int step, int bk, long long k) {
    if (k1 == tile_stop) tile_stop = min(tile_stop + bk, k);
    k0 = k1;
    k1 = min(k0 + step, tile_stop);
  }
};

template <int LEVEL>
__device__ __forceinline__ void fold(float& acc, float& comp,
                                     float& part) {
  if constexpr (LEVEL == 0) {
    acc = __fadd_rn(acc, part);
  } else if constexpr (LEVEL == 1) {
    const float y = __fsub_rn(part, comp);
    const float t = __fadd_rn(acc, y);
    comp = __fsub_rn(__fsub_rn(t, acc), y);
    acc = t;
  } else {
    const float t = __fadd_rn(acc, part);
    const float c = fabsf(acc) >= fabsf(part)
                        ? __fadd_rn(__fsub_rn(acc, t), part)
                        : __fadd_rn(__fsub_rn(part, t), acc);
    comp = __fadd_rn(comp, c);
    acc = t;
  }
  part = 0.f;
}

template <int LEVEL>
__device__ __forceinline__ float total(float acc, float comp) {
  if constexpr (LEVEL == 2) return __fadd_rn(acc, comp);
  return acc;
}

template <typename Out>
__device__ __forceinline__ Out from_f32(float v) {
  if constexpr (std::is_same<Out, __nv_bfloat16>::value)
    return __float2bfloat16_rn(v);
  else if constexpr (std::is_same<Out, __half>::value)
    return __float2half_rn(v);
  else
    return v;
}

template <typename T>
__device__ __forceinline__ T zero() {
  if constexpr (std::is_same<T, float>::value)
    return 0.f;
  else
    return __float2bfloat16_rn(0.f);
}

// One thread's share of an (R rows) x (C columns of K) operand tile:
// elements e = 0 .. R*C/THREADS-1 at tile coordinates (r0 + e*dr,
// c0 + e*dc), laid out so that consecutive threads read consecutive
// addresses (along K when K is the unit stride, along the rows
// otherwise).  In memory element e lies at p + e * step from the
// thread's first, so a load is one pointer and one stride.
struct Share {
  int r0, c0, dr, dc;
  long long step;    // elements between the thread's e and e + 1
  long long first;   // offset of (r0, c0) from the tile's corner

  template <int R, int C, int THREADS>
  __device__ __forceinline__ void init(long long s_row, long long s_k) {
    const int t = threadIdx.x;
    if (s_k == 1) {
      r0 = t / C; c0 = t % C; dr = THREADS / C; dc = 0;
    } else {
      r0 = t % R; c0 = t / R; dr = 0; dc = THREADS / R;
    }
    step = dr * s_row + dc * s_k;
    first = r0 * s_row + c0 * s_k;
  }
};

// Registers <- the tile whose corner is (row0, k0); elements off the
// rows or at k >= k1 read as zero.
template <int E, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ p,
                                          const Share& sh, long long row0,
                                          long long rows, long long s_row,
                                          long long s_k, long long k0,
                                          long long k1, T* regs) {
  const T* q = p + row0 * s_row + k0 * s_k + sh.first;
  const long long rlim = rows - row0 - sh.r0;
  const long long klim = k1 - k0 - sh.c0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool in = e * sh.dr < rlim && e * sh.dc < klim;
    regs[e] = in ? q[e * sh.step] : zero<T>();
  }
}

// ---------------------------------------------------------------------
// The general path: operands read through any strides, staged through
// registers.  Tensor-core kernel: bf16x3 for f32 operands at level 0,
// one bf16 pass for bf16 operands at any level.

using gemm::mma_bf16;

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage one operand's registers into shared memory as [row][k] bf16,
// splitting f32 values into hi and lo.
template <int E, typename T>
__device__ __forceinline__ void stage(const T* regs, const Share& sh,
                                      __nv_bfloat16* hi,
                                      __nv_bfloat16* lo) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int at = (sh.r0 + e * sh.dr) * SROW + sh.c0 + e * sh.dc;
    if constexpr (std::is_same<T, float>::value) {
      const __nv_bfloat16 h = __float2bfloat16_rn(regs[e]);
      hi[at] = h;
      lo[at] = __float2bfloat16_rn(__fsub_rn(regs[e], __bfloat162float(h)));
    } else {
      hi[at] = regs[e];
    }
  }
}

template <typename T, int LEVEL, typename Out>
__global__ void __launch_bounds__(TC_THREADS)
tc_kernel(Operands o) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int EA = BM * TC_BK / TC_THREADS;
  constexpr int EB = BN * TC_BK / TC_THREADS;
  __shared__ __align__(16) __nv_bfloat16 a_hi[BM * SROW];
  __shared__ __align__(16) __nv_bfloat16 b_hi[BN * SROW];
  __shared__ __align__(16) __nv_bfloat16 a_lo[SPLIT ? BM * SROW : 2];
  __shared__ __align__(16) __nv_bfloat16 b_lo[SPLIT ? BN * SROW : 2];

  const T* A = static_cast<const T*>(o.a);
  const T* B = static_cast<const T*>(o.b);
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane / 4, t = lane % 4;
  Share sa, sb;
  sa.init<BM, TC_BK, TC_THREADS>(o.sam, o.sak);
  sb.init<BN, TC_BK, TC_THREADS>(o.sbn, o.sbk);

  float part[2][4][4], acc[2][4][4], comp[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[i][j][e] = acc[i][j][e] = comp[i][j][e] = 0.f;

  T ra[EA], rb[EB];
  Walk w;
  w.start(TC_BK, o.bk, o.k);
  load_tile<EA>(A, sa, m0, o.m, o.sam, o.sak, w.k0, w.k1, ra);
  load_tile<EB>(B, sb, n0, o.n, o.sbn, o.sbk, w.k0, w.k1, rb);
  for (;;) {
    __syncthreads();
    stage<EA>(ra, sa, a_hi, a_lo);
    stage<EB>(rb, sb, b_hi, b_lo);
    __syncthreads();
    const bool tile_end = w.k1 == w.tile_stop;
    const bool last = w.k1 == o.k;
    if (!last) {   // the next step's loads fly while this one computes
      w.next(TC_BK, o.bk, o.k);
      load_tile<EA>(A, sa, m0, o.m, o.sam, o.sak, w.k0, w.k1, ra);
      load_tile<EB>(B, sb, n0, o.n, o.sbn, o.sbk, w.k0, w.k1, rb);
    }
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (wm + i * 16 + g) * SROW + kk + 2 * t;
        ah[i][0] = pair(a_hi + r);
        ah[i][1] = pair(a_hi + r + 8 * SROW);
        ah[i][2] = pair(a_hi + r + 8);
        ah[i][3] = pair(a_hi + r + 8 * SROW + 8);
        if constexpr (SPLIT) {
          al[i][0] = pair(a_lo + r);
          al[i][1] = pair(a_lo + r + 8 * SROW);
          al[i][2] = pair(a_lo + r + 8);
          al[i][3] = pair(a_lo + r + 8 * SROW + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = (wn + j * 8 + g) * SROW + kk + 2 * t;
        const uint32_t bh[2] = {pair(b_hi + r), pair(b_hi + r + 8)};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(part[i][j], ah[i], bh);
        if constexpr (SPLIT) {
          const uint32_t bl[2] = {pair(b_lo + r), pair(b_lo + r + 8)};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(part[i][j], ah[i], bl);
            mma_bf16(part[i][j], al[i], bh);
          }
        }
      }
    }
    if (tile_end) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fold<LEVEL>(acc[i][j][e], comp[i][j][e], part[i][j][e]);
    }
    if (last) break;
  }

  Out* out = static_cast<Out*>(o.out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + wm + i * 16 + g + (e / 2) * 8;
        const long long col = n0 + wn + j * 8 + 2 * t + (e % 2);
        if (row < o.m && col < o.n)
          out[row * o.n + col] =
              from_f32<Out>(total<LEVEL>(acc[i][j][e], comp[i][j][e]));
      }
}

// ---------------------------------------------------------------------
// General-path SIMT kernel: true f32 products for f32 operands at
// levels 1 and 2.

template <int E>
__device__ __forceinline__ void stage_f32(const float* regs, const Share& sh,
                                          float* dst) {
#pragma unroll
  for (int e = 0; e < E; ++e)
    dst[(sh.c0 + e * sh.dc) * SPAD + sh.r0 + e * sh.dr] = regs[e];
}

template <int LEVEL, typename Out>
__global__ void __launch_bounds__(SIMT_THREADS)
simt_kernel(Operands o) {
  constexpr int EA = BM * SIMT_BK / SIMT_THREADS;
  constexpr int EB = BN * SIMT_BK / SIMT_THREADS;
  __shared__ __align__(16) float sa[SIMT_BK * SPAD];
  __shared__ __align__(16) float sb[SIMT_BK * SPAD];

  const float* A = static_cast<const float*>(o.a);
  const float* B = static_cast<const float*>(o.b);
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  Share sha, shb;
  sha.init<BM, SIMT_BK, SIMT_THREADS>(o.sam, o.sak);
  shb.init<BN, SIMT_BK, SIMT_THREADS>(o.sbn, o.sbk);

  float part[8][4], acc[8][4], comp[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[i][j] = acc[i][j] = comp[i][j] = 0.f;

  float ra[EA], rb[EB];
  Walk w;
  w.start(SIMT_BK, o.bk, o.k);
  load_tile<EA>(A, sha, m0, o.m, o.sam, o.sak, w.k0, w.k1, ra);
  load_tile<EB>(B, shb, n0, o.n, o.sbn, o.sbk, w.k0, w.k1, rb);
  for (;;) {
    __syncthreads();
    stage_f32<EA>(ra, sha, sa);
    stage_f32<EB>(rb, shb, sb);
    __syncthreads();
    const bool tile_end = w.k1 == w.tile_stop;
    const bool last = w.k1 == o.k;
    if (!last) {
      w.next(SIMT_BK, o.bk, o.k);
      load_tile<EA>(A, sha, m0, o.m, o.sam, o.sak, w.k0, w.k1, ra);
      load_tile<EB>(B, shb, n0, o.n, o.sbn, o.sbk, w.k0, w.k1, rb);
    }
#pragma unroll
    for (int kk = 0; kk < SIMT_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          sa + kk * SPAD + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(
          sa + kk * SPAD + ty * 8 + 4);
      const float4 bv = *reinterpret_cast<const float4*>(
          sb + kk * SPAD + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[i][j] = __fmaf_rn(av[i], bw[j], part[i][j]);
    }
    if (tile_end) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fold<LEVEL>(acc[i][j], comp[i][j], part[i][j]);
    }
    if (last) break;
  }

  Out* out = static_cast<Out*>(o.out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long row = m0 + ty * 8 + i;
      const long long col = n0 + tx * 4 + j;
      if (row < o.m && col < o.n)
        out[row * o.n + col] =
            from_f32<Out>(total<LEVEL>(acc[i][j], comp[i][j]));
    }
}


// ---------------------------------------------------------------------
// What the fast paths share: the split-K epilogue, the fold of the
// splits, and the pack kernel that lays an operand out for 16-byte
// loads or TMA.

// Merge split s's folded (acc_s, comp_s) into the running (acc, comp)
// by the level's rule: level 0 adds; level 1 (Kahan, whose comp is the
// excess already added) folds acc_s with both excesses subtracted;
// level 2 (Neumaier, whose comp is the amount still to add) adds the
// split's comp and folds acc_s.
template <int LEVEL>
__device__ __forceinline__ void merge(float& acc, float& comp, float acc_s,
                                      float comp_s) {
  if constexpr (LEVEL != 0) comp = __fadd_rn(comp, comp_s);
  fold<LEVEL>(acc, comp, acc_s);
}

// Where a block's folded sums go: the output when K is not split,
// otherwise split s's slice of the f32 workspace, laid out as
// [split][acc, comp (levels 1 and 2)][m][n].
struct Dest {
  void* out;
  float* ws;
  long long m, n;
  int split, splits;
};

template <int LEVEL, typename Out>
__device__ __forceinline__ void put(const Dest& d, long long row,
                                    long long col, float acc, float comp) {
  if (row >= d.m || col >= d.n) return;
  if (d.splits == 1) {
    static_cast<Out*>(d.out)[row * d.n + col] =
        from_f32<Out>(total<LEVEL>(acc, comp));
    return;
  }
  const long long mn = d.m * d.n;
  float* w = d.ws + d.split * (LEVEL ? 2 : 1) * mn + row * d.n + col;
  w[0] = acc;
  if constexpr (LEVEL != 0) w[mn] = comp;
}

// The splits merged in split order, then the output's conversion.
template <int LEVEL, typename Out>
__global__ void fold_splits_kernel(const float* __restrict__ ws,
                                   Out* __restrict__ out, long long m,
                                   long long n, int splits) {
  const long long mn = m * n;
  constexpr int PLANES = LEVEL ? 2 : 1;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = ws[i];
    float comp = LEVEL ? ws[mn + i] : 0.f;
    for (int s = 1; s < splits; ++s) {
      const float* w = ws + s * PLANES * mn + i;
      merge<LEVEL>(acc, comp, w[0], LEVEL ? w[mn] : 0.f);
    }
    out[i] = from_f32<Out>(total<LEVEL>(acc, comp));
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else
    return __bfloat162float(v);
}

// dst[r * pitch + c] <- src[r * s_row + c * s_col] for r < rows, c <
// cols, through a 32 x 32 shared tile so that both sides coalesce
// (the source along whichever of its axes is contiguous).  SPLIT: f32
// in, bf16 hi = bf16_rn(x) and lo = bf16_rn(x - hi) out; otherwise a
// copy in the source's type.
template <typename In, typename Out, bool SPLIT>
__global__ void __launch_bounds__(256)
pack_kernel(const In* __restrict__ src, long long rows, long long cols,
            long long s_row, long long s_col, Out* __restrict__ hi,
            Out* __restrict__ lo, long long pitch) {
  __shared__ float tile[32][33];
  const long long r0 = static_cast<long long>(blockIdx.x) * 32;
  const long long c0 = static_cast<long long>(blockIdx.y) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const bool along_c = s_col == 1 || s_row != 1;
  for (int i = ty; i < 32; i += 8) {
    const int rr = along_c ? i : tx, cc = along_c ? tx : i;
    const long long r = r0 + rr, c = c0 + cc;
    tile[rr][cc] =
        r < rows && c < cols ? to_f32(src[r * s_row + c * s_col]) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const long long r = r0 + i, c = c0 + tx;
    if (r >= rows || c >= cols) continue;
    const float v = tile[i][tx];
    if constexpr (SPLIT) {
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      hi[r * pitch + c] = h;
      lo[r * pitch + c] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
    } else if constexpr (std::is_same<Out, float>::value) {
      hi[r * pitch + c] = v;
    } else {
      hi[r * pitch + c] = __float2bfloat16_rn(v);   // exact: v was bf16
    }
  }
}

// ---------------------------------------------------------------------
// Path 1, split-K on the tensor cores, for tall, thin products (VGG16
// fc1 through gemm).  A block owns a 32 x 128 output tile and a range of
// whole K-tiles, walked in 32-deep steps through a 3-stage ring: B's
// step (32 x 128, the bytes that matter) arrives by TMA in 128-byte-wide
// boxes with the 128-byte swizzle, counted on a `full` mbarrier; A's
// step (32 x 32, read again by every column block, from L2) by 16-byte
// cp.async.  Past the edges both read zeros.  mma.sync m16n8k16 takes
// the fragments; f32 operands are split into bf16 hi and lo in
// registers as they are read, so the weight crosses the memory bus once,
// as f32.  A (m, k) has row pitch lda and B (k, n) a 16-byte row pitch;
// both are unit-stride along their rows (the wrapper packs one that is
// not).

constexpr int P1_BM = 32;
constexpr int P1_BN = 128;
constexpr int P1_BK = 32;
constexpr int P1_STAGES = 3;
constexpr int P1_THREADS = 128;   // 4 warps, 32 rows x 32 columns each
constexpr int P1_RESIDENT = 3;    // blocks an SM holds (ops/matmul.py)
constexpr int P1_BOX = P1_BK * 128;   // bytes of one B box: 32 rows x 128

template <typename T>
struct P1 {
  static constexpr int E = 16 / sizeof(T);            // values a chunk
  static constexpr int BOX_COLS = 128 / sizeof(T);    // values a box row
  static constexpr int AP = P1_BK + 8;   // A's row pitch (values): the
                                         // fragment reads hit 32 banks
  static constexpr int B_BYTES = P1_BK * P1_BN * sizeof(T);
  static constexpr int STAGE_BYTES =
      (B_BYTES + P1_BM * AP * static_cast<int>(sizeof(T)) + 1023) / 1024 *
      1024;
  static constexpr int SMEM = P1_STAGES * STAGE_BYTES + 1024 + 64;
};

// B[r][c] of a stage: box c / BOX_COLS, row r of 128 bytes, its 16-byte
// chunks permuted by the 128-byte swizzle (chunk ^ (r % 8)), as TMA
// wrote them.  Conflict-free for the fragment reads below.
template <typename T>
__device__ __forceinline__ const T* b_at(const uint8_t* bs, int r, int c) {
  constexpr int BC = P1<T>::BOX_COLS;
  const int byte = (c % BC) * static_cast<int>(sizeof(T));
  return reinterpret_cast<const T*>(
      bs + (c / BC) * P1_BOX + r * 128 +
      ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15)));
}

using gemm::split2;

__device__ __forceinline__ uint32_t halves(const __nv_bfloat16* lo16,
                                           const __nv_bfloat16* hi16) {
  return *reinterpret_cast<const uint16_t*>(lo16) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi16))
          << 16);
}

template <typename T, int LEVEL, typename Out>
__global__ void __launch_bounds__(P1_THREADS, P1_RESIDENT)
splitk_tc_kernel(const T* __restrict__ A, long long lda,
                 const __grid_constant__ CUtensorMap tb, long long k,
                 int bk, long long ktiles, Dest d) {
  d.split = blockIdx.z;
  using C = P1<T>;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ uint8_t p1_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p1_smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + P1_STAGES * C::STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = (tid / 32) * 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * P1_BM;
  const int n0 = blockIdx.y * P1_BN;
  long long kt0, kt1;
  gemm::split_range(d.split, d.splits, ktiles, &kt0, &kt1);
  const long long kbeg = kt0 * bk;
  const long long kend = min(kt1 * bk, k);
  const int steps = static_cast<int>((kend - kbeg + P1_BK - 1) / P1_BK);

  if (tid == 0) {
    for (int s = 0; s < P1_STAGES; ++s) gemm::mbar_init(&full[s], 1);
    gemm::mbar_fence_init();
  }
  __syncthreads();

  // Stage `stage` <- the step at k0: B by TMA (thread 0), A by cp.async.
  auto load = [&](int stage, long long k0) {
    uint8_t* bs = smem + stage * C::STAGE_BYTES;
    T* as = reinterpret_cast<T*>(bs + C::B_BYTES);
    if (tid == 0) {
      gemm::fence_proxy_async();
      gemm::mbar_expect_tx(&full[stage], C::B_BYTES);
#pragma unroll
      for (int b = 0; b < P1_BN / C::BOX_COLS; ++b)
        gemm::tma_load_2d(bs + b * P1_BOX, &tb, &full[stage],
                          n0 + b * C::BOX_COLS, static_cast<int>(k0));
    }
    constexpr int ACH = P1_BK / C::E;
    for (int c = tid; c < P1_BM * ACH; c += P1_THREADS) {
      const int r = c / ACH, ch = c % ACH;
      const long long gm = m0 + r, gk = k0 + ch * C::E;
      const long long v = gm < d.m ? min(static_cast<long long>(C::E),
                                         k - gk) : 0;
      const int bytes = v > 0 ? static_cast<int>(v * sizeof(T)) : 0;
      gemm::cp_async16(as + r * C::AP + ch * C::E,
                       bytes ? A + gm * lda + gk : A, bytes);
    }
  };

  float part[2][4][4], acc[2][4][4], comp[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[i][j][e] = acc[i][j][e] = comp[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < P1_STAGES - 1; ++s) {
    if (s < steps) load(s, kbeg + s * P1_BK);
    gemm::cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    const int stage = i % P1_STAGES;
    gemm::cp_async_wait<P1_STAGES - 2>();
    gemm::mbar_wait(&full[stage], (i / P1_STAGES) & 1);
    __syncthreads();   // step i landed; step i - 1's stage is free
    if (i + P1_STAGES - 1 < steps)
      load((i + P1_STAGES - 1) % P1_STAGES,
           kbeg + static_cast<long long>(i + P1_STAGES - 1) * P1_BK);
    gemm::cp_async_commit();
    const uint8_t* bs = smem + stage * C::STAGE_BYTES;
    const T* as = reinterpret_cast<const T*>(bs + C::B_BYTES);
#pragma unroll
    for (int kk = 0; kk < P1_BK; kk += 16) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const T* p = as + (mi * 16 + g) * C::AP + kk + 2 * t;
        if constexpr (SPLIT) {
          const float2 x0 = *reinterpret_cast<const float2*>(p);
          const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * C::AP);
          const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 x3 =
              *reinterpret_cast<const float2*>(p + 8 * C::AP + 8);
          split2(x0.x, x0.y, ah[mi][0], al[mi][0]);
          split2(x1.x, x1.y, ah[mi][1], al[mi][1]);
          split2(x2.x, x2.y, ah[mi][2], al[mi][2]);
          split2(x3.x, x3.y, ah[mi][3], al[mi][3]);
        } else {
          ah[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          ah[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * C::AP);
          ah[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          ah[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * C::AP + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = kk + 2 * t, c = wn + j * 8 + g;
        uint32_t bh[2], bl[2];
        if constexpr (SPLIT) {
          split2(*b_at<T>(bs, r, c), *b_at<T>(bs, r + 1, c), bh[0], bl[0]);
          split2(*b_at<T>(bs, r + 8, c), *b_at<T>(bs, r + 9, c), bh[1],
                 bl[1]);
        } else {
          bh[0] = halves(b_at<T>(bs, r, c), b_at<T>(bs, r + 1, c));
          bh[1] = halves(b_at<T>(bs, r + 8, c), b_at<T>(bs, r + 9, c));
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          gemm::mma_bf16(part[mi][j], ah[mi], bh);
          if constexpr (SPLIT) {
            gemm::mma_bf16(part[mi][j], ah[mi], bl);
            gemm::mma_bf16(part[mi][j], al[mi], bh);
          }
        }
      }
    }
    const long long kstop =
        min(kbeg + static_cast<long long>(i + 1) * P1_BK, kend);
    if (kstop % bk == 0 || kstop == kend) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fold<LEVEL>(acc[mi][j][e], comp[mi][j][e], part[mi][j][e]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put<LEVEL, Out>(d, m0 + mi * 16 + g + (e / 2) * 8,
                        n0 + wn + j * 8 + 2 * t + (e % 2), acc[mi][j][e],
                        comp[mi][j][e]);
}

// ---------------------------------------------------------------------
// Path 3, SIMT f32 for levels 1 and 2 (true f32 products).  A block owns
// a 128 x 128 output tile: 8 warps as 4 x 2, each 32 x 64, its lanes as
// 4 x 8, each thread 8 x 8 (rows r0 + {0..3} and r0 + 16 + {0..3},
// columns c0 + {0..3} and c0 + 32 + {0..3}).  So each k reads two float4
// of A and two of B from shared memory for 64 FMAs, and a warp's reads
// touch 4 distinct float4 of A and 8 of B: shared memory keeps up with
// the FMA pipes.  A arrives transposed, At (k, m) of row pitch lda (the wrapper
// always packs it), B (k, n) of row pitch ldb; a 3-stage cp.async ring.
// The accumulator and the compensation of levels 1 and 2 live in
// shared memory (they are touched once a K-tile), so that the partial
// (64 registers) leaves room to prefetch the next k's fragments.

constexpr int P3_BM = 128;
constexpr int P3_BN = 128;
constexpr int P3_BK = 16;
constexpr int P3_STAGES = 3;
constexpr int P3_THREADS = 256;
constexpr int P3_STAGE_VALS = P3_BK * (P3_BM + P3_BN);

template <int LEVEL>
constexpr int p3_smem() {
  return (P3_STAGES * P3_STAGE_VALS + (LEVEL ? 2 : 1) * 64 * P3_THREADS) *
         4;
}

template <int LEVEL, typename Out>
__global__ void __launch_bounds__(P3_THREADS, 1)
simt128_kernel(const float* __restrict__ At, const float* __restrict__ B,
               long long lda, long long ldb, long long k, int bk,
               long long ktiles, Dest d) {
  d.split = blockIdx.z;
  extern __shared__ __align__(16) float p3_smem_f[];
  // element e of thread tid at e * P3_THREADS + tid: conflict-free
  float* acc_s = p3_smem_f + P3_STAGES * P3_STAGE_VALS;
  float* comp_s = acc_s + 64 * P3_THREADS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = (warp / 2) * 32 + (lane / 8) * 4;
  const int c0 = (warp % 2) * 64 + (lane % 8) * 4;
  const long long n0 = static_cast<long long>(blockIdx.x) * P3_BN;
  const long long m0 = static_cast<long long>(blockIdx.y) * P3_BM;
  long long kt0, kt1;
  gemm::split_range(d.split, d.splits, ktiles, &kt0, &kt1);
  const long long kbeg = kt0 * bk;
  const long long kend = min(kt1 * bk, k);
  const int steps = static_cast<int>((kend - kbeg + P3_BK - 1) / P3_BK);

  auto load = [&](int stage, long long k0) {
    float* as = p3_smem_f + stage * P3_STAGE_VALS;
    float* bs = as + P3_BK * P3_BM;
    for (int c = tid; c < P3_BK * 32; c += P3_THREADS) {
      const int r = c / 32, ch = c % 32;
      const long long gk = k0 + r;
      const long long gm = m0 + ch * 4, gn = n0 + ch * 4;
      const long long va = gk < k ? min(4LL, d.m - gm) : 0;
      const long long vb = gk < k ? min(4LL, d.n - gn) : 0;
      gemm::cp_async16(as + r * P3_BM + ch * 4,
                       va > 0 ? At + gk * lda + gm : At,
                       va > 0 ? static_cast<int>(va * 4) : 0);
      gemm::cp_async16(bs + r * P3_BN + ch * 4,
                       vb > 0 ? B + gk * ldb + gn : B,
                       vb > 0 ? static_cast<int>(vb * 4) : 0);
    }
  };

  float part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    acc_s[e * P3_THREADS + tid] = 0.f;
    if constexpr (LEVEL != 0) comp_s[e * P3_THREADS + tid] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < P3_STAGES - 1; ++s) {
    if (s < steps) load(s, kbeg + s * P3_BK);
    gemm::cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    gemm::cp_async_wait<P3_STAGES - 2>();
    __syncthreads();
    if (i + P3_STAGES - 1 < steps)
      load((i + P3_STAGES - 1) % P3_STAGES,
           kbeg + static_cast<long long>(i + P3_STAGES - 1) * P3_BK);
    gemm::cp_async_commit();
    const float* as = p3_smem_f + (i % P3_STAGES) * P3_STAGE_VALS;
    const float* bs = as + P3_BK * P3_BM;
#pragma unroll
    for (int kk = 0; kk < P3_BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + kk * P3_BM + r0);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * P3_BM + r0 + 16);
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + kk * P3_BN + c0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * P3_BN + c0 + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          part[r][c] = __fmaf_rn(av[r], bv[c], part[r][c]);
    }
    const long long kstop =
        min(kbeg + static_cast<long long>(i + 1) * P3_BK, kend);
    if (kstop % bk == 0 || kstop == kend) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int at = (r * 8 + c) * P3_THREADS + tid;
          float ac = acc_s[at];
          float cp = LEVEL ? comp_s[at] : 0.f;
          fold<LEVEL>(ac, cp, part[r][c]);
          acc_s[at] = ac;
          if constexpr (LEVEL != 0) comp_s[at] = cp;
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int at = (r * 8 + c) * P3_THREADS + tid;
      put<LEVEL, Out>(d, m0 + r0 + (r / 4) * 16 + r % 4,
                      n0 + c0 + (c / 4) * 32 + c % 4, acc_s[at],
                      LEVEL ? comp_s[at] : 0.f);
    }
}

// ---------------------------------------------------------------------
// Path 2, TMA + wgmma, for large products of bf16 operands and of f32
// operands at level 0.  The operands arrive as K-major bf16 planes of a
// 16-byte row pitch, which the pack kernel writes (A (m, k) as is, B
// transposed to (n, k); f32 split into hi and lo planes): 3001-wide rows
// are 12,004 bytes in f32 and 6,002 in bf16, which TMA cannot describe,
// and the tensor cores' 8-row groups want K-major tiles.  A block of
// three warpgroups owns a 128 x 128 output tile and a range of whole
// K-tiles: one producer thread keeps a ring of STAGES 64-deep K-steps
// in flight (one TMA box per plane, 128 rows x 128 bytes, 128-byte
// swizzle, completion counted on a `full` mbarrier), and two consumer
// warpgroups run wgmma m64n128k16 on the step that has landed (64 rows
// each), release it on its `empty` mbarrier, and fold the partial into
// the accumulator in registers at each K-tile's end.  f32 at level 0
// takes three products a k16 slice (hi.hi, hi.lo, lo.hi).

constexpr int P2_THREADS = 384;
constexpr int P2_BOX = 128 * 64 * 2;   // one 128 x 64 bf16 box: 16 KB

template <bool SPLIT3>
struct P2 {
  static constexpr int BOXES = SPLIT3 ? 4 : 2;   // A hi, B hi, A lo, B lo
  static constexpr int STAGE_BYTES = BOXES * P2_BOX;
  static constexpr int STAGES = SPLIT3 ? 3 : 5;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 256;
};

template <bool SPLIT3, int LEVEL, typename Out>
__global__ void __launch_bounds__(P2_THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ta_hi,
             const __grid_constant__ CUtensorMap tb_hi,
             const __grid_constant__ CUtensorMap ta_lo,
             const __grid_constant__ CUtensorMap tb_lo, long long k,
             int bk, long long ktiles, Dest d) {
  d.split = blockIdx.z;
  using C = P2<SPLIT3>;
  extern __shared__ uint8_t p2_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p2_smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem +
                                               C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * 128;
  long long kt0, kt1;
  gemm::split_range(d.split, d.splits, ktiles, &kt0, &kt1);
  const long long kbeg = kt0 * bk;
  const long long kend = min(kt1 * bk, k);
  const int steps = static_cast<int>((kend - kbeg + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      gemm::mbar_init(&full[s], 1);
      gemm::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    gemm::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tw == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) gemm::mbar_wait(&empty[s], (i / C::STAGES - 1) & 1);
        uint8_t* st = smem + s * C::STAGE_BYTES;
        const int kc = static_cast<int>(kbeg + static_cast<long long>(i) * 64);
        gemm::mbar_expect_tx(&full[s], C::STAGE_BYTES);
        gemm::tma_load_2d(st, &ta_hi, &full[s], kc, m0);
        gemm::tma_load_2d(st + P2_BOX, &tb_hi, &full[s], kc, n0);
        if constexpr (SPLIT3) {
          gemm::tma_load_2d(st + 2 * P2_BOX, &ta_lo, &full[s], kc, m0);
          gemm::tma_load_2d(st + 3 * P2_BOX, &tb_lo, &full[s], kc, n0);
        }
      }
    }
  } else {   // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float part[64], acc[64], comp[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) part[e] = acc[e] = comp[e] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % C::STAGES;
      gemm::mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint8_t* st = smem + s * C::STAGE_BYTES;
      const uint64_t da = gemm::desc_k128(st + wg * 64 * 128);
      const uint64_t db = gemm::desc_k128(st + P2_BOX);
      gemm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        gemm::wgmma_m64n128k16(part, da + 2 * kk, db + 2 * kk);
        if constexpr (SPLIT3) {
          const uint64_t dal =
              gemm::desc_k128(st + 2 * P2_BOX + wg * 64 * 128);
          const uint64_t dbl = gemm::desc_k128(st + 3 * P2_BOX);
          gemm::wgmma_m64n128k16(part, da + 2 * kk, dbl + 2 * kk);
          gemm::wgmma_m64n128k16(part, dal + 2 * kk, db + 2 * kk);
        }
      }
      gemm::wgmma_commit();
      gemm::wgmma_wait<0>();
      if (tw % 32 == 0) gemm::mbar_arrive(&empty[s]);
      const long long kstop =
          min(kbeg + static_cast<long long>(i + 1) * 64, kend);
      if (kstop % bk == 0 || kstop == kend) {
#pragma unroll
        for (int e = 0; e < 64; ++e) fold<LEVEL>(acc[e], comp[e], part[e]);
      }
    }
    const int w = tw / 32, l = tw % 32;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put<LEVEL, Out>(d, m0 + wg * 64 + w * 16 + l / 4 + (e / 2) * 8,
                        n0 + j * 8 + 2 * (l % 4) + (e % 2), acc[4 * j + e],
                        comp[4 * j + e]);
  }
}

// ---------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// the library needs no -lcuda; null when the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (rows, cols) row-major tensor of `pitch_bytes` a row, read in boxes
// of box_rows rows x box_cols values (128 bytes) with the 128-byte
// swizzle; reads past the edges are zeros.
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
              const void* base, long long rows, long long cols,
              long long pitch_bytes, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A K-major bf16 plane (rows, cols) of row pitch `pitch` values, read in
// 128-row x 64-value boxes.
bool plane_map(CUtensorMap* map, const void* base, long long rows,
               long long cols, long long pitch) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols,
                  pitch * 2, 128);
}

template <typename In, typename Out, bool SPLIT>
cudaError_t pack(const In* src, long long rows, long long cols,
                 long long s_row, long long s_col, Out* hi, Out* lo,
                 long long pitch, cudaStream_t s) {
  const long long gx = (rows + 31) / 32, gy = (cols + 31) / 32;
  if (gx > INT_MAX || gy > 65535) return cudaErrorInvalidValue;
  pack_kernel<In, Out, SPLIT><<<dim3(static_cast<unsigned>(gx),
                                     static_cast<unsigned>(gy)),
                                256, 0, s>>>(src, rows, cols, s_row, s_col,
                                             hi, lo, pitch);
  return cudaGetLastError();
}

template <int LEVEL, typename Out>
cudaError_t fold_splits(const Dest& d, cudaStream_t s) {
  if (d.splits == 1) return cudaSuccess;
  const long long blocks = (d.m * d.n + 255) / 256;
  fold_splits_kernel<LEVEL, Out>
      <<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
          d.ws, static_cast<Out*>(d.out), d.m, d.n, d.splits);
  return cudaGetLastError();
}

struct Call {
  const void* a;
  const void* b;
  long long m, n, k, sam, sak, sbk, sbn;
  int bk, splits;
  float* ws;
  uint8_t* planes;
  long long pitch_a, pitch_b;
  void* out;
  cudaStream_t s;

  long long ktiles() const { return (k + bk - 1) / bk; }
  Dest dest() const { return Dest{out, ws, m, n, 0, splits}; }
};

template <typename T, int LEVEL, typename Out>
cudaError_t run_split_k(const Call& c) {
  if (!encode_tiled()) return cudaErrorNotSupported;
  const T* A = static_cast<const T*>(c.a);
  const T* B = static_cast<const T*>(c.b);
  long long lda = c.sam, ldb = c.sbk;
  T* plane = reinterpret_cast<T*>(c.planes);
  cudaError_t err;
  if (c.pitch_a) {
    err = pack<T, T, false>(A, c.m, c.k, c.sam, c.sak, plane, nullptr,
                            c.pitch_a, c.s);
    if (err != cudaSuccess) return err;
    A = plane;
    lda = c.pitch_a;
    plane += c.m * c.pitch_a;
  }
  if (c.pitch_b) {
    err = pack<T, T, false>(B, c.k, c.n, c.sbk, c.sbn, plane, nullptr,
                            c.pitch_b, c.s);
    if (err != cudaSuccess) return err;
    B = plane;
    ldb = c.pitch_b;
  }
  CUtensorMap tb;
  if (!tile_map(&tb, std::is_same<T, float>::value
                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                sizeof(T), B, c.k, c.n, ldb * sizeof(T), P1_BK))
    return cudaErrorInvalidValue;
  const long long gx = (c.m + P1_BM - 1) / P1_BM;
  const long long gy = (c.n + P1_BN - 1) / P1_BN;
  if (gx > INT_MAX || gy > 65535 || c.splits > 65535 || c.n > INT_MAX ||
      c.k > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = splitk_tc_kernel<T, LEVEL, Out>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P1<T>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                static_cast<unsigned>(c.splits)),
           P1_THREADS, P1<T>::SMEM, c.s>>>(A, lda, tb, c.k, c.bk,
                                           c.ktiles(), c.dest());
  err = cudaGetLastError();
  return err != cudaSuccess ? err : fold_splits<LEVEL, Out>(c.dest(), c.s);
}

template <int LEVEL, typename Out>
cudaError_t run_simt(const Call& c) {
  float* at = reinterpret_cast<float*>(c.planes);
  cudaError_t err = pack<float, float, false>(
      static_cast<const float*>(c.a), c.k, c.m, c.sak, c.sam, at, nullptr,
      c.pitch_a, c.s);
  if (err != cudaSuccess) return err;
  const float* B = static_cast<const float*>(c.b);
  long long ldb = c.sbk;
  if (c.pitch_b) {
    float* bp = at + c.k * c.pitch_a;
    err = pack<float, float, false>(B, c.k, c.n, c.sbk, c.sbn, bp, nullptr,
                                    c.pitch_b, c.s);
    if (err != cudaSuccess) return err;
    B = bp;
    ldb = c.pitch_b;
  }
  const long long gx = (c.n + P3_BN - 1) / P3_BN;
  const long long gy = (c.m + P3_BM - 1) / P3_BM;
  if (gx > INT_MAX || gy > 65535 || c.splits > 65535)
    return cudaErrorInvalidValue;
  auto kernel = simt128_kernel<LEVEL, Out>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p3_smem<LEVEL>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                static_cast<unsigned>(c.splits)),
           P3_THREADS, p3_smem<LEVEL>(), c.s>>>(at, B, c.pitch_a, ldb, c.k,
                                                c.bk, c.ktiles(), c.dest());
  err = cudaGetLastError();
  return err != cudaSuccess ? err : fold_splits<LEVEL, Out>(c.dest(), c.s);
}

template <typename T, int LEVEL, typename Out>
cudaError_t run_wgmma(const Call& c) {
  constexpr bool SPLIT3 = std::is_same<T, float>::value;
  using C = P2<SPLIT3>;
  if (!encode_tiled()) return cudaErrorNotSupported;
  const long long p = c.pitch_a;
  auto* a_hi = reinterpret_cast<__nv_bfloat16*>(c.planes);
  auto* a_lo = SPLIT3 ? a_hi + c.m * p : a_hi;
  auto* b_hi = a_hi + (SPLIT3 ? 2 : 1) * c.m * p;
  auto* b_lo = SPLIT3 ? b_hi + c.n * p : b_hi;
  const T* A = static_cast<const T*>(c.a);
  const T* B = static_cast<const T*>(c.b);
  cudaError_t err = pack<T, __nv_bfloat16, SPLIT3>(A, c.m, c.k, c.sam,
                                                    c.sak, a_hi, a_lo, p,
                                                    c.s);
  if (err != cudaSuccess) return err;
  err = pack<T, __nv_bfloat16, SPLIT3>(B, c.n, c.k, c.sbn, c.sbk, b_hi,
                                       b_lo, p, c.s);
  if (err != cudaSuccess) return err;
  CUtensorMap ta_hi, ta_lo, tb_hi, tb_lo;
  if (!plane_map(&ta_hi, a_hi, c.m, c.k, p) ||
      !plane_map(&ta_lo, a_lo, c.m, c.k, p) ||
      !plane_map(&tb_hi, b_hi, c.n, c.k, p) ||
      !plane_map(&tb_lo, b_lo, c.n, c.k, p))
    return cudaErrorInvalidValue;
  const long long gx = (c.n + 127) / 128, gy = (c.m + 127) / 128;
  if (gx > INT_MAX || gy > 65535 || c.splits > 65535 || c.m > INT_MAX ||
      c.n > INT_MAX || c.k > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = wgmma_kernel<SPLIT3, LEVEL, Out>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                static_cast<unsigned>(c.splits)),
           P2_THREADS, C::SMEM, c.s>>>(ta_hi, tb_hi, ta_lo, tb_lo, c.k,
                                       c.bk, c.ktiles(), c.dest());
  err = cudaGetLastError();
  return err != cudaSuccess ? err : fold_splits<LEVEL, Out>(c.dest(), c.s);
}

template <typename Out>
cudaError_t launch_general(const Call& c, int in_code, int level) {
  const long long gx = (c.n + BN - 1) / BN, gy = (c.m + BM - 1) / BM;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  const Operands o = {c.a, c.b, c.out, c.m, c.n, c.k, c.sam, c.sak,
                      c.sbk, c.sbn, c.bk};
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  if (in_code == F32 && level == 0)
    tc_kernel<float, 0, Out><<<grid, TC_THREADS, 0, c.s>>>(o);
  else if (in_code == F32 && level == 1)
    simt_kernel<1, Out><<<grid, SIMT_THREADS, 0, c.s>>>(o);
  else if (in_code == F32)
    simt_kernel<2, Out><<<grid, SIMT_THREADS, 0, c.s>>>(o);
  else if (level == 0)
    tc_kernel<__nv_bfloat16, 0, Out><<<grid, TC_THREADS, 0, c.s>>>(o);
  else if (level == 1)
    tc_kernel<__nv_bfloat16, 1, Out><<<grid, TC_THREADS, 0, c.s>>>(o);
  else
    tc_kernel<__nv_bfloat16, 2, Out><<<grid, TC_THREADS, 0, c.s>>>(o);
  return cudaGetLastError();
}

template <int LEVEL, typename Out>
cudaError_t launch_fast(const Call& c, int in_code, int path) {
  if (in_code == F32) {
    if constexpr (LEVEL == 0) {
      if (path == SPLIT_K) return run_split_k<float, 0, Out>(c);
      if (path == TMA_WGMMA) return run_wgmma<float, 0, Out>(c);
    } else {
      if (path == SIMT) return run_simt<LEVEL, Out>(c);
    }
    return cudaErrorInvalidValue;
  }
  if (path == SPLIT_K) return run_split_k<__nv_bfloat16, LEVEL, Out>(c);
  if (path == TMA_WGMMA) return run_wgmma<__nv_bfloat16, LEVEL, Out>(c);
  return cudaErrorInvalidValue;
}

template <typename Out>
cudaError_t launch_out(const Call& c, int in_code, int level, int path) {
  if (path == GENERAL) return launch_general<Out>(c, in_code, level);
  if (level == 0) return launch_fast<0, Out>(c, in_code, path);
  if (level == 1) return launch_fast<1, Out>(c, in_code, path);
  return launch_fast<2, Out>(c, in_code, path);
}

}  // namespace

// 1 when the driver offers cuTensorMapEncodeTiled (path 2's TMA maps).
extern "C" int veles_matmul_tma_available() {
  return encode_tiled() != nullptr;
}

// out (m, n) row-major = a @ b at `level`, a and b read through their
// element strides; in_code F32 or BF16 (both operands), out_code F32,
// BF16 or F16; bk the K-tile of the level's fold (>= 1).  `path`,
// `splits`, the workspace ws (splits * (level ? 2 : 1) * m * n f32 when
// splits > 1), the planes and their pitches come from the planner in
// ops/matmul.py, which sized the buffers.
extern "C" int veles_matmul(const void* a, const void* b, void* out,
                            long long m, long long n, long long k,
                            long long sam, long long sak, long long sbk,
                            long long sbn, int bk, int level, int in_code,
                            int out_code, int path, int splits, void* ws,
                            void* planes, long long pitch_a,
                            long long pitch_b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (in_code < F32 || in_code > BF16 || out_code < F32 ||
      out_code > F16 || level < 0 || level > 2 || bk < 1 || m < 0 ||
      n < 0 || k < 0 || path < GENERAL || path > SIMT || splits < 1 ||
      (splits > 1 && !ws) || (path != GENERAL && bk % 64 != 0) ||
      ((path == TMA_WGMMA || path == SIMT) && !planes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const Call c = {a, b, m, n, k, sam, sak, sbk, sbn, bk, splits,
                  static_cast<float*>(ws), static_cast<uint8_t*>(planes),
                  pitch_a, pitch_b, out, static_cast<cudaStream_t>(stream)};
  switch (out_code) {
    case F32: err = launch_out<float>(c, in_code, level, path); break;
    case BF16:
      err = launch_out<__nv_bfloat16>(c, in_code, level, path);
      break;
    default: err = launch_out<__half>(c, in_code, level, path);
  }
  return static_cast<int>(err);
}
