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
//   f32 operands, level 0: bf16x3.  Each operand splits at staging into
//     hi = bf16_rn(x) and lo = bf16_rn(x - hi); the partial is
//     hi.hi + hi.lo + lo.hi, three bf16 tensor-core products
//     (mma.sync m16n8k16, f32 accumulation) into one f32 partial.  A
//     product of two bf16 values is exact in f32.  |x| >= the bf16
//     maximum splits into inf and -inf and gives non-finite output, as
//     the JAX decomposition does.
//   bf16 operands, any level: one bf16 tensor-core pass.
//   f32 operands, levels 1 and 2: true f32 products (fmaf), SIMT.
//
// Both kernels walk K in steps (32 columns on the tensor cores, 16 on
// SIMT) that never straddle a K-tile boundary; a step's global loads
// are issued into registers while the previous step computes from
// shared memory.  Edges are masked at load (zeros) and store; nothing
// is padded in memory.  Operands are read through their strides, so a
// transposed view (gemm's trans flags) needs no copy.  The output tile
// of a block is fixed (64 x 64); the caller's bm and bn have no
// counterpart.  No float atomics: every output element is summed by one
// thread in a fixed order, so the same inputs give the same bits.
//
// What bounds it on the card: at 3001^3 the operations (level 0: three
// bf16 products at 989 TFLOP/s, 0.164 ms; levels 1 and 2: f32 at 67
// TFLOP/s, 0.807 ms); at VGG16 fc1 through gemm, (32, 25088) @ (25088,
// 4096), the 411 MB weight (0.124 ms).  This first version stages
// through registers with scalar loads and uses mma.sync, not wgmma or
// TMA; at M = 32 it has 64 blocks for 132 SMs (no split-K).
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() as int.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

// dtype codes shared with veles_tpu_torch/ops/matmul.py
enum Code { F32 = 0, BF16 = 1, F16 = 2 };

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
// Tensor-core kernel: bf16x3 for f32 operands at level 0, one bf16 pass
// for bf16 operands at any level.

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
// SIMT kernel: true f32 products for f32 operands at levels 1 and 2.

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

template <typename Out>
cudaError_t launch_out(const Operands& o, int in_code, int level,
                       dim3 grid, cudaStream_t s) {
  if (in_code == F32 && level == 0)
    tc_kernel<float, 0, Out><<<grid, TC_THREADS, 0, s>>>(o);
  else if (in_code == F32 && level == 1)
    simt_kernel<1, Out><<<grid, SIMT_THREADS, 0, s>>>(o);
  else if (in_code == F32)
    simt_kernel<2, Out><<<grid, SIMT_THREADS, 0, s>>>(o);
  else if (level == 0)
    tc_kernel<__nv_bfloat16, 0, Out><<<grid, TC_THREADS, 0, s>>>(o);
  else if (level == 1)
    tc_kernel<__nv_bfloat16, 1, Out><<<grid, TC_THREADS, 0, s>>>(o);
  else
    tc_kernel<__nv_bfloat16, 2, Out><<<grid, TC_THREADS, 0, s>>>(o);
  return cudaGetLastError();
}

}  // namespace

// out (m, n) row-major = a @ b at `level`, a and b read through their
// element strides; in_code F32 or BF16 (both operands), out_code F32,
// BF16 or F16; bk the K-tile of the level's fold (>= 1).
extern "C" int veles_matmul(const void* a, const void* b, void* out,
                            long long m, long long n, long long k,
                            long long sam, long long sak, long long sbk,
                            long long sbn, int bk, int level, int in_code,
                            int out_code, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (in_code < F32 || in_code > BF16 || out_code < F32 ||
      out_code > F16 || level < 0 || level > 2 || bk < 1 || m < 0 ||
      n < 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const long long gx = (n + BN - 1) / BN, gy = (m + BM - 1) / BM;
  if (gx > 0x7fffffffLL || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands o = {a, b, out, m, n, k, sam, sak, sbk, sbn, bk};
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case F32: err = launch_out<float>(o, in_code, level, grid, s); break;
    case BF16:
      err = launch_out<__nv_bfloat16>(o, in_code, level, grid, s);
      break;
    default: err = launch_out<__half>(o, in_code, level, grid, s);
  }
  return static_cast<int>(err);
}
