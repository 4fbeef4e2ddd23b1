// Conv weight gradient with the activation backward and the bias gradient
// fused in, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/conv_vjp.py:258
// (_fused_wgrad_jit -> _wgrad_kernel; its product step is
// veles_tpu/ops/common.py:91 mxu_partial_dot).  For an NHWC input x
// (N, H, W, Ci), the layer's forward output y and its cotangent dy (both
// (P, Co) with P = N * OH * OW) it computes
//   err[p, co]          = act'(y, dy)[p, co]   (closed form in terms of y)
//   grad_w[t, ci, co]   = sum_p tap_t(x)[p, ci] * err[p, co]
//   grad_b[co]          = sum_p err[p, co]
// where tap t = (kh, kw) reads x[n, oh*sy + kh - top, ow*sx + kw - left, ci]
// and zero outside the input.  grad_w comes out as (taps * Ci, Co), which
// is the HWIO weight (ky, kx, Ci, Co) reshaped.
//
// What differs from the TPU kernel, and why:
// - The TPU kernel contracts a materialised (taps, P, Ci) stack of strided
//   slices, about taps x the input's bytes.  Here every block computes each
//   tap's offset, stride and zero padding while it loads x, so no stack is
//   built, and any tap count works (AlexNet's 11 x 11 included; the TPU's
//   32-tap limit and its autodiff fallback have no counterpart).
// - The TPU grid walks P sequentially and carries the sum in VMEM.  Blocks
//   here run in parallel in no order, and a layer such as VGG16 conv1_2
//   (Ci = Co = 64, 9 taps) has only 5 output tiles for 132 SMs while its
//   contraction runs over 1.6 M rows at batch 32.  So P is split into
//   `splits` contiguous chunks: grid (Co tiles, taps*Ci tiles, splits);
//   each block writes its partial tile, and a second kernel sums the
//   partials over the splits in a fixed order.  No atomics: grad_w and
//   grad_b are the same bits on every run.
// - err is computed on the (P, Co) tile as it is loaded; the blocks of the
//   first taps*Ci tile write it (exactly once per element) and also sum the
//   bias partial, in f32, from the f32 err.
//
// Two designs, chosen per call by plan_wgrad in ops/conv_vjp.py (`path`):
//
//   TC_BF16X3 (1)  precision level 0, the TPU kernel's own arithmetic and
//                  the training path's: bf16x3 on the tensor cores.  Each
//                  staged f32 element splits in registers into hi =
//                  bf16_rn(v) and lo = bf16_rn(v - hi); both planes go to
//                  shared memory as 128-byte swizzled atoms, and wgmma
//                  reads them there as they are (P-major operands, r or co
//                  contiguous, are wgmma's MN-major layout, which bf16
//                  allows).  Each stage of 32 rows of P runs three
//                  m64n64k16 products a k-step (hi.lo, lo.hi, hi.hi) into
//                  a partial, which every two stages is added to the f32
//                  accumulator rounded to nearest and starts again from
//                  zero: the tensor cores' own accumulation (not
//                  round-to-nearest) never runs over more than 64 rows, so
//                  its rounding does not build up over a split.  The
//                  split-and-store phase's instructions bound the kernel
//                  on an H100, more than its bytes: the activation is a
//                  template parameter, each thread's plane offsets are
//                  worked out once, and the 16-byte and scalar loads are
//                  separate loops; with a reciprocal in place of the row
//                  tables' integer divisions these took a VGG16 step's
//                  wgrad time from 15.9 to 12.4 ms.
//                  Output tiles of 128 (taps * Ci) x 64 (Co), two
//                  warpgroups, or 128 x 128 where Co % 128 == 0, four; each
//                  warpgroup 64 x 64.  A block reads its x rows again for
//                  each column tile and its y, dy rows for each row tile
//                  (from L2), so the wider tile cuts that traffic by a
//                  quarter.  Two shared-memory buffers: while a stage's
//                  products run (asynchronous), the next stage, loaded
//                  into registers an iteration earlier, is split and
//                  stored, and the loads of the one after go out.  x is
//                  read in 16-byte vectors along ci where Ci % 4 == 0 (a
//                  4-channel group never straddles a tap), y and dy along
//                  Co where Co % 4 == 0; scalar lanes serve the rest
//                  (conv1_1's Ci = 3, ragged shapes, unaligned bases).
//                  |v| at or above the bf16 maximum gives non-finite
//                  output, as the TPU's level 0 does.
//   SIMT (0)       levels 1 (Kahan) and 2 (Neumaier): true-f32 FMA
//                  products; each BK-row stage is summed into a partial and
//                  the partials are added with compensation, in the blocks
//                  and again over the splits.  64 x 64 output tiles, 4 x 4
//                  per thread, 32 rows of P per shared-memory stage.
//
// What bounds it on the card.  Level 0: VGG16 at batch 32 needs 982 GFLOP
// of wgrad products a step, three bf16 products of each at 989 TFLOP/s
// (2.98 ms), against 6.4 GB of x, y and dy read and err written (1.92
// ms); taken per layer, max(bytes, operations) sums to 3.50 ms.  Levels 1
// and 2: the f32 rate, 67 TFLOP/s (TF32 is off), 14.95 ms a step.
//
// C interface: launches on the caller's stream, allocates nothing (the
// wrapper passes the partial buffers), and returns cudaGetLastError().

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"

namespace {

// design codes shared with veles_tpu_torch/ops/conv_vjp.py
enum Path { SIMT = 0, TC_BF16X3 = 1 };

constexpr int BR = 64;   // SIMT: grad_w rows (taps * Ci) per block
constexpr int BC = 64;   // SIMT: output channels per block
constexpr int BK = 32;   // rows of P per shared-memory stage (both designs)
constexpr int THREADS = 256;
constexpr int TX = BC / 4;  // SIMT: threads along the columns, 4 each

constexpr int TC_BR = 128;      // tensor-core design: grad_w rows a block
constexpr int TC_PAD = 8;       // bf16 padding a shared row (16 bytes)
constexpr int FAR = -(1 << 29);  // a row or column that reads only zeros

// activation codes shared with veles_tpu_torch/ops/conv_vjp.py
enum Act { LINEAR = 0, STRICT_RELU = 1, RELU_LOG = 2, TANH = 3, SIGMOID = 4 };

struct Geometry {
  int n, h, w, ci, oh, ow, co;
  int ky, kx, sy, sx, top, left;
  int p;       // n * oh * ow
  int r;       // ky * kx * ci
  int chunk;   // rows of P per split, a multiple of BK
  double inv_ow, inv_oh;   // 1 / ow, 1 / oh
};

// a / b for 0 <= a < 2**31 and b > 0, from a double reciprocal and one
// correction step (the estimate is off by at most one): a few
// instructions where an integer division takes a few dozen.
__device__ __forceinline__ int div_exact(int a, int b, double inv_b) {
  int q = static_cast<int>(static_cast<double>(a) * inv_b);
  if (static_cast<long long>(q) * b > a)
    --q;
  else if (static_cast<long long>(q + 1) * b <= a)
    ++q;
  return q;
}

// The activation backward in terms of the forward output y, with every
// product and difference rounded on its own (no FMA contraction), as the
// plain PyTorch version computes it.
template <int ACT>
__device__ __forceinline__ float act_grad(float y, float e, float tanh_a2,
                                          float tanh_ba) {
  if constexpr (ACT == STRICT_RELU)
    return __fmul_rn(e, y > 0.f ? 1.f : 0.f);
  else if constexpr (ACT == RELU_LOG)
    return __fmul_rn(e, __fsub_rn(1.f, expf(-y)));
  else if constexpr (ACT == TANH)
    return __fmul_rn(e, __fmul_rn(tanh_ba,
                                  __fsub_rn(tanh_a2, __fmul_rn(y, y))));
  else if constexpr (ACT == SIGMOID)
    return __fmul_rn(e, __fmul_rn(y, __fsub_rn(1.f, y)));
  else
    return e;
}

__device__ __forceinline__ float act_grad(int act, float y, float e,
                                          float tanh_a2, float tanh_ba) {
  switch (act) {
    case STRICT_RELU:
      return act_grad<STRICT_RELU>(y, e, tanh_a2, tanh_ba);
    case RELU_LOG:
      return act_grad<RELU_LOG>(y, e, tanh_a2, tanh_ba);
    case TANH:
      return act_grad<TANH>(y, e, tanh_a2, tanh_ba);
    case SIGMOID:
      return act_grad<SIGMOID>(y, e, tanh_a2, tanh_ba);
    default:
      return e;
  }
}

// acc (+ comp) += part, compensated per LEVEL
template <int LEVEL>
__device__ __forceinline__ void add_partial(float& acc, float& comp,
                                            float part) {
  if (LEVEL == 1) {  // Kahan
    const float yc = __fsub_rn(part, comp);
    const float t = __fadd_rn(acc, yc);
    comp = __fsub_rn(__fsub_rn(t, acc), yc);
    acc = t;
  } else if (LEVEL == 2) {  // Neumaier
    const float t = __fadd_rn(acc, part);
    if (fabsf(acc) >= fabsf(part))
      comp = __fadd_rn(comp, __fadd_rn(__fsub_rn(acc, t), part));
    else
      comp = __fadd_rn(comp, __fadd_rn(__fsub_rn(part, t), acc));
    acc = t;
  } else {
    acc = __fadd_rn(acc, part);
  }
}

template <int LEVEL>
__device__ __forceinline__ float finish(float acc, float comp) {
  return LEVEL == 2 ? __fadd_rn(acc, comp) : acc;
}

// ---------------------------------------------------------------------
// SIMT, levels 1 and 2

template <int LEVEL>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ dy, float* __restrict__ err,
             float* __restrict__ part_w, float* __restrict__ part_b,
             Geometry g, int act, float tanh_a2, float tanh_ba) {
  __shared__ __align__(16) float as[BK][BR];
  __shared__ __align__(16) float bs[BK][BC];
  __shared__ int col_kh[BR], col_kw[BR], col_ci[BR];
  __shared__ int row_n[BK], row_h[BK], row_w[BK];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int c0 = blockIdx.x * BC;
  const int r0 = blockIdx.y * BR;
  const int split = blockIdx.z;
  const int p_begin = split * g.chunk;
  const int p_end = min(p_begin + g.chunk, g.p);
  const bool first_rows = blockIdx.y == 0;

  if (tid < BR) {
    const int r = r0 + tid;
    if (r < g.r) {
      const int t = r / g.ci;
      col_kh[tid] = t / g.kx;
      col_kw[tid] = t % g.kx;
      col_ci[tid] = r % g.ci;
    } else {
      col_ci[tid] = -1;
    }
  }

  float acc[4][4], comp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = comp[i][j] = 0.f;
  float bias_acc = 0.f, bias_comp = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += BK) {
    __syncthreads();  // the previous stage is consumed
    if (tid < BK) {
      const int p = p0 + tid;
      if (p < p_end) {
        const int ow = p % g.ow;
        const int q = p / g.ow;
        row_n[tid] = q / g.oh;
        row_h[tid] = (q % g.oh) * g.sy - g.top;
        row_w[tid] = ow * g.sx - g.left;
      } else {
        row_n[tid] = -1;
      }
    }
    __syncthreads();
    // x taps: neighbouring threads take neighbouring (tap, ci) columns
#pragma unroll
    for (int i = 0; i < BK * BR / THREADS; ++i) {
      const int k = tid / BR + i * (THREADS / BR);
      const int c = tid % BR;
      const int n = row_n[k];
      const int ci = col_ci[c];
      float v = 0.f;
      if (n >= 0 && ci >= 0) {
        const int ih = row_h[k] + col_kh[c];
        const int iw = row_w[k] + col_kw[c];
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          v = x[((static_cast<long long>(n) * g.h + ih) * g.w + iw) * g.ci +
                ci];
      }
      as[k][c] = v;
    }
    // err: the activation backward on the (y, dy) tile as it is loaded
#pragma unroll
    for (int i = 0; i < BK * BC / THREADS; ++i) {
      const int k = tid / BC + i * (THREADS / BC);
      const int c = tid % BC;
      const int p = p0 + k;
      const int co = c0 + c;
      float e = 0.f;
      if (p < p_end && co < g.co) {
        const long long off = static_cast<long long>(p) * g.co + co;
        e = act_grad(act, y[off], dy[off], tanh_a2, tanh_ba);
        if (first_rows) err[off] = e;
      }
      bs[k][c] = e;
    }
    __syncthreads();

    if (first_rows && tid < BC) {
      float s = 0.f;
      for (int k = 0; k < BK; ++k) s = __fadd_rn(s, bs[k][tid]);
      add_partial<LEVEL>(bias_acc, bias_comp, s);
    }
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[i][j] = __fmaf_rn(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        add_partial<LEVEL>(acc[i][j], comp[i][j], part[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= g.r) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + tx * 4 + j;
      if (co < g.co)
        part_w[(static_cast<long long>(split) * g.r + r) * g.co + co] =
            finish<LEVEL>(acc[i][j], comp[i][j]);
    }
  }
  if (first_rows && tid < BC && c0 + tid < g.co)
    part_b[static_cast<long long>(split) * g.co + c0 + tid] =
        finish<LEVEL>(bias_acc, bias_comp);
}

// ---------------------------------------------------------------------
// Tensor cores, level 0: bf16x3 (see the top of the file).

// Shapes of the tensor-core design for a block of TC_BR x TC_BC outputs:
// (TC_BC / 32) warpgroups, 2 along the rows by TC_BC / 64 along the
// columns, each 64 x 64 outputs; 8 warps for 64 columns, 16 for 128.
template <int TC_BC>
struct Tc {
  static constexpr int THREADS = 4 * TC_BC;
  static constexpr int RESIDENT = 512 / THREADS;   // blocks an SM holds
  static constexpr int A_ATOMS = TC_BR / 64;       // 64-value atoms a row
  static constexpr int B_ATOMS = TC_BC / 64;
  // a plane: BK rows of k in groups of 8, each group a row of 1024-byte
  // atoms (bytes)
  static constexpr int A_PLANE = BK * TC_BR * 2;
  static constexpr int B_PLANE = BK * TC_BC * 2;
  // a stage: A hi, A lo, B hi, B lo; two stages in shared memory
  static constexpr int STAGE = 2 * A_PLANE + 2 * B_PLANE;
  static constexpr int A_COLS = TC_BR / 4;             // float4 a row of A
  static constexpr int A_ROWS = THREADS / A_COLS;      // rows a pass
  static constexpr int A_VECS = BK / A_ROWS;           // float4 a thread
  static constexpr int B_COLS = TC_BC / 4;
  static constexpr int B_ROWS = THREADS / B_COLS;
  static constexpr int B_VECS = BK / B_ROWS;
  static constexpr int ROW_SLOTS = 4;   // row tables of stages s..s+3
  static constexpr int TABLE_BYTES =
      8 * (TC_BR + ROW_SLOTS * BK) + 4 * (2 * TC_BR + 2 * ROW_SLOTS * BK);
  // 1024 bytes of slack to align the stages for the swizzle
  static constexpr int SMEM = 1024 + 2 * STAGE + TABLE_BYTES;
  static_assert(A_VECS * A_ROWS == BK && B_VECS * B_ROWS == BK, "tiling");
  static_assert(B_ROWS * TC_BC * 4 <= 2 * STAGE, "bias scratch");
};

// Byte offset of (k, m) in a plane `atoms` 64-value atoms wide: atom
// (k / 8, m / 64), row k % 8 of 128 bytes, its 16-byte chunks permuted by
// the 128-byte swizzle (chunk ^ row), as wgmma reads it (desc_mn128).
__device__ __forceinline__ int swizzled(int k, int m, int atoms) {
  return ((k >> 3) * atoms + (m >> 6)) * 1024 + (k & 7) * 128 +
         ((((m & 63) >> 3) ^ (k & 7)) << 4) + (m & 7) * 2;
}

__device__ __forceinline__ void split4(const float4& v, uint2& hi,
                                       uint2& lo) {
  gemm::split2(v.x, v.y, hi.x, lo.x);
  gemm::split2(v.z, v.w, hi.y, lo.y);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int TC_BC, int ACT>
__global__ void __launch_bounds__(Tc<TC_BC>::THREADS, Tc<TC_BC>::RESIDENT)
wgrad_tc_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ dy, float* __restrict__ err,
                float* __restrict__ part_w, float* __restrict__ part_b,
                Geometry g, float tanh_a2, float tanh_ba, int vec_x,
                int vec_y) {
  using C = Tc<TC_BC>;
  extern __shared__ uint8_t tc_smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  long long* col_off = reinterpret_cast<long long*>(stages + 2 * C::STAGE);
  long long* row_base = col_off + TC_BR;     // [ROW_SLOTS][BK]
  int2* row_hw = reinterpret_cast<int2*>(row_base + C::ROW_SLOTS * BK);
  int* col_kh = reinterpret_cast<int*>(row_hw + C::ROW_SLOTS * BK);
  int* col_kw = col_kh + TC_BR;              // row_hw: [ROW_SLOTS][BK]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * TC_BC;
  const int r0 = blockIdx.y * TC_BR;
  const int split = blockIdx.z;
  const int p_begin = split * g.chunk;
  const int p_end = min(p_begin + g.chunk, g.p);
  const bool first_rows = blockIdx.y == 0;
  // this thread's loads: A columns a_col..a_col+3 of rows a_row + A_ROWS i,
  // B columns b_col..b_col+3 of rows b_row + B_ROWS j
  const int a_col = (tid % C::A_COLS) * 4, a_row = tid / C::A_COLS;
  const int b_col = (tid % C::B_COLS) * 4, b_row = tid / C::B_COLS;
  const int co_b = c0 + b_col;

  if (tid < TC_BR) {
    const int r = r0 + tid;
    int kh = FAR, kw = 0;
    long long off = 0;
    if (r < g.r) {
      const int t = r / g.ci;
      kh = t / g.kx;
      kw = t % g.kx;
      off = (static_cast<long long>(kh) * g.w + kw) * g.ci + r % g.ci;
    }
    col_kh[tid] = kh;
    col_kw[tid] = kw;
    col_off[tid] = off;
  }
  // the row table of the stage at p0 -> slot: each row's (n, oh, ow) as
  // its input corner (ih0, iw0) and x's offset there
  auto fill_rows = [&](int slot, int p0) {
    if (tid < BK) {
      const int p = p0 + tid;
      long long base = 0;
      int ih = FAR, iw = FAR;
      if (p < p_end) {
        const int q = div_exact(p, g.ow, g.inv_ow);
        const int n = div_exact(q, g.oh, g.inv_oh);
        ih = (q - n * g.oh) * g.sy - g.top;
        iw = (p - q * g.ow) * g.sx - g.left;
        base = ((static_cast<long long>(n) * g.h + ih) * g.w + iw) * g.ci;
      }
      row_base[slot * BK + tid] = base;
      row_hw[slot * BK + tid] = make_int2(ih, iw);
    }
  };
  for (int q = 0; q < 3; ++q) fill_rows(q, p_begin + q * BK);
  __syncthreads();
  // a 4-channel group of A shares one tap when Ci % 4 == 0
  const int my_kh = col_kh[a_col], my_kw = col_kw[a_col];
  const long long my_off = col_off[a_col];

  float4 ra[C::A_VECS], ry[C::B_VECS], rdy[C::B_VECS];
  // registers <- the stage at p0 (its row table in `slot`); the 16-byte
  // and the scalar lanes are separate loops, the branch taken once
  const float* xa = x + my_off;
  const float* yb = y + co_b;
  const float* dyb = dy + co_b;
  auto load = [&](int slot, int p0) {
    const long long* rb = row_base + slot * BK;
    const int2* hw = row_hw + slot * BK;
    if (vec_x) {
#pragma unroll
      for (int i = 0; i < C::A_VECS; ++i) {
        const int k = a_row + C::A_ROWS * i;
        const int2 r = hw[k];
        const int ih = r.x + my_kh, iw = r.y + my_kw;
        ra[i] = static_cast<unsigned>(ih) < static_cast<unsigned>(g.h) &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(g.w)
                    ? ldg4(xa + rb[k])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < C::A_VECS; ++i) {
        const int k = a_row + C::A_ROWS * i;
        const int2 r = hw[k];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = a_col + e;
          const int ih = r.x + col_kh[c], iw = r.y + col_kw[c];
          v[e] = static_cast<unsigned>(ih) < static_cast<unsigned>(g.h) &&
                         static_cast<unsigned>(iw) <
                             static_cast<unsigned>(g.w)
                     ? __ldg(x + rb[k] + col_off[c])
                     : 0.f;
        }
        ra[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (vec_y) {
#pragma unroll
      for (int j = 0; j < C::B_VECS; ++j) {
        const int p = p0 + b_row + C::B_ROWS * j;
        const long long off = static_cast<long long>(p) * g.co;
        const bool in = p < p_end && co_b < g.co;
        ry[j] = in ? ldg4(yb + off) : make_float4(0.f, 0.f, 0.f, 0.f);
        rdy[j] = in ? ldg4(dyb + off) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < C::B_VECS; ++j) {
        const int p = p0 + b_row + C::B_ROWS * j;
        const long long off = static_cast<long long>(p) * g.co;
        float v[4], w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = p < p_end && co_b + e < g.co;
          v[e] = in ? __ldg(yb + off + e) : 0.f;
          w[e] = in ? __ldg(dyb + off + e) : 0.f;
        }
        ry[j] = make_float4(v[0], v[1], v[2], v[3]);
        rdy[j] = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  // this thread's plane offsets, the same every stage
  int a_at[C::A_VECS], b_at[C::B_VECS];
#pragma unroll
  for (int i = 0; i < C::A_VECS; ++i)
    a_at[i] = swizzled(a_row + C::A_ROWS * i, a_col, C::A_ATOMS);
#pragma unroll
  for (int j = 0; j < C::B_VECS; ++j)
    b_at[j] = swizzled(b_row + C::B_ROWS * j, b_col, C::B_ATOMS);
  // shared buffer `buf` <- the registers of the stage at p0: err computed
  // (and written by the first row tile, with the bias summed), then both
  // operands split into bf16 hi and lo planes
  auto store = [&](int buf, int p0) {
    uint8_t* ah = stages + buf * C::STAGE;
    uint8_t* al = ah + C::A_PLANE;
    uint8_t* bh = al + C::A_PLANE;
    uint8_t* bl = bh + C::B_PLANE;
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i) {
      uint2 hi, lo;
      split4(ra[i], hi, lo);
      *reinterpret_cast<uint2*>(ah + a_at[i]) = hi;
      *reinterpret_cast<uint2*>(al + a_at[i]) = lo;
    }
#pragma unroll
    for (int j = 0; j < C::B_VECS; ++j) {
      const int k = b_row + C::B_ROWS * j;
      const int p = p0 + k;
      float4 e;
      e.x = act_grad<ACT>(ry[j].x, rdy[j].x, tanh_a2, tanh_ba);
      e.y = act_grad<ACT>(ry[j].y, rdy[j].y, tanh_a2, tanh_ba);
      e.z = act_grad<ACT>(ry[j].z, rdy[j].z, tanh_a2, tanh_ba);
      e.w = act_grad<ACT>(ry[j].w, rdy[j].w, tanh_a2, tanh_ba);
      if (first_rows && p < p_end) {
        const float ev[4] = {e.x, e.y, e.z, e.w};
        float* out = err + static_cast<long long>(p) * g.co + co_b;
        if (vec_y) {
          if (co_b < g.co) *reinterpret_cast<float4*>(out) = e;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (co_b + q < g.co) out[q] = ev[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) bias[q] = __fadd_rn(bias[q], ev[q]);
      }
      uint2 hi, lo;
      split4(e, hi, lo);
      *reinterpret_cast<uint2*>(bh + b_at[j]) = hi;
      *reinterpret_cast<uint2*>(bl + b_at[j]) = lo;
    }
    gemm::fence_proxy_async();   // the stores, before wgmma reads them
  };

  // warpgroup (wm, wn) owns rows 64 wm.. and columns 64 wn.. of the tile
  const int wg = tid / 128, wm = wg % 2, wn = wg / 2;
  float acc[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part[e] = 0.f;

  // A stage's three products a k-step (the small cross terms first) go
  // into `part` on the tensor cores, asynchronously, from zero when
  // `fresh`; every two stages the caller adds `part` to the accumulator
  // rounded to nearest: the tensor cores' own accumulation never runs
  // over more than 64 rows of P, so its rounding does not build up over a
  // split.
  auto issue = [&](int buf, bool fresh) {
    const uint32_t base = gemm::smem_addr(stages + buf * C::STAGE);
    gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {   // k rows 16 kk.., groups 2 kk, 2 kk + 1
      const uint32_t a = base + ((2 * kk * C::A_ATOMS + wm) << 10);
      const uint32_t b =
          base + 2 * C::A_PLANE + ((2 * kk * C::B_ATOMS + wn) << 10);
      // one atom spans the product's 64 rows (columns): the next 8 rows
      // of k are a row of atoms further
      const int a_sbo = C::A_ATOMS * 1024, b_sbo = C::B_ATOMS * 1024;
      const uint64_t a_hi = gemm::desc_mn128(a, 1024, a_sbo);
      const uint64_t a_lo = gemm::desc_mn128(a + C::A_PLANE, 1024, a_sbo);
      const uint64_t b_hi = gemm::desc_mn128(b, 1024, b_sbo);
      const uint64_t b_lo = gemm::desc_mn128(b + C::B_PLANE, 1024, b_sbo);
      gemm::wgmma_m64n64k16_mn(part, a_hi, b_lo, kk || !fresh);
      gemm::wgmma_m64n64k16_mn(part, a_lo, b_hi, 1);
      gemm::wgmma_m64n64k16_mn(part, a_hi, b_hi, 1);
    }
    gemm::wgmma_commit();
  };
  auto fold = [&]() {
    gemm::wgmma_wait<0>();
    gemm::fence_operands<32>(part);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
  };

  // Stage s: its products run on the tensor cores while stage s + 1 (in
  // registers since the last iteration) is split and stored and stage
  // s + 2's loads go out, so a load has a whole stage's products to
  // arrive.  Row tables are filled three stages ahead, in a ring of four.
  const int steps = (p_end - p_begin + BK - 1) / BK;
  load(0, p_begin);
  store(0, p_begin);
  if (steps > 1) load(1, p_begin + BK);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int next = p_begin + (s + 1) * BK;
    issue(s & 1, s % 2 == 0);
    if (s + 1 < steps) store((s + 1) & 1, next);
    if (s + 2 < steps) load((s + 2) & 3, next + BK);
    if (s + 3 < steps) fill_rows((s + 3) & 3, next + 2 * BK);
    if (s % 2 == 1 || s + 1 == steps)
      fold();
    else
      gemm::wgmma_wait<0>();   // the buffer is free; `part` carries on
    __syncthreads();
  }

  const int t = tid % 128;
  const int rw0 = r0 + wm * 64 + 16 * (t / 32) + (t % 32) / 4;
  const int cw0 = c0 + wn * 64 + 2 * (t % 4);
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = rw0 + 8 * e2;
    if (r >= g.r) continue;
    float* out = part_w + (static_cast<long long>(split) * g.r + r) * g.co;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int co = cw0 + 8 * j + e1;
        if (co < g.co) out[co] = acc[4 * j + 2 * e2 + e1];
      }
  }
  if (first_rows) {  // the bias partial: the row groups' sums, in order
    float* red = reinterpret_cast<float*>(stages);
#pragma unroll
    for (int q = 0; q < 4; ++q) red[b_row * TC_BC + b_col + q] = bias[q];
    __syncthreads();
    if (tid < TC_BC && c0 + tid < g.co) {
      float s = 0.f;
      for (int k = 0; k < C::B_ROWS; ++k)
        s = __fadd_rn(s, red[k * TC_BC + tid]);
      part_b[static_cast<long long>(split) * g.co + c0 + tid] = s;
    }
  }
}

// out[e] = sum over s of part[s][e], s in order, compensated per LEVEL
template <int LEVEL>
__global__ void __launch_bounds__(THREADS)
reduce_splits(const float* __restrict__ part, float* __restrict__ out,
              long long count, int splits) {
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       e < count; e += static_cast<long long>(gridDim.x) * THREADS) {
    float acc = 0.f, comp = 0.f;
    for (int s = 0; s < splits; ++s)
      add_partial<LEVEL>(acc, comp, part[s * count + e]);
    out[e] = finish<LEVEL>(acc, comp);
  }
}

template <int LEVEL>
cudaError_t fold_splits(float* part_w, float* part_b, float* grad_w,
                        float* grad_b, const Geometry& g, int splits,
                        cudaStream_t stream) {
  const long long count_w = static_cast<long long>(g.r) * g.co;
  const long long blocks_w =
      std::min((count_w + THREADS - 1) / THREADS, 132LL * 16);
  reduce_splits<LEVEL><<<static_cast<unsigned>(blocks_w), THREADS, 0,
                         stream>>>(part_w, grad_w, count_w, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_splits<LEVEL><<<(g.co + THREADS - 1) / THREADS, THREADS, 0,
                         stream>>>(part_b, grad_b, g.co, splits);
  return cudaGetLastError();
}

template <int LEVEL>
cudaError_t launch_simt(const float* x, const float* y, const float* dy,
                        float* err, float* part_w, float* part_b,
                        float* grad_w, float* grad_b, const Geometry& g,
                        int splits, int act, float tanh_a2, float tanh_ba,
                        cudaStream_t stream) {
  const dim3 grid((g.co + BC - 1) / BC, (g.r + BR - 1) / BR, splits);
  wgrad_kernel<LEVEL><<<grid, THREADS, 0, stream>>>(
      x, y, dy, err, part_w, part_b, g, act, tanh_a2, tanh_ba);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return fold_splits<LEVEL>(part_w, part_b, grad_w, grad_b, g, splits,
                            stream);
}

template <int TC_BC, int ACT>
cudaError_t launch_tc(const float* x, const float* y, const float* dy,
                      float* err, float* part_w, float* part_b,
                      float* grad_w, float* grad_b, const Geometry& g,
                      int splits, float tanh_a2, float tanh_ba,
                      cudaStream_t stream) {
  auto kernel = wgrad_tc_kernel<TC_BC, ACT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tc<TC_BC>::SMEM);
  if (e != cudaSuccess) return e;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = g.ci % 4 == 0 && aligned(x);
  const int vec_y = g.co % 4 == 0 && aligned(y) && aligned(dy) &&
                    aligned(err);
  const dim3 grid((g.co + TC_BC - 1) / TC_BC, (g.r + TC_BR - 1) / TC_BR,
                  splits);
  kernel<<<grid, Tc<TC_BC>::THREADS, Tc<TC_BC>::SMEM, stream>>>(
      x, y, dy, err, part_w, part_b, g, tanh_a2, tanh_ba, vec_x, vec_y);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return fold_splits<0>(part_w, part_b, grad_w, grad_b, g, splits, stream);
}

// the tensor-core kernel with the activation as a template parameter
template <int TC_BC>
cudaError_t launch_tc(const float* x, const float* y, const float* dy,
                      float* err, float* part_w, float* part_b,
                      float* grad_w, float* grad_b, const Geometry& g,
                      int splits, int act, float tanh_a2, float tanh_ba,
                      cudaStream_t stream) {
  switch (act) {
    case STRICT_RELU:
      return launch_tc<TC_BC, STRICT_RELU>(x, y, dy, err, part_w, part_b,
                                           grad_w, grad_b, g, splits,
                                           tanh_a2, tanh_ba, stream);
    case RELU_LOG:
      return launch_tc<TC_BC, RELU_LOG>(x, y, dy, err, part_w, part_b,
                                        grad_w, grad_b, g, splits, tanh_a2,
                                        tanh_ba, stream);
    case TANH:
      return launch_tc<TC_BC, TANH>(x, y, dy, err, part_w, part_b, grad_w,
                                    grad_b, g, splits, tanh_a2, tanh_ba,
                                    stream);
    case SIGMOID:
      return launch_tc<TC_BC, SIGMOID>(x, y, dy, err, part_w, part_b,
                                       grad_w, grad_b, g, splits, tanh_a2,
                                       tanh_ba, stream);
    default:
      return launch_tc<TC_BC, LINEAR>(x, y, dy, err, part_w, part_b,
                                      grad_w, grad_b, g, splits, tanh_a2,
                                      tanh_ba, stream);
  }
}

}  // namespace

extern "C" int veles_conv_wgrad(
    const void* x, const void* y, const void* dy, void* err, void* part_w,
    void* part_b, void* grad_w, void* grad_b, long long n, long long h,
    long long w, long long ci, long long oh, long long ow, long long co,
    int ky, int kx, int sy, int sx, int top, int left, long long chunk,
    int splits, int act, int level, int path, int tile_cols, float tanh_a2,
    float tanh_ba, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long p = n * oh * ow;
  const long long r = static_cast<long long>(ky) * kx * ci;
  if (p <= 0 || co <= 0 || r <= 0) return static_cast<int>(cudaSuccess);
  const int rows = path == TC_BF16X3 ? TC_BR : BR;
  if (p > INT_MAX || r > INT_MAX || co > INT_MAX || h * w > INT_MAX ||
      chunk <= 0 || chunk % BK != 0 || splits <= 0 || splits > 65535 ||
      (splits - 1) * chunk >= p || (r + rows - 1) / rows > 65535 ||
      sy <= 0 || sx <= 0 ||
      !(path == TC_BF16X3 ? level == 0 && (tile_cols == 64 ||
                                           tile_cols == 128)
                          : path == SIMT && (level == 1 || level == 2) &&
                                tile_cols == BC))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.n = static_cast<int>(n);
  g.h = static_cast<int>(h);
  g.w = static_cast<int>(w);
  g.ci = static_cast<int>(ci);
  g.oh = static_cast<int>(oh);
  g.ow = static_cast<int>(ow);
  g.co = static_cast<int>(co);
  g.ky = ky;
  g.kx = kx;
  g.sy = sy;
  g.sx = sx;
  g.top = top;
  g.left = left;
  g.p = static_cast<int>(p);
  g.r = static_cast<int>(r);
  g.chunk = static_cast<int>(chunk);
  g.inv_ow = 1.0 / static_cast<double>(ow);
  g.inv_oh = 1.0 / static_cast<double>(oh);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* dyf = static_cast<const float*>(dy);
  float* errf = static_cast<float*>(err);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  float* gw = static_cast<float*>(grad_w);
  float* gb = static_cast<float*>(grad_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == TC_BF16X3 && tile_cols == 128)
    e = launch_tc<128>(xf, yf, dyf, errf, pw, pb, gw, gb, g, splits, act,
                       tanh_a2, tanh_ba, s);
  else if (path == TC_BF16X3)
    e = launch_tc<64>(xf, yf, dyf, errf, pw, pb, gw, gb, g, splits, act,
                      tanh_a2, tanh_ba, s);
  else if (level == 1)
    e = launch_simt<1>(xf, yf, dyf, errf, pw, pb, gw, gb, g, splits, act,
                       tanh_a2, tanh_ba, s);
  else
    e = launch_simt<2>(xf, yf, dyf, errf, pw, pb, gw, gb, g, splits, act,
                       tanh_a2, tanh_ba, s);
  return static_cast<int>(e);
}
