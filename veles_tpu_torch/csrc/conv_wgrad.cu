// Conv weight gradient with the activation backward and the bias gradient
// fused in, for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/conv_vjp.py:258
// (_fused_wgrad_jit -> _wgrad_kernel).  For an NHWC input x (N, H, W, Ci),
// the layer's forward output y and its cotangent dy (both (P, Co) with
// P = N * OH * OW) it computes
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
//   (Ci = Co = 64, 9 taps) has only 9 output tiles for 132 SMs while its
//   contraction runs over 1.6 M rows at batch 32.  So P is split into
//   `splits` contiguous chunks: grid (Co tiles, taps*Ci tiles, splits);
//   each block writes its partial tile, and a second kernel sums the
//   partials over the splits in a fixed order.  No atomics: grad_w and
//   grad_b are the same bits on every run.
// - err is computed on the (P, Co) tile as it is loaded; the blocks of the
//   first taps*Ci tile write it (exactly once per element) and also sum the
//   bias partial in the same pass.
//
// Precision levels (the JAX ladder): level 0 accumulates true-f32 FMA
// products (tighter than the TPU's bf16x3 level 0); level 1 (Kahan) and
// level 2 (Neumaier) sum each BK-row stage into a partial and add the
// partials with compensation, in the blocks and again over the splits.
//
// What bounds it on the card: operations.  VGG16 at batch 32 needs
// 982 GFLOP of wgrad products a step, a 14.7 ms bound at the 67 TFLOP/s
// f32 rate (TF32 is off), against ~1.4 GB of activations read.  This first
// kernel is plain SIMT f32: 64 x 64 output tiles, 4 x 4 per thread, 32
// rows of P per shared-memory stage, no tensor cores, no pipelining.
//
// C interface: launches on the caller's stream, allocates nothing (the
// wrapper passes the partial buffers), and returns cudaGetLastError().

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;   // grad_w rows (taps * Ci) per block
constexpr int BC = 64;   // output channels per block
constexpr int BK = 32;   // rows of P per shared-memory stage
constexpr int THREADS = 256;
constexpr int TX = BC / 4;  // threads along the columns, 4 each

// activation codes shared with veles_tpu_torch/ops/conv_vjp.py
enum Act { LINEAR = 0, STRICT_RELU = 1, RELU_LOG = 2, TANH = 3, SIGMOID = 4 };

struct Geometry {
  int n, h, w, ci, oh, ow, co;
  int ky, kx, sy, sx, top, left;
  int p;       // n * oh * ow
  int r;       // ky * kx * ci
  int chunk;   // rows of P per split, a multiple of BK
};

// The activation backward in terms of the forward output y, with every
// product and difference rounded on its own (no FMA contraction), as the
// plain PyTorch version computes it.
__device__ __forceinline__ float act_grad(int act, float y, float e,
                                          float tanh_a2, float tanh_ba) {
  switch (act) {
    case STRICT_RELU:
      return __fmul_rn(e, y > 0.f ? 1.f : 0.f);
    case RELU_LOG:
      return __fmul_rn(e, __fsub_rn(1.f, expf(-y)));
    case TANH:
      return __fmul_rn(e, __fmul_rn(tanh_ba,
                                    __fsub_rn(tanh_a2, __fmul_rn(y, y))));
    case SIGMOID:
      return __fmul_rn(e, __fmul_rn(y, __fsub_rn(1.f, y)));
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
    if (LEVEL == 0) {
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
            acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    } else {
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
cudaError_t launch(const float* x, const float* y, const float* dy,
                   float* err, float* part_w, float* part_b, float* grad_w,
                   float* grad_b, const Geometry& g, int splits, int act,
                   float tanh_a2, float tanh_ba, cudaStream_t stream) {
  const dim3 grid((g.co + BC - 1) / BC, (g.r + BR - 1) / BR, splits);
  wgrad_kernel<LEVEL><<<grid, THREADS, 0, stream>>>(
      x, y, dy, err, part_w, part_b, g, act, tanh_a2, tanh_ba);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long count_w = static_cast<long long>(g.r) * g.co;
  const long long blocks_w =
      std::min((count_w + THREADS - 1) / THREADS, 132LL * 16);
  reduce_splits<LEVEL><<<static_cast<unsigned>(blocks_w), THREADS, 0,
                         stream>>>(part_w, grad_w, count_w, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_splits<LEVEL><<<(g.co + THREADS - 1) / THREADS, THREADS, 0,
                         stream>>>(part_b, grad_b, g.co, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int veles_conv_wgrad(
    const void* x, const void* y, const void* dy, void* err, void* part_w,
    void* part_b, void* grad_w, void* grad_b, long long n, long long h,
    long long w, long long ci, long long oh, long long ow, long long co,
    int ky, int kx, int sy, int sx, int top, int left, long long chunk,
    int splits, int act, int level, float tanh_a2, float tanh_ba, int device,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long p = n * oh * ow;
  const long long r = static_cast<long long>(ky) * kx * ci;
  if (p <= 0 || co <= 0 || r <= 0) return static_cast<int>(cudaSuccess);
  if (p > INT_MAX || r > INT_MAX || co > INT_MAX || h * w > INT_MAX ||
      chunk <= 0 || chunk % BK != 0 || splits <= 0 || splits > 65535 ||
      (splits - 1) * chunk >= p || (r + BR - 1) / BR > 65535 ||
      sy <= 0 || sx <= 0 || level < 0 || level > 2)
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
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* dyf = static_cast<const float*>(dy);
  float* errf = static_cast<float*>(err);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  float* gw = static_cast<float*>(grad_w);
  float* gb = static_cast<float*>(grad_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
    case 1:
      e = launch<1>(xf, yf, dyf, errf, pw, pb, gw, gb, g, splits, act,
                    tanh_a2, tanh_ba, s);
      break;
    case 2:
      e = launch<2>(xf, yf, dyf, errf, pw, pb, gw, gb, g, splits, act,
                    tanh_a2, tanh_ba, s);
      break;
    default:
      e = launch<0>(xf, yf, dyf, errf, pw, pb, gw, gb, g, splits, act,
                    tanh_a2, tanh_ba, s);
  }
  return static_cast<int>(e);
}
