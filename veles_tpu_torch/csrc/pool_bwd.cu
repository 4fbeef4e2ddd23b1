// Max-pool backward (select and scatter), for Hopper (sm_90a).
//
// Replaces the Pallas kernel veles_tpu/ops/pool_bwd.py:192
// (_max_pool_bwd_jit -> _pool_bwd_kernel).  For an NHWC input x, the
// pooled output y (the window maxima) and its cotangent dy, each window's
// cotangent goes to the FIRST tap, in row-major (kh, kw) window order,
// whose input equals the window's max.  Ceil-mode windows that run past
// the bottom or right edge see -inf there, so a padded tap never takes
// the cotangent of a finite max.
//
// The TPU kernel scatters: it walks the taps in row-major order and adds
// each tap's selected cotangents into a VMEM accumulator through a
// stride-dilated shift.  On the card a scatter would need atomics, so
// the wrapper (ops/pool_bwd.py, plan_pool_bwd) picks one of two designs
// per call, both without atomics and each writing every dx element once:
//
// * "cells", for windows no wider than their stride (kx <= sx, ky <= sy:
//   VGG's 2 x 2 / 2).  Each input lies in at most one window, so the
//   TPU kernel's sum has one term.  One thread owns one window (n, oh,
//   ow) for V channels (V = 4: float4; V = 1 where C % 4 != 0 or a
//   pointer is not 16-byte aligned).  It reads y and dy once, each tap's
//   x once, finds each lane's first matching tap, and writes dx over its
//   whole sy x sx cell: dy at the selected tap, 0 elsewhere (the cell's
//   positions outside the window included, so dx needs no memset).
// * "overlap", for any other window (AlexNet's 3 x 3 / 2).  The gather
//   form of the TPU kernel's sum: one thread per input element (V
//   channels) walks the windows that cover it in the TPU kernel's tap
//   order (kh, then kw), tests whether it is that window's first match
//   (re-reading the window's earlier taps only where it equals the max),
//   and adds the window's cotangent to its f32 sum in that order.
//
// Both grids put channel lanes along threadIdx.x (neighbouring threads
// on neighbouring 16-byte groups, so every access coalesces), the output
// (cells) or input (overlap) columns along threadIdx.y and grid.x, and the
// (n, row) pairs along grid.y: a thread divides by a runtime value only
// to split its grid row into n and the row.  Routing compares values
// exactly, so both designs are bit-exact against the plain version; a
// NaN max routes nothing, as there.  The TPU kernel's VMEM-budget
// fallback has no counterpart.
//
// What bounds it on the card: bytes.  "cells" moves the minimum, x and
// dx once, y and dy once: 257 MB at VGG16's pool1 and batch 8, 77 us at
// 3.35 TB/s.  "overlap" reads y once per covering window (from cache
// after the first).
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_GRID_Y = 65535;

// designs, in the order of PATHS in veles_tpu_torch/ops/pool_bwd.py
enum Design { CELLS = 0, OVERLAP = 1 };

struct Pool {
  int h, w, c, oh, ow, ky, kx, sy, sx;
  int lanes;       // channel lanes: c / V
  long long rows;  // grid rows: n * oh (cells) or n * h (overlap)
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// KY, KX, SY, SX: the window and stride when known at compile time (VGG's
// 2 x 2 / 2), 0 for the runtime values in g.
template <int V, int KY, int KX, int SY, int SX>
__global__ void __launch_bounds__(THREADS)
pool_bwd_cells(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ dy, float* __restrict__ dx,
               Pool g) {
  const int ky = KY ? KY : g.ky, kx = KX ? KX : g.kx;
  const int sy = SY ? SY : g.sy, sx = SX ? SX : g.sx;
  const int lane = blockIdx.z * blockDim.x + threadIdx.x;
  const int ow = blockIdx.x * blockDim.y + threadIdx.y;
  if (lane >= g.lanes || ow >= g.ow) return;
  const int c0 = lane * V;
  const int w0 = ow * sx;
  const int cols = min(sx, g.w - w0);  // cell columns inside the input
  const long long pitch = static_cast<long long>(g.w) * g.c;  // an x row
  for (long long row = blockIdx.y; row < g.rows; row += gridDim.y) {
    const int n = static_cast<int>(row / g.oh);
    const int h0 = static_cast<int>(row - static_cast<long long>(n) * g.oh) *
                   sy;
    const long long o = (row * g.ow + ow) * g.c + c0;
    float ymax[V], cot[V];
    load<V>(y + o, ymax);
    load<V>(dy + o, cot);
    const long long base =
        ((static_cast<long long>(n) * g.h + h0) * g.w + w0) * g.c + c0;
    int first[V];  // each lane's first matching tap; -1: none
#pragma unroll
    for (int j = 0; j < V; ++j) first[j] = -1;
#pragma unroll 4
    for (int kh = 0; kh < ky; ++kh) {
#pragma unroll 4
      for (int kw = 0; kw < kx; ++kw) {
        float v[V];
        if (h0 + kh < g.h && w0 + kw < g.w) {
          load<V>(x + base + kh * pitch + static_cast<long long>(kw) * g.c,
                  v);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = -INFINITY;
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (first[j] < 0 && v[j] == ymax[j]) first[j] = kh * kx + kw;
      }
    }
    // 0 + dy: the plain version's f32 sum of one term (-0 becomes +0)
    float routed[V];
#pragma unroll
    for (int j = 0; j < V; ++j) routed[j] = __fadd_rn(0.f, cot[j]);
    const int cell_rows = min(sy, g.h - h0);
#pragma unroll 4
    for (int r = 0; r < cell_rows; ++r) {
#pragma unroll 4
      for (int q = 0; q < cols; ++q) {
        const int tap = (r < ky && q < kx) ? r * kx + q : -2;
        float out[V];
#pragma unroll
        for (int j = 0; j < V; ++j) out[j] = tap == first[j] ? routed[j] : 0.f;
        store<V>(dx + base + r * pitch + static_cast<long long>(q) * g.c,
                 out);
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
pool_bwd_overlap(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ dy, float* __restrict__ dx,
                 Pool g) {
  const int lane = blockIdx.z * blockDim.x + threadIdx.x;
  const int w = blockIdx.x * blockDim.y + threadIdx.y;
  if (lane >= g.lanes || w >= g.w) return;
  const int c0 = lane * V;
  const int ow_last = min(w / g.sx, g.ow - 1);
  for (long long row = blockIdx.y; row < g.rows; row += gridDim.y) {
    const int n = static_cast<int>(row / g.h);
    const int h = static_cast<int>(row - static_cast<long long>(n) * g.h);
    const int oh_last = min(h / g.sy, g.oh - 1);
    const float* xn = x + static_cast<long long>(n) * g.h * g.w * g.c + c0;
    const long long i = (row * g.w + w) * g.c + c0;
    float xv[V], acc[V];
    load<V>(x + i, xv);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    // kh ascending is oh descending, kw ascending ow descending: the TPU
    // kernel's tap order
    for (int oh = oh_last; oh >= 0; --oh) {
      const int kh = h - oh * g.sy;
      if (kh >= g.ky) break;
      for (int ow = ow_last; ow >= 0; --ow) {
        const int kw = w - ow * g.sx;
        if (kw >= g.kx) break;
        const long long o =
            ((static_cast<long long>(n) * g.oh + oh) * g.ow + ow) * g.c + c0;
        float ymax[V];
        load<V>(y + o, ymax);
        bool hit[V];
        bool any = false;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          hit[j] = xv[j] == ymax[j];
          any |= hit[j];
        }
        // the first match wins: look at the window's earlier taps
        const int h0 = oh * g.sy, w0 = ow * g.sx;
        for (int th = 0; th <= kh && any; ++th) {
          const int tw_end = th < kh ? g.kx : kw;
          for (int tw = 0; tw < tw_end && any; ++tw) {
            float v[V];
            if (h0 + th < g.h && w0 + tw < g.w) {
              load<V>(xn + (static_cast<long long>(h0 + th) * g.w + w0 + tw) *
                               g.c,
                      v);
            } else {
#pragma unroll
              for (int j = 0; j < V; ++j) v[j] = -INFINITY;
            }
            any = false;
#pragma unroll
            for (int j = 0; j < V; ++j) {
              hit[j] = hit[j] && !(v[j] == ymax[j]);
              any |= hit[j];
            }
          }
        }
        if (!any) continue;
        float cot[V];
        load<V>(dy + o, cot);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (hit[j]) acc[j] = __fadd_rn(acc[j], cot[j]);
      }
    }
    store<V>(dx + i, acc);
  }
}

template <int V>
void launch(int design, const float* x, const float* y, const float* dy,
            float* dx, const Pool& g, dim3 grid, dim3 block,
            cudaStream_t s) {
  if (design == OVERLAP) {
    pool_bwd_overlap<V><<<grid, block, 0, s>>>(x, y, dy, dx, g);
  } else if (g.ky == 2 && g.kx == 2 && g.sy == 2 && g.sx == 2) {
    pool_bwd_cells<V, 2, 2, 2, 2><<<grid, block, 0, s>>>(x, y, dy, dx, g);
  } else {
    pool_bwd_cells<V, 0, 0, 0, 0><<<grid, block, 0, s>>>(x, y, dy, dx, g);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// design: CELLS or OVERLAP; vec: channels a lane (4 or 1); lanes_x:
// channel lanes along threadIdx.x (a power of two dividing 256), the
// rest of the block's 256 threads along columns.
extern "C" int veles_max_pool_bwd(const void* x, const void* y,
                                  const void* dy, void* dx, long long n,
                                  long long h, long long w, long long c,
                                  long long oh, long long ow, int ky, int kx,
                                  int sy, int sx, int design, int vec,
                                  int lanes_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0)
    return static_cast<int>(cudaSuccess);
  const long long limit = 0x7fffffffLL;
  if (h > limit || w > limit || c > limit || oh <= 0 || ow <= 0 ||
      oh > limit || ow > limit || ky <= 0 || kx <= 0 || sy <= 0 || sx <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((design != CELLS && design != OVERLAP) ||
      (design == CELLS && (kx > sx || ky > sy)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(vec == 1 || (vec == 4 && c % 4 == 0 && aligned16(x) &&
                     aligned16(y) && aligned16(dy) && aligned16(dx))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes_x <= 0 || lanes_x > THREADS || THREADS % lanes_x != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Pool g;
  g.h = static_cast<int>(h);
  g.w = static_cast<int>(w);
  g.c = static_cast<int>(c);
  g.oh = static_cast<int>(oh);
  g.ow = static_cast<int>(ow);
  g.ky = ky;
  g.kx = kx;
  g.sy = sy;
  g.sx = sx;
  g.lanes = static_cast<int>(c / vec);
  g.rows = n * (design == CELLS ? oh : h);
  const int cols_y = THREADS / lanes_x;
  const long long cols = design == CELLS ? ow : w;
  const long long chunks = (g.lanes + lanes_x - 1) / lanes_x;
  if (chunks > MAX_GRID_Y) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((cols + cols_y - 1) / cols_y),
                  static_cast<unsigned>(std::min(g.rows, MAX_GRID_Y)),
                  static_cast<unsigned>(chunks));
  const dim3 block(lanes_x, cols_y);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* dyf = static_cast<const float*>(dy);
  float* dxf = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    launch<4>(design, xf, yf, dyf, dxf, g, grid, block, s);
  else
    launch<1>(design, xf, yf, dyf, dxf, g, grid, block, s);
  return static_cast<int>(cudaGetLastError());
}
