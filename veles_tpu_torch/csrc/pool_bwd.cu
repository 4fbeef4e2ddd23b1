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
// this is the gather form of the same sum: one thread per input element
// walks the windows that cover it in the TPU kernel's tap order (kh, then
// kw), tests whether it is that window's first match, and adds the
// window's cotangent to its f32 sum.  Overlapping windows (AlexNet's
// 3 x 3 / 2) thus add in the TPU kernel's order, with no atomics, and each
// output element is written once.  Routing compares values exactly, so it
// is bit-exact; for non-overlapping windows (VGG's 2 x 2 / 2) so is the
// output.  The TPU kernel's VMEM-budget fallback has no counterpart.
//
// What bounds it on the card: bytes.  x and dx once each, y and dy once
// per covering window (from cache after the first); VGG16's five pools
// move ~1.96 GB a step at batch 32, 0.58 ms at 3.35 TB/s.  Neighbouring
// threads take neighbouring channels, so every load and store coalesces.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <algorithm>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Pool {
  long long total;  // n * h * w * c
  int h, w, c, oh, ow, ky, kx, sy, sx;
};

// Index is int where every offset fits (VGG16's pool1 at batch 32 has
// 103 M elements): 64-bit division and remainder would dominate the
// index arithmetic otherwise.
template <typename Index>
__global__ void __launch_bounds__(THREADS)
pool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ dy, float* __restrict__ dx,
                Pool g) {
  const Index total = static_cast<Index>(g.total);
  for (Index i = blockIdx.x * static_cast<Index>(THREADS) + threadIdx.x;
       i < total; i += static_cast<Index>(gridDim.x) * THREADS) {
    const Index c = i % g.c;
    Index q = i / g.c;
    const Index w = q % g.w;
    q /= g.w;
    const Index h = q % g.h;
    const Index n = q / g.h;
    const float xv = x[i];
    const float* xn = x + n * g.h * g.w * g.c + c;
    float acc = 0.f;
    for (int kh = 0; kh < g.ky; ++kh) {
      const Index hh = h - kh;
      if (hh < 0) break;
      if (hh % g.sy != 0) continue;
      const Index oh = hh / g.sy;
      if (oh >= g.oh) continue;
      for (int kw = 0; kw < g.kx; ++kw) {
        const Index ww = w - kw;
        if (ww < 0) break;
        if (ww % g.sx != 0) continue;
        const Index ow = ww / g.sx;
        if (ow >= g.ow) continue;
        const Index o = ((n * g.oh + oh) * g.ow + ow) * g.c + c;
        const float ymax = y[o];
        if (!(xv == ymax)) continue;
        // the first match wins: look at the window's earlier taps
        bool earlier = false;
        for (int t = 0; t < kh * g.kx + kw && !earlier; ++t) {
          const Index ih = oh * g.sy + t / g.kx;
          const Index iw = ow * g.sx + t % g.kx;
          const float v = (ih < g.h && iw < g.w)
                              ? xn[(ih * g.w + iw) * g.c]
                              : -INFINITY;
          earlier = v == ymax;
        }
        if (!earlier) acc = __fadd_rn(acc, dy[o]);
      }
    }
    dx[i] = acc;
  }
}

}  // namespace

extern "C" int veles_max_pool_bwd(const void* x, const void* y,
                                  const void* dy, void* dx, long long n,
                                  long long h, long long w, long long c,
                                  long long oh, long long ow, int ky, int kx,
                                  int sy, int sx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Pool g;
  g.total = n * h * w * c;
  if (g.total <= 0) return static_cast<int>(cudaSuccess);
  if (h > 0x7fffffffLL || w > 0x7fffffffLL || c > 0x7fffffffLL ||
      oh <= 0 || ow <= 0 || ky <= 0 || kx <= 0 || sy <= 0 || sx <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  g.h = static_cast<int>(h);
  g.w = static_cast<int>(w);
  g.c = static_cast<int>(c);
  g.oh = static_cast<int>(oh);
  g.ow = static_cast<int>(ow);
  g.ky = ky;
  g.kx = kx;
  g.sy = sy;
  g.sx = sx;
  const long long blocks =
      std::min((g.total + THREADS - 1) / THREADS, 132LL * 64);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* dyf = static_cast<const float*>(dy);
  float* dxf = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the grid stride may step past total by up to a grid's width
  if (g.total + blocks * THREADS < 0x7fffffffLL)
    pool_bwd_kernel<int><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        xf, yf, dyf, dxf, g);
  else
    pool_bwd_kernel<long long><<<static_cast<unsigned>(blocks), THREADS, 0,
                                 s>>>(xf, yf, dyf, dxf, g);
  return static_cast<int>(cudaGetLastError());
}
