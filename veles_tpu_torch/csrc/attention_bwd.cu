// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv.
//
// Replaces the Pallas kernels veles_tpu/ops/attention.py:257
// (_flash_bwd_jit -> _bwd_dq_kernel) and :279 (-> _bwd_dkv_kernel).  From
// q, k, v, the output cotangent do (all (BH, T, dh), f32 or bf16 loaded
// into f32), the forward's lse and delta = rowsum(do * out) (both (BH, T)
// f32) it recomputes the probabilities instead of storing them:
//   p[r][c]  = exp(dot(q[r], k[c]) * scale - lse[r])  (c >= T: the -1e30
//              floor, so p is an exact 0; rows r >= T of a tile: 0)
//   dp[r][c] = dot(do[r], v[c])
//   ds[r][c] = p[r][c] * (dp[r][c] - delta[r]) * scale
//   dq = ds k,   dk = ds^T q,   dv = p^T do
//
// What differs from the TPU kernels, and why:
// - The TPU grids walk their reduction axis sequentially and carry the
//   sums in VMEM.  Here dq_kernel owns one (batch-head, q-tile) and loops
//   over k-tiles; dkv_kernel owns one (batch-head, k-tile) and loops over
//   q-tiles.  Each output element is summed by one thread in a fixed
//   order, with no atomics, so both kernels give the same bits on every
//   run.
// - dkv_kernel computes the transposed score tile (k rows by q columns)
//   directly, so p^T and ds^T land in shared memory in the layout the
//   dk and dv products read; dot(k, q) sums the same products in the same
//   order as dot(q, k).
// - Nothing is padded in device memory (the TPU pads dh to 128 lanes and T
//   to its tiles); lse and delta are (BH, T), not lane-broadcast.
//
// Numerics: true-f32 FMA products at every precision level; the scale,
// the difference dp - delta and the products of ds rounded on their own;
// expf, not the fast intrinsic.
//
// What bounds them on the card: operations.  dq does three products,
// 6 BH T^2 dh FLOP, dk/dv four, 8 BH T^2 dh FLOP: at the transformer's
// (512, 128, 64) 3.22 and 4.29 GFLOP, 0.048 and 0.064 ms at 67 TFLOP/s,
// against ~11 MB of operands.  These first kernels are plain SIMT f32
// like the forward: score tiles of 4 x 4 per thread, float4 shared-memory
// reads, no tensor cores, no pipelining.
//
// C interface: launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include "attention.cuh"

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

}  // namespace

extern "C" int veles_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, long long b, long long t,
                                  long long dh, int dtype, float scale,
                                  int device, void* stream) {
  cudaError_t e = prepare(device, b, t, dh, dtype);
  if (e == cudaSuccess)
    e = ATTENTION_DISPATCH(launch_dq, dh, dtype, q, k, v, dout, lse, delta,
                           dq, b, static_cast<int>(t), static_cast<int>(dh),
                           scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

extern "C" int veles_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, long long b,
                                   long long t, long long dh, int dtype,
                                   float scale, int device, void* stream) {
  cudaError_t e = prepare(device, b, t, dh, dtype);
  if (e == cudaSuccess)
    e = ATTENTION_DISPATCH(launch_dkv, dh, dtype, q, k, v, dout, lse, delta,
                           dk, dv, b, static_cast<int>(t),
                           static_cast<int>(dh), scale,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
