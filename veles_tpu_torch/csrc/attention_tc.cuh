// The tensor-core pieces of the attention kernels at precision level 0
// (TC_BF16X3), shared by csrc/attention_fwd.cu and csrc/attention_bwd.cu:
// the staging of 64-row tiles by 16-byte cp.async, their split into
// 128-byte swizzled bf16 hi/lo planes, the bf16x3 score and output
// products on wgmma, and the store of an accumulator tile through shared
// memory as 16-byte stores.  The design is described at the top of
// csrc/attention_bwd.cu.

#pragma once

#include <cstdint>
#include <type_traits>

#include "attention.cuh"
#include "gemm_sm90.cuh"

namespace {

// design codes shared with veles_tpu_torch/ops/attention.py
enum Path { SIMT = 0, TC_BF16X3 = 1 };

constexpr int TC_THREADS = 128;   // one warpgroup, 64 rows
constexpr int TC_BLOCK = 8192;    // bytes of a 64-row x 64-column bf16 block

// A plane holds one operand's hi (or lo) bf16 values for 64 rows and
// DHP = 64 NV columns: NV column blocks of 64 rows x 128 bytes, each
// 8-row group 1024 bytes, the 16-byte chunks of a row permuted by the
// 128-byte swizzle (chunk ^ row % 8).  A product that contracts dh reads
// it K-major (desc_k128, 32 bytes further a k16 step); one that contracts
// the rows reads it MN-major (desc_mn128, 2048 bytes further a k16 step).
__device__ __forceinline__ int chunk_at(int r, int ch) {
  return (ch >> 3) * TC_BLOCK + (r >> 3) * 1024 + (r & 7) * 128 +
         (((ch & 7) ^ (r & 7)) << 4);
}

// stage <- rows row0..row0 + 63 of a (t, dh) matrix as they are, row-major
// DHP = 64 NV wide, zeros at or past row t and column dh: 16-byte cp.async
// copies where `vec` (completion by the caller's commit and wait), plain
// loads and stores otherwise.  The next tile's copies run while the
// current tile's products do.
template <int NV, typename T>
__device__ __forceinline__ void stage_tile(T* stage,
                                           const T* __restrict__ src,
                                           int row0, int t, int dh,
                                           bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // values a copy
  constexpr int CPR = B * NV / E;                        // copies a row
  constexpr int PER = B * CPR / TC_THREADS;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + TC_THREADS * i;
    const int r = idx / CPR, col = (idx % CPR) * E;
    const int row = row0 + r;
    T* dst = stage + r * B * NV + col;
    const long long off = static_cast<long long>(row) * dh + col;
    if (vec) {
      const bool in = row < t && col < dh;
      gemm::cp_async16(dst, in ? src + off : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = row < t && col + e < dh ? src[off + e] : from_f32<T>(0.f);
    }
  }
}

// hi (and, for f32, lo) <- a staged tile split into bf16 planes
template <int NV, typename T>
__device__ __forceinline__ void split_staged(uint8_t* hi, uint8_t* lo,
                                             const T* stage) {
  constexpr int CH = 8 * NV;                  // 16-byte plane chunks a row
  constexpr int PER = B * CH / TC_THREADS;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + TC_THREADS * i;
    const int r = idx / CH, ch = idx % CH;
    const T* src = stage + r * B * NV + ch * 8;
    const int at = chunk_at(r, ch);
    if constexpr (std::is_same<T, float>::value) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      uint4 h, l;
      gemm::split2(a.x, a.y, h.x, l.x);
      gemm::split2(a.z, a.w, h.y, l.y);
      gemm::split2(b.x, b.y, h.z, l.z);
      gemm::split2(b.z, b.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    } else {
      *reinterpret_cast<uint4*>(hi + at) =
          *reinterpret_cast<const uint4*>(src);
    }
  }
}

// d + c <- d + c + x: d the running sum rounded to nearest, c the
// rounding errors of the additions so far (Knuth's TwoSum; its error term
// is exact)
__device__ __forceinline__ void two_sum(float& d, float& c, float x) {
  const float s = __fadd_rn(d, x);
  const float xb = __fsub_rn(s, d);
  const float err = __fadd_rn(__fsub_rn(d, __fsub_rn(s, xb)),
                              __fsub_rn(x, xb));
  d = s;
  c = __fadd_rn(c, err);
}

// A score tile, waited for: d = A B^T over the DHP columns of both, the
// planes read K-major.  bf16 operands (SPLIT false) take one chain of
// hi.hi products.  For f32 operands the tensor cores' sums do not round
// to nearest: a wgmma aligns its products and its accumulator to the
// largest and truncates the bits below, so whatever it adds to a running
// sum loses its low bits.  Two ways to sum, by the caller's need:
// - the forward (COMPENSATED false): each k16 step's three products (the
//   cross terms hi.lo and lo.hi first, then hi.hi) start from zero in
//   `part` and are added to d rounded to nearest.  A 64 x 64 tile's
//   scores sit one ulp or more from the exactly rounded bf16x3 sum in 60 %
//   (dh 64) and 65 % (dh 128) of their elements (an H100);
// - the backward (COMPENSATED true), which splits p and ds again, where a
//   last-bit change of a score moves the bf16 lo of p or ds by 2^-17 of
//   the value: the cross terms go to a chain `x` of their own, 2^-8 of
//   the score, whose truncation is 2^-8 smaller; each step's hi.hi starts
//   from zero in `part`, its own alignment the only truncation, and is
//   added to d by TwoSum, its rounding error kept in `c`; then d + (c +
//   x), rounded once.  24 % (dh 64) and 32 % (dh 128) of the elements sit
//   one ulp or more off; the level-0 dq and dk at (3, 300, 128) came from
//   11.1e-6 and 12.3e-6 of their plain versions to 1.6e-6, at 26 % more
//   time for dq and 20 % for dk/dv at (512, 128, 64).
template <int NV, bool SPLIT, bool COMPENSATED = false>
__device__ __forceinline__ void score_tile(float* d, float* part,
                                           const uint8_t* ah,
                                           const uint8_t* al,
                                           const uint8_t* bh,
                                           const uint8_t* bl) {
  const auto k128 = [](const uint8_t* plane, int kk) {
    return gemm::desc_k128(plane + (kk >> 2) * TC_BLOCK + (kk & 3) * 32);
  };
  if constexpr (SPLIT && COMPENSATED) {
    float x[32], c[32];
#pragma unroll
    for (int kk = 0; kk < 4 * NV; ++kk) {
      gemm::wgmma_fence();
      gemm::wgmma_m64n64k16_kk(x, k128(ah, kk), k128(bl, kk), kk > 0);
      gemm::wgmma_m64n64k16_kk(x, k128(al, kk), k128(bh, kk), 1);
      gemm::wgmma_m64n64k16_kk(part, k128(ah, kk), k128(bh, kk), 0);
      gemm::wgmma_commit();
      gemm::wgmma_wait<0>();
      gemm::fence_operands<32>(x);
      gemm::fence_operands<32>(part);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (kk == 0) {
          d[e] = part[e];
          c[e] = 0.f;
        } else {
          two_sum(d[e], c[e], part[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e)
      d[e] = __fadd_rn(d[e], __fadd_rn(c[e], x[e]));
  } else if constexpr (SPLIT) {
#pragma unroll
    for (int kk = 0; kk < 4 * NV; ++kk) {
      gemm::wgmma_fence();
      gemm::wgmma_m64n64k16_kk(part, k128(ah, kk), k128(bl, kk), 0);
      gemm::wgmma_m64n64k16_kk(part, k128(al, kk), k128(bh, kk), 1);
      gemm::wgmma_m64n64k16_kk(part, k128(ah, kk), k128(bh, kk), 1);
      gemm::wgmma_commit();
      gemm::wgmma_wait<0>();
      gemm::fence_operands<32>(part);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        d[e] = kk ? __fadd_rn(d[e], part[e]) : part[e];
    }
  } else {
    gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NV; ++kk)
      gemm::wgmma_m64n64k16_kk(d, k128(ah, kk), k128(bh, kk), kk > 0);
    gemm::wgmma_commit();
    gemm::wgmma_wait<0>();
    gemm::fence_operands<32>(d);
  }
}

// part (from zero) = A X[:, 64 nb..] over the tile's 64 rows: A the
// split p or ds in registers (hi, lo), X's planes read MN-major; the
// cross terms of the four k16 steps first, then hi.hi, so that the small
// terms are summed before the large ones set the accumulator's
// magnitude.  Issued, not committed.
template <bool SPLIT>
__device__ __forceinline__ void issue_output(float* part,
                                             const uint32_t (&ah)[4][4],
                                             const uint32_t (&al)[4][4],
                                             const uint8_t* xh,
                                             const uint8_t* xl, int nb) {
  const auto desc = [nb](const uint8_t* x, int kk) {
    return gemm::desc_mn128(gemm::smem_addr(x) + nb * TC_BLOCK + kk * 2048,
                            TC_BLOCK, 1024);
  };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (SPLIT)
      gemm::wgmma_m64n64k16_rs(part, ah[kk], desc(xl, kk), kk > 0);
    gemm::wgmma_m64n64k16_rs(part, al[kk], desc(xh, kk), SPLIT || kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    gemm::wgmma_m64n64k16_rs(part, ah[kk], desc(xh, kk), 1);
}

// (hi, lo)[kk][i] <- the bf16 split of accumulator elements 8 kk + 2 i
// and 8 kk + 2 i + 1: wgmma's register A fragment of columns 16 kk..
__device__ __forceinline__ void split_fragments(const float* x,
                                                uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      gemm::split2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[kk][i],
                   lo[kk][i]);
}

// rows row0..row0 + 63 of a (t, dh) matrix <- the warpgroup's NV
// accumulators (thread (w, g, c) holds element 4 j + e of column block
// nb at row 16 w + g + 8 (e / 2), column 64 nb + 8 j + 2 c + e % 2 of
// the tile), staged through
// `tile`, a [64][DHP] f32 tile in shared memory whose 16-byte chunks are
// swizzled by row (chunk ch of row r at (ch & ~7) | ((ch ^ r) & 7)), so
// that each row leaves as 16-byte stores side by side.  Stored straight
// from the accumulators, element by element and 8 rows a warp
// instruction, the forward's out took 22 % of that kernel (an H100,
// (512, 128, 64) f32).  `vec`: dh a multiple of 16 bytes' worth and dst
// aligned.  The tile lies over planes the caller is done with; it syncs
// before they are written again.
template <int NV, typename T>
__device__ __forceinline__ void store_staged(T* __restrict__ dst,
                                             const float (&acc)[NV][32],
                                             float* tile, int row0, int t,
                                             int dh, bool vec) {
  constexpr int CH = 16 * NV;   // 16-byte chunks of a row
  const auto at = [](int row, int col) {
    const int ch = col >> 2;
    return row * 4 * CH + (((ch & ~7) | ((ch ^ row) & 7)) << 2) + (col & 3);
  };
  const int tid = threadIdx.x;
  const int r = 16 * (tid / 32) + (tid % 32) / 4;
  const int c = 2 * (tid % 4);
  __syncthreads();   // the planes under the tile are read
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + at(r + 8 * h, 64 * nb + 8 * j + c)) =
            make_float2(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < B * CH / TC_THREADS; ++n) {
    const int i = tid + n * TC_THREADS;
    const int row = i / CH, col = 4 * (i % CH);
    if (row0 + row >= t || col >= dh) continue;
    const float4 x = *reinterpret_cast<const float4*>(tile + at(row, col));
    T* o = dst + static_cast<long long>(row0 + row) * dh + col;
    if (!vec) {
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < dh) o[e] = from_f32<T>(xs[e]);
    } else if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(o) = x;
    } else {
      uint2 w;
      w.x = gemm::bf16x2(x.x, x.y);
      w.y = gemm::bf16x2(x.z, x.w);
      *reinterpret_cast<uint2*>(o) = w;
    }
  }
}

__device__ __forceinline__ uint8_t* aligned_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) &
      ~static_cast<uintptr_t>(1023));
}

// The shared-memory layout of the tensor-core kernels: PLANES - 2
// resident 64-row tiles (the forward: q; dq: q and do; dk/dv: k and v)
// and a streamed pair of tiles (k and v; k and v; q and do), each as a
// hi plane and (f32) a lo plane, then STAGES staging tiles of raw values:
// the backward's prologue stages its resident tiles in them and its loop
// the next streamed pair; the forward stages its next tiles, the next
// work item's q among them, in three.
template <int NV, typename T, int PLANES_ = 4, int STAGES = 2>
struct TcLayout {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int PLANE = TC_BLOCK * NV;
  static constexpr int PLANES = PLANES_;      // hi planes (and lo planes)
  static constexpr int TILE = B * B * NV;     // raw values of a tile
  // 1024 bytes of slack to align the planes for the swizzle, the planes,
  // the staging and (dk/dv) the streamed tile's lse and delta rows
  static constexpr int SMEM = 1024 + (SPLIT ? 2 : 1) * PLANES * PLANE +
                              STAGES * TILE * static_cast<int>(sizeof(T)) +
                              2 * B * static_cast<int>(sizeof(float));
  uint8_t* base;
  __device__ explicit TcLayout(uint8_t* raw) : base(aligned_1024(raw)) {}
  // plane i: the resident tiles first, the streamed pair last
  __device__ uint8_t* hi(int i) const { return base + i * PLANE; }
  __device__ uint8_t* lo(int i) const {
    return base + (PLANES + i) * PLANE;
  }
  __device__ T* stage(int i) const {
    return reinterpret_cast<T*>(base + (SPLIT ? 2 : 1) * PLANES * PLANE) +
           i * TILE;
  }
  __device__ float* rows() const {
    return reinterpret_cast<float*>(stage(STAGES));
  }
};

// 16-byte loads (and the forward's 16-byte stores) where every operand
// allows them
template <typename T>
int vector_loads(int dh, const void* q, const void* k, const void* v,
                 const void* dout) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return dh % (std::is_same<T, float>::value ? 4 : 8) == 0 && aligned(q) &&
         aligned(k) && aligned(v) && aligned(dout);
}

}  // namespace
