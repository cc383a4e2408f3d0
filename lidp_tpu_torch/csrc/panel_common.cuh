// Shared pieces of the O(N^2) panel kernels (eind, pair, wolf, dipole),
// templated on the scalar type T: float for the f32 kernels, double for
// their f64-grade twins (the *_df kernels of the TPU package are double-f32
// only because its compiler has no f64; this card has native f64).
//
// Tiling (the classic N-body shape, replacing the TPU's sequential
// (row-block, column-block) grid): one CTA owns ROWS rows; LANES adjacent
// threads share a row and stride the columns of a TILE-wide column tile
// staged in shared memory; the CTA itself loops over all column tiles, so
// per-row sums stay in registers and are written once, with no atomics.
// Per-CTA scalar partials go to a (gridDim.x, 8) buffer that a second,
// one-block stage sums in a fixed order: results never depend on the order
// in which CTAs run.
#pragma once

#include <cuda_runtime.h>

namespace lidp {

constexpr int ROWS = 32;               // rows per CTA
constexpr int LANES = 8;               // threads per row
constexpr int THREADS = ROWS * LANES;  // 256
constexpr int TILE = THREADS;          // columns per shared-memory tile
constexpr int NACC = 8;                // scalar partials per CTA
constexpr unsigned FULL = 0xffffffffu;

// math functions by overload, so a double instantiation never drops to an
// f32 routine
__device__ __forceinline__ float rsqrt_(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_(double v) { return rsqrt(v); }
__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float rint_(float v) { return rintf(v); }
__device__ __forceinline__ double rint_(double v) { return rint(v); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ int to_int(float v) { return __float2int_rn(v); }
__device__ __forceinline__ int to_int(double v) { return __double2int_rn(v); }

// minimum image d - L*round(d/L); rint rounds half to even like jnp.round
template <typename T>
__device__ __forceinline__ T mi(T d, T L, T Linv) {
  return d - L * rint_(d * Linv);
}

// rsqrt for inputs that are never subnormal: rsqrtf wraps MUFU.RSQ in a
// rescaling for subnormal inputs; for normal inputs the flush-to-zero form
// below returns the same bits in one instruction (rsqrtf made the whole
// eind kernel 4.2% longer).  The double rsqrt stays the full-accuracy
// routine.
__device__ __forceinline__ float rsqrt_normal(float v) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}
__device__ __forceinline__ double rsqrt_normal(double v) { return rsqrt(v); }

// sum over the LANES threads of one row; lane 0 of the row holds the total
template <typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL, v, off, LANES);
  return v;
}

// CTA-wide sums of NACC per-thread scalars, in a fixed order, written to
// partials[blockIdx.x * NACC + k].  Every one of the CTA's NT threads must
// call it.
template <typename T, int NT = THREADS>
__device__ __forceinline__ void block_partials(const T (&v)[NACC],
                                               T* __restrict__ partials) {
  __shared__ T red[NT / 32][NACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    T s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    T s = T(0);
    for (int w = 0; w < NT / 32; ++w) s += red[w][threadIdx.x];
    partials[blockIdx.x * NACC + threadIdx.x] = s;
  }
}

// second stage, one CTA of REDUCE_THREADS: acc[k] = scale_k * sum_b
// partials[b, k] in double, scale_0 = s0, scale_k = s1 for k > 0.  The
// order is fixed: group g of scalar k sums blocks g, g + RED_GROUPS, ... in
// block order (the CTA's loads of one step are contiguous), then thread k
// adds the groups in order.  A one-thread loop over the blocks waited on
// each load in turn: 3.8 ms on an H100 for 26,508 CTAs' partials.
constexpr int RED_GROUPS = 32;
constexpr int REDUCE_THREADS = NACC * RED_GROUPS;

template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials(const T* __restrict__ partials, int nblocks, T s0, T s1,
                T* __restrict__ acc) {
  __shared__ double part[RED_GROUPS][NACC];
  const int k = threadIdx.x % NACC, g = threadIdx.x / NACC;
  double s = 0.0;
#pragma unroll 4
  for (int b = g; b < nblocks; b += RED_GROUPS) s += partials[b * NACC + k];
  part[g][k] = s;
  __syncthreads();
  if (threadIdx.x < NACC) {
    double t = 0.0;
    for (int h = 0; h < RED_GROUPS; ++h) t += part[h][k];
    acc[k] = static_cast<T>((k == 0 ? s0 : s1) * t);
  }
}

inline int nblocks_for(int nrows) { return (nrows + ROWS - 1) / ROWS; }

// ---- the whole-panel kernels (eind_whole_kernel, dipole_whole_kernel) ----
// The atoms fall into nT tiles of BT; a CTA takes one unordered tile pair
// and computes each of its atom pairs once, for both atoms.

// A column's operands in shared memory: n 16-byte vectors (seven or eight
// values: two float4, or four double2)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 2;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 4;
};

// The nT (nT + 1) / 2 unordered pairs of nT tiles, one per block: block b
// takes tile I against J = I + k mod nT, for k = 0 .. K - 1 (K = (nT - 1) /
// 2 + 1) and every I (b < nT K: I = b mod nT, k = b / nT), then, when nT
// is even, k = nT / 2 for I < nT / 2 (b >= nT K: I = b - nT K).  k = 0 is
// the diagonal tile, whose CTA takes only its pairs i < j.
struct TilePair {
  int I, J, k;
};
__device__ __forceinline__ TilePair tile_pair(int b, int nT) {
  const int nK = nT * ((nT - 1) / 2 + 1);
  const int I = b < nK ? b % nT : b - nK;
  const int k = b < nK ? b / nT : nT / 2;
  return TilePair{I, I + k < nT ? I + k : I + k - nT, k};
}
inline int tile_pair_count(int nT) { return nT * (nT + 1) / 2; }

// The partial buffer part (nT, nT + 1, 3, BT): the CTA of tile pair (I, k)
// writes tile I's row sums to slot k of I and tile J's column sums to slot
// col_slot(k) of J, so each tile's nT + 1 slots are each written once.
__device__ __forceinline__ int col_slot(int k, int nT) {
  return k ? nT - k : nT;
}
template <int BT, typename T>
__device__ __forceinline__ T* slot_ptr(T* part, int tile, int slot, int nT) {
  return part + ((size_t)tile * (nT + 1) + slot) * 3 * BT;
}

// out (n, 3) = the sum of each atom's nT + 1 slots in slot order, negated
// when NEG: no float atomics, the same bits whatever order the CTAs ran in
template <typename T, int BT, bool NEG>
__global__ void slot_sum_kernel(const T* __restrict__ part, int n, int nT,
                                T* __restrict__ out) {
  const int tile = blockIdx.x, comp = blockIdx.y;
  const int i = tile * BT + threadIdx.x;
  if (i >= n) return;
  const T* p = part + ((size_t)tile * (nT + 1) * 3 + comp) * BT + threadIdx.x;
  T s = T(0);
#pragma unroll 8
  for (int slot = 0; slot <= nT; ++slot) s += p[(size_t)slot * 3 * BT];
  out[3 * i + comp] = NEG ? -s : s;
}

}  // namespace lidp
