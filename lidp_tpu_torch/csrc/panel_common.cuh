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
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
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

// products and sums each rounded on its own, never contracted into a fused
// multiply-add: rsq_rn rounds exactly as the plain version's separate
// tensor operations do, so that kernel and plain version put every pair on
// the same side of a cutoff
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T rsq_rn(T dx, T dy, T dz) {
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

// sum over the LANES threads of one row; lane 0 of the row holds the total
template <typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL, v, off, LANES);
  return v;
}

// CTA-wide sums of NACC per-thread scalars, in a fixed order, written to
// row[k].  Every one of the CTA's NT threads must call it.
template <typename T, int NT = THREADS>
__device__ __forceinline__ void block_partials_row(const T (&v)[NACC],
                                                   T* __restrict__ row) {
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
    row[threadIdx.x] = s;
  }
}

// block_partials_row to partials[blockIdx.x * NACC + k]
template <typename T, int NT = THREADS>
__device__ __forceinline__ void block_partials(const T (&v)[NACC],
                                               T* __restrict__ partials) {
  block_partials_row<T, NT>(v, partials + (size_t)blockIdx.x * NACC);
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
__host__ __device__ inline int tile_pair_count(int nT) {
  return nT * (nT + 1) / 2;
}

// The partial buffer part (nT, nT + 1, NC, BT), NC = 3 (one vector per
// atom) or 6 (two: the pair kernel's force and field): the CTA of tile pair
// (I, k) writes tile I's row sums to slot k of I and tile J's column sums
// to slot col_slot(k) of J, so each tile's nT + 1 slots are each written
// once.
__device__ __forceinline__ int col_slot(int k, int nT) {
  return k ? nT - k : nT;
}
template <int BT, typename T, int NC = 3>
__device__ __forceinline__ T* slot_ptr(T* part, int tile, int slot, int nT) {
  return part + ((size_t)tile * (nT + 1) + slot) * NC * BT;
}

// The block whose CTA writes slot `slot` of tile t (tile_pair's inverse):
// slot nT is the diagonal's column sums; of the others, slot k < nT / 2 is
// tile t's row sums of (t, k), slot nT - k > nT / 2 the column sums of
// (t - k, k), and for even nT slot nT / 2 the row sums of (t, nT / 2)
// when t < nT / 2, else the column sums of (t - nT / 2, nT / 2).
__device__ __forceinline__ int slot_block(int t, int slot, int nT) {
  if (slot == nT) return t;
  const bool row =
      2 * slot < nT || (2 * slot == nT && t < nT / 2);
  const int k = row ? slot : nT - slot;
  const int I = row ? t : (t - k + nT) % nT;
  const int K = (nT - 1) / 2 + 1;
  return k < K ? k * nT + I : nT * K + I;
}

// out (n, 3) = the sum of each atom's nT + 1 slots in slot order, negated
// when NEG: no float atomics, the same bits whatever order the CTAs ran in.
// With NC = 6, components 3-5 go to out2 (n, 3).  Where `kept` is not
// null, the slots of the tile pairs whose kept[block] is 0 are left out
// (their CTAs wrote nothing; leaving out a zero gives the same bits, as
// the sum never holds -0): the first warp lists the tile's kept slots in
// slot order in shared memory ((nT + 1) ints of dynamic shared memory),
// and every thread sums those.  Grid (nT, NC).
template <typename T, int BT, bool NEG, int NC = 3>
__global__ void slot_sum_kernel(const T* __restrict__ part, int n, int nT,
                                T* __restrict__ out, T* __restrict__ out2,
                                const unsigned char* __restrict__ kept) {
  extern __shared__ int slots[];
  __shared__ int nslots;
  const int tile = blockIdx.x, comp = blockIdx.y;
  if (kept != nullptr) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int cnt = 0;
      for (int s0 = 0; s0 <= nT; s0 += 32) {
        const int slot = s0 + lane;
        const bool keep = slot <= nT && kept[slot_block(tile, slot, nT)];
        const unsigned b = __ballot_sync(FULL, keep);
        if (keep) slots[cnt + __popc(b & ((1u << lane) - 1u))] = slot;
        cnt += __popc(b);
      }
      if (lane == 0) nslots = cnt;
    }
    __syncthreads();
  }
  const int i = tile * BT + threadIdx.x;
  if (i >= n) return;
  const T* p = part + ((size_t)tile * (nT + 1) * NC + comp) * BT + threadIdx.x;
  T s = T(0);
  if (kept == nullptr) {
#pragma unroll 8
    for (int slot = 0; slot <= nT; ++slot) s += p[(size_t)slot * NC * BT];
  } else {
    const int m = nslots;
#pragma unroll 8
    for (int j = 0; j < m; ++j) s += p[(size_t)slots[j] * NC * BT];
  }
  T* dst = comp < 3 ? out : out2;
  dst[3 * i + comp % 3] = NEG ? -s : s;
}

}  // namespace lidp
