// Shared pieces of the O(N^2) panel kernels (eind, pair_wolf, dipole).
//
// Tiling (the classic N-body shape, replacing the TPU's sequential
// (row-block, column-block) grid): one CTA owns ROWS rows; LANES adjacent
// threads share a row and stride the columns of a TILE-wide column tile
// staged in shared memory; the CTA itself loops over all column tiles, so
// per-row sums stay in registers and are written once, with no atomics.
// Per-CTA scalar partials go to a (gridDim.x, 8) buffer that a second,
// one-block stage sums in block order: results never depend on the order in
// which CTAs run.
#pragma once

#include <cuda_runtime.h>

namespace lidp {

constexpr int ROWS = 32;               // rows per CTA
constexpr int LANES = 8;               // threads per row
constexpr int THREADS = ROWS * LANES;  // 256
constexpr int TILE = THREADS;          // columns per shared-memory tile
constexpr int NACC = 8;                // scalar partials per CTA
constexpr unsigned FULL = 0xffffffffu;

// minimum image d - L*round(d/L); rintf rounds half to even like jnp.round
__device__ __forceinline__ float mi(float d, float L, float Linv) {
  return d - L * rintf(d * Linv);
}

// sum over the LANES threads of one row; lane 0 of the row holds the total
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL, v, off, LANES);
  return v;
}

// CTA-wide sums of NACC per-thread scalars, in a fixed order, written to
// partials[blockIdx.x * NACC + k].  Every thread of the CTA must call it.
__device__ __forceinline__ void block_partials(const float (&v)[NACC],
                                               float* __restrict__ partials) {
  __shared__ float red[THREADS / 32][NACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
    partials[blockIdx.x * NACC + threadIdx.x] = s;
  }
}

// second stage: acc[k] = scale_k * sum_b partials[b, k], summed in block
// order in double; scale_0 = s0, scale_k = s1 for k > 0
__global__ void reduce_partials(const float* __restrict__ partials,
                                int nblocks, float s0, float s1,
                                float* __restrict__ acc) {
  const int k = threadIdx.x;
  if (k < NACC) {
    double s = 0.0;
    for (int b = 0; b < nblocks; ++b) s += partials[b * NACC + k];
    acc[k] = static_cast<float>((k == 0 ? s0 : s1) * s);
  }
}

inline int nblocks_for(int nrows) { return (nrows + ROWS - 1) / ROWS; }

}  // namespace lidp
