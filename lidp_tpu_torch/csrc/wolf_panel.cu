// wolf_panel: the damped-shifted (Wolf) static field
//   E0_i = sum_j q_j (r^-2 - rc^-2) r^-1 d,   d = mi(x_i - x_j),
// over pairs with i != j, mask_j != 0, rsq <= cut_coulsq (note <=: the pair
// kernel's cutoffs are strict) and mol_i != mol_j or mol_i == 0, in
// float32.  Unscaled: the caller multiplies by sqrt(qqrd2e).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:993 wolf_panel
// (_wolf_kernel :965).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The function's least
// arithmetic, the geometry of each pair with an unmasked atom on one side
// and the field only where it acts (chip_smoke.py wolf_bound_ms), is 0.020
// ms on the 12,288-row case at the 67 TFLOP/s FP32 peak (the Pallas
// CostEstimate's 30 flops for every ordered pair: 0.068 ms), against 0.4
// MB of operands.  The design is the one of eind_panel.cuh: shared-memory
// column tiles, 8 lanes per row, row sums in registers, selects instead
// of branches.
#include "panel_common.cuh"

namespace lidp {

__global__ void __launch_bounds__(THREADS)
wolf_kernel(const float* __restrict__ xr, const float* __restrict__ molr,
            int nrows, int row0, const float* __restrict__ xc,
            const float* __restrict__ qc, const float* __restrict__ molc,
            const float* __restrict__ mc, int npad,
            const float* __restrict__ Lp, float cut_coulsq,
            float* __restrict__ out) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sq[TILE], smol[TILE];
  __shared__ float smask[TILE];
  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const int ic = i < nrows ? i : nrows - 1;
  const float Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const float Lix = 1.f / Lx, Liy = 1.f / Ly, Liz = 1.f / Lz;
  const float xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const float moli = molr[ic];
  const int gi = row0 + i;
  const float f_shift = -1.f / cut_coulsq;
  float ex = 0.f, ey = 0.f, ez = 0.f;

  for (int j0 = 0; j0 < npad; j0 += TILE) {
    const int nt = min(TILE, npad - j0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const int j = j0 + threadIdx.x;
      sx[threadIdx.x] = xc[3 * j];
      sy[threadIdx.x] = xc[3 * j + 1];
      sz[threadIdx.x] = xc[3 * j + 2];
      sq[threadIdx.x] = qc[j];
      smol[threadIdx.x] = molc[j];
      smask[threadIdx.x] = mc[j];
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const float dx = mi(xi - sx[t], Lx, Lix);
      const float dy = mi(yi - sy[t], Ly, Liy);
      const float dz = mi(zi - sz[t], Lz, Liz);
      const float molj = smol[t];
      const float rsq0 = dx * dx + dy * dy + dz * dz;
      const bool inc = (gi != j0 + t) && (smask[t] != 0.f) &&
                       (rsq0 <= cut_coulsq) &&
                       ((moli != molj) || (moli == 0.f));
      const float rsq = inc ? rsq0 : 1.f;
      const float rinv = rsqrtf(rsq);
      const float r2inv = rinv * rinv;
      const float efq = (inc ? (r2inv + f_shift) * rinv : 0.f) * sq[t];
      ex += efq * dx;
      ey += efq * dy;
      ez += efq * dz;
    }
  }
  ex = row_sum(ex);
  ey = row_sum(ey);
  ez = row_sum(ez);
  if (i < nrows && lane == 0) {
    out[3 * i] = ex;
    out[3 * i + 1] = ey;
    out[3 * i + 2] = ez;
  }
}

}  // namespace lidp

// Rows: xr (nrows,3), molr (nrows).  Columns: xc (npad,3), qc, molc, mc
// (mask) (npad).  L (3,) on the device; out (nrows,3).
extern "C" int lidp_wolf_panel(const float* xr, const float* molr, int nrows,
                               int row0, const float* xc, const float* qc,
                               const float* molc, const float* mc, int npad,
                               const float* L, float cut_coulsq, float* out,
                               void* stream) {
  const dim3 grid(lidp::nblocks_for(nrows)), block(lidp::THREADS);
  lidp::wolf_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, molr, nrows, row0, xc, qc, molc, mc, npad, L, cut_coulsq, out);
  return static_cast<int>(cudaGetLastError());
}
