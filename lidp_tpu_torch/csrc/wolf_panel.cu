// wolf_panel: the damped-shifted (Wolf) static field
//   E0_i = sum_j q_j (r^-2 - rc^-2) r^-1 d,   d = mi(x_i - x_j),
// over pairs with i != j, mask_j != 0, rsq <= cut_coulsq (note <=: the pair
// kernel's cutoffs are strict) and mol_i != mol_j or mol_i == 0, in
// float32.  Unscaled: the caller multiplies by sqrt(qqrd2e).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:993 wolf_panel
// (_wolf_kernel :965).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The function needs the
// geometry of each unordered pair with an unmasked atom on one side, in
// the tile pairs whose coordinate boxes lie within the cutoff, and the
// field only where it acts (r <= 6.5 A: ~0.5% of the fluid's pairs);
// chip_smoke.py wolf_bound_ms counts it on the 12,288-row case (the
// Pallas CostEstimate's 30 flops for every ordered pair: 0.068 ms at 67
// TFLOP/s), against 0.4 MB of operands.  So the whole panel (cols=None)
// is pair_panel.cuh's whole-panel kernel with FORCE false: each unordered
// pair once for both atoms (w q_j d on i, -w q_i d on j with one w, the
// rows' q read through the same array as the columns'), each side gated
// on its own (side i by mask_j and i being an atom, side j by mask_i: a
// masked atom, padding at the origin included, receives the field and
// gives none), tile pairs beyond the cutoff dropped before a CTA takes
// them, and the field skipped by warp vote where no pair of a vote lies
// within it; slots summed in slot order, no float atomics.  A row strip
// (cols=, row0=) keeps the row form below: shared-memory column tiles, 8
// lanes per row, row sums in registers, selects instead of branches.
// Both forms take rsq unfused (rsq_rn), so kernel and plain version put
// every pair on the same side of the cutoff.
#include "pair_panel.cuh"

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
      const float rsq0 = rsq_rn(dx, dy, dz);
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

// the row strip (cols=, row0=).  Rows: xr (nrows,3), molr (nrows).
// Columns: xc (npad,3), qc, molc, mc (mask) (npad).  L (3,) on the device;
// out (nrows,3).
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

// the whole panel (cols is None): x (n,3), q, mol, m (mask) (n), L (3,) on
// the device; boxes (nT, 8), part (nT, nT + 1, 3, tile), kept (nT (nT +
// 1) / 2 bytes) and list (nT (nT + 1) / 2 + 2 ints) scratch; e0 (n,3).
// skip = 0 turns the warp skip off, cull = 0 the tile-pair test; stats,
// when not null, gains (votes, votes skipped, tile pairs dropped).
extern "C" int lidp_wolf_panel_whole(
    const float* x, const float* q, const float* mol, const float* m, int n,
    const float* L, float cut_coulsq, int skip, int cull, int nT,
    float* boxes, float* part, unsigned char* kept, int* list, float* e0,
    unsigned long long* stats, void* stream) {
  return lidp::launch_pair_whole<float, false, true, false>(
      x, q, nullptr, mol, m, nullptr, 0, n, nullptr, 0, L, cut_coulsq, 0.f,
      0.f, skip, cull, nT, boxes, part, nullptr, kept, list, nullptr, e0,
      nullptr, stats, stream);
}

// atoms per tile of the whole panel, which sizes its scratch (nT =
// ceil(n / tile))
extern "C" int lidp_wolf_panel_whole_tile() {
  return lidp::WholeTile<float, false>::BT;
}
