// pair_wolf_panel: dense LJ + coul/long pair forces fused with the unscaled
// Wolf static field E0, in float32 (the kernels are in pair_panel.cuh).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1386 pair_wolf_panel
// (_pair_wolf_kernel :1293).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The function needs the
// geometry and the cutoff test of each unordered pair with an unmasked atom
// on one side, and the LJ, coulomb and Wolf blocks only for the pairs inside
// their cutoffs (6.0 and 6.5 A: ~0.5% of the fluid's pairs); chip_smoke.py
// pair_bound_ms counts it on the 12,288-row case.  (The Pallas
// CostEstimate's 100 flops for every ordered pair of all 12,288 rows:
// 0.23 ms at 67 TFLOP/s.)  The whole-panel kernel therefore computes each
// unordered pair once for both atoms, drops the tile pairs whose
// coordinate boxes lie beyond the cutoff, and skips by warp vote the
// blocks where no pair of a vote is in range.
#include "pair_panel.cuh"

// the row strip (cols=, row0=)
extern "C" int lidp_pair_wolf_panel(
    const float* xr, const float* qr, const float* tr, const float* molr,
    const int* sp, int S, int nrows, int row0, const float* xc,
    const float* qc, const float* tc, const float* molc, const float* mc,
    int npad, const float* tabs, int t1, const float* L, float cut_coulsq,
    float qqrd2e, float g_ewald, float* f, float* e0, float* partials,
    float* acc, void* stream) {
  return lidp::launch_pair_strip<float, true, true>(
      xr, qr, tr, molr, sp, S, nrows, row0, xc, qc, tc, molc, mc, npad, tabs,
      t1, L, cut_coulsq, qqrd2e, g_ewald, f, e0, partials, acc, stream);
}

// the whole panel (cols is None); coul is 1
extern "C" int lidp_pair_wolf_panel_whole(
    const float* x, const float* q, const float* typ, const float* mol,
    const float* m, const int* sp, int S, int n, const float* tabs, int t1,
    const float* L, float cut_coulsq, float qqrd2e, float g_ewald, int coul,
    int skip, int cull, int nT, float* boxes, float* part, float* partials,
    unsigned char* kept, int* list, float* f, float* e0, float* acc,
    unsigned long long* stats, void* stream) {
  if (!coul || mol == nullptr || e0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return lidp::launch_pair_whole<float, true, true>(
      x, q, typ, mol, m, sp, S, n, tabs, t1, L, cut_coulsq, qqrd2e, g_ewald,
      skip, cull, nT, boxes, part, partials, kept, list, f, e0, acc, stats,
      stream);
}

// atoms per tile of the whole panel, which sizes its scratch: boxes (nT,
// 8), part (nT, nT + 1, 6, tile), partials (nT (nT + 1) / 2, 8), kept
// (nT (nT + 1) / 2 bytes) and list (nT (nT + 1) / 2 + 2 ints), nT =
// ceil(n / tile)
extern "C" int lidp_pair_wolf_panel_whole_tile() {
  return lidp::PairTile<float>::BT;
}
