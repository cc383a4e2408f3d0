// pair_panel: dense LJ (+ coul/long) pair forces without the Wolf field, in
// float32 (the kernels are in pair_panel.cuh); coul == 0 compiles the erfc
// block out and leaves LJ only.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1458 pair_panel
// (_pair_kernel :1200).
//
// Bound on the H100: FP32 CUDA-core arithmetic, pair_wolf_panel.cu's count
// without the field (chip_smoke.py pair_bound_ms; the Pallas CostEstimate's
// 70 flops for every ordered pair: 0.16 ms at 12,288 x 12,288), against
// under 1 MB of operands.  The same whole-panel kernel as pair_wolf_panel,
// instantiated without the field.
#include "pair_panel.cuh"

// the row strip (cols=, row0=)
extern "C" int lidp_pair_panel(
    const float* xr, const float* qr, const float* tr, const int* sp, int S,
    int nrows, int row0, const float* xc, const float* qc, const float* tc,
    const float* mc, int npad, const float* tabs, int t1, const float* L,
    float cut_coulsq, float qqrd2e, float g_ewald, int coul, float* f,
    float* partials, float* acc, void* stream) {
  if (coul)
    return lidp::launch_pair_strip<float, true, false>(
        xr, qr, tr, nullptr, sp, S, nrows, row0, xc, qc, tc, nullptr, mc,
        npad, tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, nullptr, partials,
        acc, stream);
  return lidp::launch_pair_strip<float, false, false>(
      xr, qr, tr, nullptr, sp, S, nrows, row0, xc, qc, tc, nullptr, mc, npad,
      tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, nullptr, partials, acc,
      stream);
}

// the whole panel (cols is None); mol and e0 are null
extern "C" int lidp_pair_panel_whole(
    const float* x, const float* q, const float* typ, const float* mol,
    const float* m, const int* sp, int S, int n, const float* tabs, int t1,
    const float* L, float cut_coulsq, float qqrd2e, float g_ewald, int coul,
    int skip, int cull, int nT, float* boxes, float* part, float* partials,
    unsigned char* kept, int* list, float* f, float* e0, float* acc,
    unsigned long long* stats, void* stream) {
  if (mol != nullptr || e0 != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (coul)
    return lidp::launch_pair_whole<float, true, false>(
        x, q, typ, nullptr, m, sp, S, n, tabs, t1, L, cut_coulsq, qqrd2e,
        g_ewald, skip, cull, nT, boxes, part, partials, kept, list, f,
        nullptr, acc, stats, stream);
  return lidp::launch_pair_whole<float, false, false>(
      x, q, typ, nullptr, m, sp, S, n, tabs, t1, L, cut_coulsq, qqrd2e,
      g_ewald, skip, cull, nT, boxes, part, partials, kept, list, f, nullptr,
      acc, stats, stream);
}

// atoms per tile of the whole panel, which sizes its scratch: boxes (nT,
// 8), part (nT, nT + 1, 3, tile), partials (nT (nT + 1) / 2, 8), kept
// (nT (nT + 1) / 2 bytes) and list (nT (nT + 1) / 2 + 2 ints), nT =
// ceil(n / tile)
extern "C" int lidp_pair_panel_whole_tile() {
  return lidp::PairTile<float>::BT;
}
